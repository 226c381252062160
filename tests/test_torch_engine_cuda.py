"""The serving engine on the card (marked ``cuda``: skipped where
``torch.cuda.is_available()`` is false): phase 14's gates at a small
width.

Small seeded nets on the card and on the CPU with the same parameters,
f32 with TF32 off: a 4-16-3 MLP and a GravesLSTM char-RNN (vocab 8,
hidden 64, the kernel's narrowest width) behind ``ParallelInference``
with the default devices (every CUDA device): every caller's rows
within 1e-5 of the CPU net's output of its rows, no first dispatch after
the warmup (4 callers of up to 8 rows each against batches of 32: no
coalesced batch outgrows the warmed buckets), ``lstm_fwd_only``
launched by the char-RNN's batched output; a tiny ``gpt`` (vocab 11,
d_model 16, 2 layers, 2 heads, max_len 64) behind ``continuous=True``
with the prefix cache off and on: 8 requests of one 16-token system
prompt and an own tail, the first alone, the rest at once, one
streaming: the same tokens both ways and as
``generate_eager`` on the card, at least 7 hits, fewer prefill tokens,
a streamed row equal to its future's, the pool drained and free once
the cache is cleared, ``flash_fwd`` launched; and 4 concurrent requests
of one bucket on the coalesced path after ``warmup_generate``: at most
2 batches, no first dispatch, each request its solo ``generate``'s
tokens; a continuous engine refuses replicas off its net's device. The
full-width path runs in ``chip_smoke.py`` phase 14.
"""

import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import kernels, monitor
from deeplearning4j_tpu_torch.models.zoo.transformer import gpt
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.generate import generate, generate_eager
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import ParallelInference
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

TOL = 1e-5
SIZE = dict(vocab_size=11, d_model=16, n_layers=2, num_heads=2, max_len=64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _twins(make, device):
    """The CPU net and the card's, with the CPU net's parameters."""
    cpu = make("cpu").init()
    dev = make(device)
    params_from_numpy(dev, {layer: {n: t.numpy() for n, t in p.items()}
                            for layer, p in cpu.params.items()})
    return cpu, dev


def _mlp(device):
    conf = (NeuralNetConfiguration.builder().seed(7).activation("tanh")
            .list().layer(L.DenseLayer(n_in=4, n_out=16))
            .layer(L.OutputLayer(n_in=16, n_out=3, activation="softmax",
                                 loss_function="mcxent")).build())
    return MultiLayerNetwork(conf, device=device)


def _char(device):
    conf = (NeuralNetConfiguration.builder().seed(5).list()
            .layer(L.GravesLSTM(n_in=8, n_out=64, activation="tanh"))
            .layer(L.RnnOutputLayer(n_in=64, n_out=8, activation="softmax",
                                    loss_function="mcxent")).build())
    return MultiLayerNetwork(conf, device=device)


def _gpt(device):
    return gpt(compute_dtype="float32", seed=3, device=device, **SIZE)


def _together(calls):
    """Each call on its own thread, released together; their results."""
    out = [None] * len(calls)
    gate = threading.Barrier(len(calls))

    def run(i):
        gate.wait()
        out[i] = calls[i]()

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(calls))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return out


@pytest.mark.cuda
def test_classify_on_the_card_matches_the_cpu(cuda_device):
    cpu, dev = _twins(_mlp, cuda_device)
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((int(n), 4)).astype(np.float32)
          for n in rng.integers(1, 9, 16)]
    eng = ParallelInference(dev, max_batch_size=32)
    assert eng.stats()["replicas"] == torch.cuda.device_count()
    try:
        eng.warmup([(4,)])
        miss = monitor.get_registry().family_total(
            monitor.JIT_CACHE_MISS_COUNTER)
        # four callers, each with one request in flight at a time
        got = sum(_together([
            lambda k=k: [eng.output(x, timeout=60) for x in xs[k::4]]
            for k in range(4)]), [])
        assert monitor.get_registry().family_total(
            monitor.JIT_CACHE_MISS_COUNTER) == miss
    finally:
        eng.shutdown()
    for x, r in zip(sum((xs[k::4] for k in range(4)), []), got):
        np.testing.assert_allclose(r, cpu.output(x), rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_char_rnn_output_launches_lstm_fwd_only(cuda_device):
    cpu, dev = _twins(_char, cuda_device)
    rng = np.random.default_rng(1)
    xs = [np.eye(8, dtype=np.float32)[rng.integers(0, 8, (int(n), 12))]
          for n in rng.integers(1, 5, 6)]
    eng = ParallelInference(dev, max_batch_size=8)
    try:
        kernels.reset_launches()
        got = [f.result(60) for f in [eng.submit(x) for x in xs]]
        assert kernels.LAUNCHES.get("lstm_fwd_only", 0) > 0
    finally:
        eng.shutdown()
    for x, r in zip(xs, got):
        np.testing.assert_allclose(r, cpu.output(x), rtol=TOL, atol=TOL)


def _serve(net, prompts, prefix_cache):
    eng = ParallelInference(net, continuous=True, decode_slots=4,
                            decode_burst=4, kv_block_size=4,
                            prefix_cache=prefix_cache)
    chunks = []
    try:
        kernels.reset_launches()
        out = [eng.generate(prompts[0], 8, timeout=120)]
        futs = [eng.submit_generate(
            p, 8, on_tokens=(lambda o, t: chunks.append((o, t.tolist())))
            if i == 1 else None) for i, p in enumerate(prompts[1:], 1)]
        out += [f.result(120) for f in futs]
        launches = dict(kernels.LAUNCHES)
        assert eng.drain(60)
        sched = eng._scheduler
        st = sched.stats()
        cached = sum(c.cached_blocks() for c in sched.prefix_caches())
        assert st["pool"]["blocks_free"] + cached == st["pool"]["blocks_total"]
        for c in sched.prefix_caches():
            c.clear()
        pool = sched.stats()["pool"]
        assert pool["blocks_free"] == pool["blocks_total"]
    finally:
        eng.shutdown()
    toks = []
    for off, t in chunks:
        assert off == len(toks)
        toks.extend(t)
    assert toks == out[1][0, prompts[1].shape[1]:].tolist()
    return out, st, launches


@pytest.mark.cuda
def test_continuous_prefix_cache_on_the_card(cuda_device):
    _, dev = _twins(_gpt, cuda_device)
    rng = np.random.default_rng(2)
    system = rng.integers(0, 11, (1, 16))
    prompts = [np.concatenate([system, rng.integers(0, 11, (1, int(t)))],
                              axis=1) for t in rng.integers(2, 9, 8)]
    cold, st0, l0 = _serve(dev, prompts, False)
    warm, st1, l1 = _serve(dev, prompts, True)
    assert l0.get("flash_fwd", 0) > 0 and l1.get("flash_fwd", 0) > 0
    for p, a, b in zip(prompts, cold, warm):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(a, generate_eager(dev, p, 8))
    pc = st1["prefix_cache"]
    assert pc["hits"] >= len(prompts) - 1 and pc["saved_prefill_tokens"] > 0
    assert st1["prefill_tokens_computed"] < st0["prefill_tokens_computed"]


@pytest.mark.cuda
def test_coalesced_generate_on_the_card(cuda_device):
    _, dev = _twins(_gpt, cuda_device)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 11, (1, int(t))) for t in (9, 12, 14, 16)]
    eng = ParallelInference(dev, max_batch_size=4, max_latency_ms=200.0)
    try:
        assert eng.warmup_generate([p.shape[1] for p in prompts], 8) > 0
        reg = monitor.get_registry()
        miss = reg.family_total(monitor.JIT_CACHE_MISS_COUNTER)
        kernels.reset_launches()
        got = _together([lambda p=p: eng.generate(p, 8, timeout=120)
                         for p in prompts])
        assert kernels.LAUNCHES.get("flash_fwd", 0) > 0
        assert reg.family_total(monitor.JIT_CACHE_MISS_COUNTER) == miss
        assert eng.stats()["batches"] <= 2
    finally:
        eng.shutdown()
    for p, g in zip(prompts, got):
        np.testing.assert_array_equal(g, generate(dev, p, 8))


@pytest.mark.cuda
def test_continuous_engine_decodes_on_the_nets_device(cuda_device):
    """continuous=True decodes on the first replica's device, which must
    be the net's: a CPU net with card replicas is refused."""
    cpu = _gpt("cpu").init()
    with pytest.raises(ValueError, match="must be the net's"):
        ParallelInference(cpu, devices=[cuda_device], continuous=True)
    eng = ParallelInference(cpu, devices=[cuda_device])  # classify only
    eng.shutdown()
