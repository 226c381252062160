"""The port's continuous decode scheduler against the JAX package's and
against its own ``generate_eager``.

A tiny JAX ``gpt`` (vocab 11, d_model 16, 2 layers, 2 heads, max_len
32, f32; one per module) carries its parameters into the port's net.
Both schedulers are driven by ``step()`` (``start=False``) with 4
slots, bursts of 4 and blocks of 4 tokens: staggered admission, EOS,
preemption and resume, and int8 KV pools give each request the tokens
of the port's ``generate_eager`` and of the reference scheduler, and
the preemption order's ``events`` equal the reference's string for
string. Typed failures (an exhausted pool, a full queue, a recurrent
net, a killed burst), sampled draws unchanged by co-tenants, prefix
resumes, ``warmup``, the thread, ``on_tokens`` streaming (the chunks
are the reference's, across preemptions and resumes, and a burst sink
gets one call per burst), the engine's ``on_resolve`` seam, the tiers
``warmup`` covers, and the knobs left for later
slices (each raising ``NotImplementedError`` that names its ROADMAP
item). Every test ends with the pool fully free. The card cases are in
``tests/test_torch_serve_cuda.py``.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo.transformer import gpt as jax_gpt
from deeplearning4j_tpu.serving import continuous as jcont
from deeplearning4j_tpu_torch.models.zoo.transformer import gpt
from deeplearning4j_tpu_torch.nn.generate import generate_eager
from deeplearning4j_tpu_torch.parallel.inference import (
    EngineShutdown,
    InferenceBackpressure,
)
from deeplearning4j_tpu_torch.serving.continuous import (
    ContinuousDecodeScheduler,
    DecodeBurstError,
    KVPoolExhausted,
)
from deeplearning4j_tpu_torch.util.device import same_device
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

VOCAB = 11
SIZE = dict(vocab_size=VOCAB, d_model=16, n_layers=2, num_heads=2, max_len=32)


def _port(jn, device="cpu"):
    tn = gpt(compute_dtype="float32", seed=0, device=device, **SIZE)
    params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
    return tn


@pytest.fixture(scope="module")
def nets():
    jn = jax_gpt(compute_dtype="float32", seed=0, **SIZE).init()
    return jn, _port(jn)


KNOBS = dict(slots=4, burst_tokens=4, block_size=4, start=False)


def _drive(sched, futures, max_steps=200):
    for _ in range(max_steps):
        if all(f.done() for f in futures):
            return
        sched.step()
    raise AssertionError(f"schedule did not converge in {max_steps} steps; "
                         f"events={list(sched.events)}")


def _free(sched):
    pool = sched.stats()["pool"]
    return pool["blocks_free"] == pool["blocks_total"]


def _both(nets, plan, **kw):
    """Run ``plan(scheduler) -> futures`` on the reference's scheduler
    and on the port's; returns ((reference, results), (port, results))
    with every future resolved and both pools checked fully free."""
    jn, tn = nets
    out = []
    for cls, net in ((jcont.ContinuousDecodeScheduler, jn),
                     (ContinuousDecodeScheduler, tn)):
        s = cls(net=net, **dict(KNOBS, **kw))
        futs = plan(s)
        _drive(s, futs)
        assert _free(s)
        out.append((s, [f.result(0) for f in futs]))
    return out


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (1, t)) for t in lengths]


def test_staggered_admission_matches_eager_and_reference(nets):
    """A request admitted while slots are already decoding gets its
    solo eager tokens, and the reference scheduler's."""
    rng = np.random.default_rng(0)
    p1, p2 = rng.integers(0, VOCAB, (2, 5)), rng.integers(0, VOCAB, (1, 3))

    def plan(s):
        f1 = s.submit(p1, 10)
        s.step()
        assert s.stats()["active_sequences"] == 2
        return [f1, s.submit(p2, 6)]

    (_, want), (s, got) = _both(nets, plan)
    tn = nets[1]
    for w, g, (p, n) in zip(want, got, ((p1, 10), (p2, 6))):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, generate_eager(tn, p, n))
    st = s.stats()
    assert st["admitted_rows"] == st["retired_rows"] == 3
    assert st["accepted"] == st["resolved"] == 2 and st["bursts"] > 0
    assert st["attribution"]["models"]["default"]["decode_tokens"] == 2 * 9 + 5
    assert len(s.completed) == 2


def test_eos_retires_between_bursts_and_fills(nets):
    prompt = np.random.default_rng(1).integers(0, VOCAB, (2, 4))
    (_, want), (_, got) = _both(
        nets, lambda s: [s.submit(prompt, 12, eos_token=3)])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(
        got[0], generate_eager(nets[1], prompt, 12, eos_token=3))


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_preempt_resume_matches_eager_and_reference(nets, kv_quant):
    """8 usable blocks of 4 tokens cannot hold three sequences growing
    to 15 tokens: the schedule preempts, and every request still gets
    its uninterrupted tokens, and the reference scheduler's."""
    prompts = _prompts(2, (5, 5, 5))
    (js, want), (s, got) = _both(
        nets, lambda s: [s.submit(p, 10) for p in prompts],
        num_blocks=9, kv_quant=kv_quant)
    for w, g, p in zip(want, got, prompts):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, generate_eager(nets[1], p, 10))
    assert s.stats()["preemptions"] == js.stats()["preemptions"] > 0
    assert s.stats()["kv_quant"] == kv_quant
    assert list(s.events) == list(js.events)


def test_deterministic_preemption_order(nets):
    """Lowest priority first, the youngest admission breaking ties: the
    port's events equal the reference's string for string, and a replay
    gives the same events and tokens."""
    prompts = _prompts(3, (5, 5, 5))

    def plan(s):
        return [s.submit(p, 10, priority=pr)
                for p, pr in zip(prompts, (5, 1, 1))]

    (js, want), (s, got) = _both(nets, plan, num_blocks=9)
    preempts = [e for e in s.events if e.startswith("preempt")]
    assert preempts and preempts[0].startswith("preempt seq=3 prio=1")
    assert not any("seq=1 " in e for e in preempts)
    assert list(s.events) == list(js.events)
    s2 = ContinuousDecodeScheduler(net=nets[1], num_blocks=9, **KNOBS)
    futs = plan(s2)
    _drive(s2, futs)
    assert list(s2.events) == list(s.events)
    for f, g, w in zip(futs, got, want):
        np.testing.assert_array_equal(f.result(0), g)
        np.testing.assert_array_equal(g, w)


def test_quantized_pool_preempt_resume_invariant(nets):
    """On an int8 pool a resume's re-prefill stores the bytes the
    decode wrote: a preempted sampled run's tokens equal an unpreempted
    one's."""
    tn = nets[1]
    prompts = _prompts(4, (3, 5, 7))
    runs = []
    for blocks in (None, 9):
        s = ContinuousDecodeScheduler(net=tn, num_blocks=blocks,
                                      kv_quant="int8", **KNOBS)
        futs = [s.submit(p, 10, temperature=1.1, seed=i)
                for i, p in enumerate(prompts)]
        _drive(s, futs)
        assert _free(s)
        runs.append((s.stats()["preemptions"], [f.result(0) for f in futs]))
    assert runs[0][0] == 0 and runs[1][0] >= 1
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_array_equal(a, b)


def test_kv_bytes_budget_buys_more_quantized_blocks(nets):
    tn = nets[1]
    budget = 24 * 2 * 2 * 4 * 2 * 8 * 4   # 24 f32 blocks
    sizes = {}
    for quant in (None, "int8"):
        s = ContinuousDecodeScheduler(net=tn, kv_quant=quant,
                                      kv_bytes_budget=budget, **KNOBS)
        f = s.submit(np.ones((1, 4), np.int64), 2)
        _drive(s, [f])
        assert _free(s)
        sizes[quant] = s.stats()["pool"]["blocks_total"]
    assert sizes[None] == 24 and sizes["int8"] >= 2 * sizes[None]
    with pytest.raises(ValueError, match="exclusive"):
        ContinuousDecodeScheduler(net=tn, num_blocks=9, kv_bytes_budget=1,
                                  **KNOBS)
    with pytest.raises(ValueError, match="kv_quant"):
        ContinuousDecodeScheduler(net=tn, kv_quant="int4", **KNOBS)


def test_pool_exhausted_fails_typed(nets):
    """A sequence that cannot fit even alone fails fast and typed."""
    s = ContinuousDecodeScheduler(net=nets[1], num_blocks=3, **KNOBS)
    f = s.submit(np.ones((1, 10), np.int64), 8)
    for _ in range(5):
        if f.done():
            break
        s.step()
    with pytest.raises(KVPoolExhausted):
        f.result(0)
    assert _free(s)
    # one that fits at admission but outgrows the pool fails at growth
    f = s.submit(np.ones((1, 6), np.int64), 8)
    _drive(s, [f])
    with pytest.raises(KVPoolExhausted):
        f.result(0)
    assert _free(s) and any(e.startswith("fail seq=2") for e in s.events)


def test_queue_full_sheds(nets):
    s = ContinuousDecodeScheduler(net=nets[1], queue_capacity=2, **KNOBS)
    f = s.submit(np.ones((2, 4), np.int64), 4)
    with pytest.raises(InferenceBackpressure):
        s.submit(np.ones((1, 4), np.int64), 4)
    assert s.drain(30) and f.done() and _free(s)
    with pytest.raises(ValueError):
        s.submit(np.ones(4, np.int64), 4)
    with pytest.raises(ValueError):
        s.submit(np.ones((1, 30), np.int64), 4)   # past max_len
    s.shutdown()
    with pytest.raises(EngineShutdown):
        s.submit(np.ones((1, 4), np.int64), 4)


def test_recurrent_net_rejected():
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import (GravesLSTM,
                                                         RnnOutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder()
            .seed(1).learning_rate(0.01).updater("adam").activation("tanh")
            .list()
            .layer(GravesLSTM(n_in=7, n_out=8))
            .layer(RnnOutputLayer(n_in=8, n_out=7, activation="softmax",
                                  loss_function="mcxent"))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    with pytest.raises(ValueError, match="continuous batching"):
        ContinuousDecodeScheduler(net=net, start=False)


def test_sampled_draws_invariant_to_cotenants(nets):
    """A sampled request's draws ride its own token clock: alone or
    crowded, the same seed gives the same tokens, and the tokens of a
    solo sampled ``generate_eager``."""
    tn = nets[1]
    p = np.random.default_rng(5).integers(0, VOCAB, (1, 4))
    s1 = ContinuousDecodeScheduler(net=tn, **KNOBS)
    alone = s1.submit(p, 8, temperature=0.8, top_k=5, seed=7)
    _drive(s1, [alone])
    s2 = ContinuousDecodeScheduler(net=tn, **KNOBS)
    crowd = [s2.submit(q, 10, seed=i, temperature=0.5 * i)
             for i, q in enumerate(_prompts(6, (6, 6)))]
    crowded = s2.submit(p, 8, temperature=0.8, top_k=5, seed=7)
    _drive(s2, crowd + [crowded])
    np.testing.assert_array_equal(alone.result(0), crowded.result(0))
    np.testing.assert_array_equal(
        alone.result(0),
        generate_eager(tn, p, 8, temperature=0.8, top_k=5, seed=7))
    assert _free(s1) and _free(s2)


def test_killed_burst_fails_typed_and_frees_the_pool(nets):
    """A burst dying under live rows fails their request typed (the
    hook's error as the cause), frees every block, and the scheduler
    serves the next request."""
    tn = nets[1]

    class Kill(RuntimeError):
        pass

    hits = []

    def hook(lane_key, burst):
        if burst == 1 and not hits:
            hits.append(lane_key)
            raise Kill("injected")

    s = ContinuousDecodeScheduler(net=tn, burst_hook=hook, **KNOBS)
    f1 = s.submit(np.random.default_rng(7).integers(0, VOCAB, (2, 5)), 10)
    _drive(s, [f1])
    with pytest.raises(DecodeBurstError) as ei:
        f1.result(0)
    assert isinstance(ei.value.__cause__, Kill) and hits == [(None, None)]
    assert _free(s)
    assert any(e.startswith("burst_failed") for e in s.events)
    p2 = np.random.default_rng(8).integers(0, VOCAB, (1, 4))
    f2 = s.submit(p2, 6)
    _drive(s, [f2])
    np.testing.assert_array_equal(f2.result(0), generate_eager(tn, p2, 6))
    assert _free(s)


@pytest.mark.parametrize("sampler", [{}, {"temperature": 0.8, "top_k": 5,
                                          "seed": 7}])
def test_prefix_resume_matches_eager(nets, sampler):
    """A stream interrupted after k tokens resumes from prompt + prefix:
    its output equals an uninterrupted run's, and it is admitted once,
    prefilled at t0 + k."""
    tn = nets[1]
    p = np.random.default_rng(9).integers(0, VOCAB, (1, 5))
    want = generate_eager(tn, p, 10, **sampler)
    s = ContinuousDecodeScheduler(net=tn, **KNOBS)
    f = s.submit(p, 10, prefix=want[0, 5:9], **sampler)
    _drive(s, [f])
    np.testing.assert_array_equal(f.result(0), want)
    admits = [e for e in s.events if e.startswith("admit")]
    assert len(admits) == 1 and " t=9 " in admits[0], admits
    assert s.stats()["resume_reprefill_tokens"] == 9 and _free(s)
    done = s.submit(p, 6, prefix=want[0, 5:11])   # every token already there
    assert done.done()
    np.testing.assert_array_equal(done.result(0), want[:, :11])
    assert s.stats()["admitted_rows"] == 1 and s.drain(1)
    with pytest.raises(ValueError, match="per-stream"):
        s.submit(np.ones((2, 5), np.int64), 4, prefix=np.asarray([1]))


@pytest.mark.parametrize("kw, item", [
    (dict(registry=object()), "A10b"), (dict(speculative=True), "A10b"),
    (dict(draft_net=object()), "A10b"), (dict(host_kv_blocks=8), "A10b")])
def test_later_scheduler_knobs_raise(nets, kw, item):
    with pytest.raises(NotImplementedError, match=item):
        ContinuousDecodeScheduler(net=nets[1], **dict(KNOBS, **kw))


@pytest.mark.parametrize("kw, item", [
    (dict(model="lm"), "A10b"), (dict(version=2), "A10b"),
    (dict(session="s"), "A10b"), (dict(hibernate=True), "A10b"),
    (dict(kv_state={}), "A11")])
def test_later_submit_knobs_raise(nets, kw, item):
    s = ContinuousDecodeScheduler(net=nets[1], **KNOBS)
    with pytest.raises(NotImplementedError, match=item):
        s.submit(np.ones((1, 4), np.int64), 4, **kw)
    assert s.stats()["accepted"] == 0


def test_warmup_runs_masked(nets):
    """warmup runs every program once, all masked: the pool's accounting
    is untouched and a later request still gets its eager tokens."""
    tn = nets[1]
    s = ContinuousDecodeScheduler(net=tn, **KNOBS)
    built = s.warmup([2, 4, 8], 8)
    assert built > 0 and s.stats()["warmed"] and _free(s)
    assert s.stats()["bursts"] == 0
    assert s.warmup([2, 4, 8], 8) == 0      # nothing new to build
    p = np.random.default_rng(10).integers(0, VOCAB, (1, 4))
    f = s.submit(p, 6, temperature=0.5, seed=3)
    _drive(s, [f])
    np.testing.assert_array_equal(
        f.result(0), generate_eager(tn, p, 6, temperature=0.5, seed=3))
    with pytest.raises(NotImplementedError, match="A10b"):
        s.warmup([4], model="lm")


def test_thread_serves_and_shuts_down(nets):
    tn = nets[1]
    s = ContinuousDecodeScheduler(net=tn, slots=4, burst_tokens=4,
                                  block_size=4)
    prompts = _prompts(11, (3, 6))
    futs = [s.submit(p, 7) for p in prompts]
    for f, p in zip(futs, prompts):
        np.testing.assert_array_equal(f.result(60), generate_eager(tn, p, 7))
    s.shutdown()
    assert _free(s)
    s2 = ContinuousDecodeScheduler(net=tn, **KNOBS)
    f = s2.submit(np.ones((1, 4), np.int64), 4)
    s2.shutdown(drain=False)
    with pytest.raises(EngineShutdown):
        f.result(0)


def test_concurrent_submitters_stress(nets):
    """More submitting threads than cores (two a core) against the
    scheduler's thread, with a short switch interval: every request
    resolves with its eager tokens, the counts agree, and the pool
    drains free."""
    import os
    import sys
    import threading

    tn = nets[1]
    s = ContinuousDecodeScheduler(net=tn, slots=4, burst_tokens=2,
                                  block_size=4, num_blocks=13)
    prompts = _prompts(13, [2 + i % 5 for i in range(5)])
    want = [generate_eager(tn, p, 5) for p in prompts]
    n = 2 * len(os.sched_getaffinity(0))
    futs = [None] * n

    def submit(i):
        futs[i] = s.submit(prompts[i % len(prompts)], 5, priority=i % 3)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(120),
                                          want[i % len(prompts)])
    finally:
        sys.setswitchinterval(saved)
        s.shutdown(timeout=60)
    st = s.stats()
    assert st["accepted"] == st["resolved"] == n
    assert st["admitted_rows"] - st["preemptions"] == st["retired_rows"] == n
    assert _free(s)


# ------------------------------------------ streaming and the engine seams

class _Collector:
    """An ``on_tokens`` consumer that records every chunk."""

    def __init__(self):
        self.chunks = []

    def __call__(self, off, toks):
        self.chunks.append((int(off),
                            [int(t) for t in np.asarray(toks).reshape(-1)]))

    def tokens(self, base=0):
        """The chunks' tokens, asserting contiguous offsets from
        ``base``."""
        toks = []
        for off, ts in self.chunks:
            assert off == base + len(toks), f"gap or repeat at {off}"
            toks.extend(ts)
        return toks


def test_stream_deltas_match_eager_and_reference(nets):
    """``on_tokens`` receives the admission's token and then each burst's,
    the same chunks as the reference scheduler's; concatenated they are
    the eager run's tokens; the chunk counter ticks once a chunk."""
    from deeplearning4j_tpu_torch import monitor

    tn = nets[1]
    p = np.random.default_rng(20).integers(0, VOCAB, (1, 5))
    want = generate_eager(tn, p, 10)
    colls = []

    def plan(s):
        colls.append(_Collector())
        return [s.submit(p, 10, on_tokens=colls[-1])]

    reg = monitor.MetricsRegistry()
    old = monitor.set_registry(reg)
    try:
        (_, jgot), (_, got) = _both(nets, plan)
    finally:
        monitor.set_registry(old)
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(jgot[0], want)
    assert colls[1].tokens() == want[0, 5:].tolist()
    assert colls[1].chunks == colls[0].chunks and len(colls[1].chunks) > 1
    assert reg.family_total(monitor.STREAM_CHUNKS_COUNTER) == \
        len(colls[1].chunks)


def test_stream_deltas_survive_preemption(nets):
    """A preempted and resumed stream keeps its cursor: nothing is
    delivered twice, and the chunks are the reference's."""
    tn = nets[1]
    prompts = _prompts(21, (5, 5, 5))
    colls = []

    def plan(s):
        cs = [_Collector() for _ in prompts]
        colls.append(cs)
        return [s.submit(p, 10, on_tokens=c) for p, c in zip(prompts, cs)]

    (js, _), (s, got) = _both(nets, plan, num_blocks=9)
    assert s.stats()["preemptions"] > 0
    for p, g, c, jc in zip(prompts, got, colls[1], colls[0]):
        want = generate_eager(tn, p, 10)
        np.testing.assert_array_equal(g, want)
        assert c.tokens() == want[0, 5:].tolist()
        assert c.chunks == jc.chunks


@pytest.mark.parametrize("sampler", [{}, {"temperature": 0.8, "top_k": 5,
                                          "seed": 7}])
def test_prefix_resume_streams_after_the_prefix(nets, sampler):
    tn = nets[1]
    p = np.random.default_rng(22).integers(0, VOCAB, (1, 5))
    want = generate_eager(tn, p, 10, **sampler)
    s = ContinuousDecodeScheduler(net=tn, **KNOBS)
    coll = _Collector()
    f = s.submit(p, 10, prefix=want[0, 5:9], on_tokens=coll, **sampler)
    _drive(s, [f])
    np.testing.assert_array_equal(f.result(0), want)
    assert coll.chunks[0][0] == 4
    assert coll.tokens(base=4) == want[0, 9:].tolist()
    assert _free(s)


def test_streaming_requires_single_row(nets):
    s = ContinuousDecodeScheduler(net=nets[1], **KNOBS)
    with pytest.raises(ValueError, match="per-stream"):
        s.submit(np.ones((2, 5), np.int64), 4, on_tokens=lambda o, t: 0)
    assert s.stats()["accepted"] == 0


def test_callback_errors_and_burst_sinks(nets):
    """A consumer that raises is marked and the scheduler serves on; the
    callbacks marked with a ``burst_sink`` get one sink call per burst
    with every stream's chunk, before any request of that burst
    resolves."""
    tn = nets[1]
    prompts = _prompts(23, (4, 6))
    calls = []

    def sink(entries):
        calls.append([(off, list(map(int, t))) for _, off, t in entries])

    cbs = []
    for _ in prompts:
        def cb(off, toks):
            raise AssertionError("a sink's callback is not called alone")
        cb.burst_sink = sink
        cbs.append(cb)

    def broken(off, toks):
        raise RuntimeError("consumer bug")

    s = ContinuousDecodeScheduler(net=tn, **KNOBS)
    futs = [s.submit(p, 7, on_tokens=cb) for p, cb in zip(prompts, cbs)]
    futs.append(s.submit(prompts[0], 7, on_tokens=broken))
    _drive(s, futs)
    for p, f in zip(prompts + prompts[:1], futs):
        np.testing.assert_array_equal(f.result(0), generate_eager(tn, p, 7))
    assert calls and all(len(c) == 2 for c in calls)
    per = [[], []]
    for c in calls:
        for i, (off, toks) in enumerate(c):
            assert off == len(per[i]) + 1  # the admission token went alone
            per[i].extend(toks)
    assert _free(s)


def test_engine_seam_on_resolve(nets):
    """``on_resolve`` hears of every resolved request: those a killed
    burst fails and those that finish; the engine's device check reads
    ``same_device``."""
    tn = nets[1]
    resolved, kills = [], [RuntimeError("killed")]

    def hook(lane_key, index):
        if index == 1 and kills:
            raise kills.pop()

    s = ContinuousDecodeScheduler(net=tn, on_resolve=resolved.append,
                                  burst_hook=hook, **KNOBS)
    futs = [s.submit(p, 9) for p in _prompts(24, (4, 4, 4))]
    _drive(s, futs)  # the second burst fails them
    assert sum(resolved) == 3
    for f in futs:
        with pytest.raises(DecodeBurstError):
            f.result(0)
    f = s.submit(np.ones((1, 4), np.int64), 3)
    _drive(s, [f])
    assert f.result(0).shape == (1, 7) and sum(resolved) == 4
    assert _free(s)
    assert not same_device(torch.device("cuda", 0), torch.device("cpu"))
    assert same_device(torch.device("cpu"), tn.device)


def test_warmup_covers_the_tiers_its_requests_reach(nets):
    """warmup builds the bursts of the block tiers that its prompt
    lengths and new tokens reach, no other: serving inside that set
    dispatches nothing new, a longer request does."""
    tn = nets[1]
    tn.__dict__.pop("_dispatch_sigs", None)
    s = ContinuousDecodeScheduler(net=tn, **KNOBS)
    s.warmup([5, 6], 3)  # 2 blocks of 4 up to 3 (tier 4)

    def tiers():
        return sorted({sig[4] for sig in tn.__dict__["_dispatch_sigs"]
                       if sig[0] == "gen_burst"})

    assert tiers() == [2, 4]
    seen = set(tn.__dict__["_dispatch_sigs"])
    futs = [s.submit(p, 3) for p in _prompts(26, (5, 6, 6))]
    _drive(s, futs)
    assert set(tn.__dict__["_dispatch_sigs"]) == seen
    for p, f in zip(_prompts(26, (5, 6, 6)), futs):
        np.testing.assert_array_equal(f.result(0), generate_eager(tn, p, 3))
    f = s.submit(_prompts(27, (6,))[0], 12)  # 18 tokens: 5 blocks, tier 8
    _drive(s, [f])
    assert tiers() == [2, 4, 8]
    assert _free(s)


def test_chunk_deliver_spans_on_the_request_trace(nets):
    from deeplearning4j_tpu_torch.monitor import reqtrace

    tn = nets[1]
    tracer = reqtrace.enable_request_tracing()
    try:
        s = ContinuousDecodeScheduler(net=tn, **KNOBS)
        coll = _Collector()
        f = s.submit(_prompts(25, (5,))[0], 8, on_tokens=coll)
        _drive(s, [f])
    finally:
        reqtrace.disable_request_tracing()
    (tr,) = tracer.completed_traces()
    spans = [sp for sp in tr["spans"] if sp["name"] == "chunk_deliver"]
    assert len(spans) == len(coll.chunks) > 1
