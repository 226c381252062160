"""Paged serving on the card against the CPU (marked ``cuda``: skipped
where ``torch.cuda.is_available()`` is false).

A tiny seeded ``gpt`` (vocab 11, d_model 16, 2 layers, 2 heads, max_len
32, f32, TF32 off) on both devices with the same parameters: the paged
``decode_step`` over the same pool contents (f32 and int8) within 1e-5,
a greedy ``burst_program`` with the same tokens, positions, counts and
done-mask, and a preempting ``ContinuousDecodeScheduler`` whose requests
equal an unpreempted schedule's (f32 and int8 pools) and, on f32 pools,
``generate_eager`` on the card. The full-width path runs in
``chip_smoke.py`` phase 11.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models.zoo.transformer import gpt
from deeplearning4j_tpu_torch.nn import generate as tgen
from deeplearning4j_tpu_torch.nn.generate import generate_eager
from deeplearning4j_tpu_torch.serving.continuous import ContinuousDecodeScheduler
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

SIZE = dict(vocab_size=11, d_model=16, n_layers=2, num_heads=2, max_len=32)
H, HD, BS, NB = 2, 8, 4, 10
TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


def _nets(device):
    cpu = gpt(compute_dtype="float32", seed=3, device="cpu", **SIZE).init()
    dev = gpt(compute_dtype="float32", seed=3, device=device, **SIZE)
    params_from_numpy(dev, {layer: {n: t.numpy() for n, t in p.items()}
                            for layer, p in cpu.params.items()})
    return cpu, dev


def _pool(rng, quant):
    if quant:
        p = {n: rng.integers(-127, 128, (NB, BS, H, HD)).astype(np.int8)
             for n in ("k", "v")}
        p.update({n: rng.random((NB, BS, H)).astype(np.float32) * 0.05
                  for n in ("k_scale", "v_scale")})
        return p
    return {n: rng.standard_normal((NB, BS, H, HD)).astype(np.float32)
            for n in ("k", "v")}


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_on_the_card_matches_cpu(cuda_device, quant):
    cpu, dev = _nets(cuda_device)
    blk = cpu.impls[1]
    rng = np.random.default_rng(6)
    pool = _pool(rng, quant)
    pools = {d: {n: torch.from_numpy(a.copy()).to(d) for n, a in pool.items()}
             for d in ("cpu", cuda_device)}
    table = np.array([[3, 1, 5], [2, 6, 4]])
    pos = np.array([0, 2])
    for step in range(8):
        x = rng.standard_normal((2, 16)).astype(np.float32)
        wm = np.array([True, step != 3])
        ys = {}
        for d, net in (("cpu", cpu), (cuda_device, dev)):
            def t(a):
                return torch.from_numpy(a).to(d)
            ys[d], _ = blk.decode_step(net.params[blk.name], t(x),
                                       dict(pools[d], table=t(table)),
                                       t(pos), write_mask=t(wm))
        np.testing.assert_allclose(ys[cuda_device].cpu().numpy(),
                                   ys["cpu"].numpy(), rtol=TOL, atol=TOL)
        pos += 1
    for n in pool:
        np.testing.assert_allclose(pools[cuda_device][n].cpu().float().numpy(),
                                   pools["cpu"][n].float().numpy(),
                                   rtol=TOL, atol=TOL if n.endswith("scale")
                                   or not quant else 1.0)


@pytest.mark.cuda
def test_greedy_burst_on_the_card_matches_cpu(cuda_device):
    cpu, dev = _nets(cuda_device)
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 11, (4, 8))
    lens = np.array([5, 8, 3, 1])
    tables = np.array([[7, 8, 1, 0], [5, 6, 2, 4], [3, 9, 0, 0],
                       [0, 0, 0, 0]])
    pool = [_pool(rng, False) for _ in range(2)]
    outs = {}
    for d, net in (("cpu", cpu), (cuda_device, dev)):
        g = tgen.build_generator(net)
        pc = net.cast_params(net.params)
        pools = [{n: torch.from_numpy(a.copy()).to(d) for n, a in p.items()}
                 for p in pool]
        caches, logits = g.prefill_program(8)(pc, ids, lens)
        pools = g.scatter_program(4, 8, BS)(pools, caches, tables[:, :2])
        tok = logits.argmax(-1).cpu().numpy()
        bp = g.burst_program(4, 6, 4, NB, BS, sampling=False)
        z = np.zeros(4)
        outs[d] = [tok] + [a.cpu().numpy() for a in bp(
            pc, pools, tables, lens, tok, np.array([1, 1, 1, 0]),
            np.array([False, False, False, True]), [0] * 4, z, z, z,
            np.array([-1, int(tok[1]), -1, -1]), np.array([7, 9, 4, 0]))[1:]]
    for got, want in zip(outs[cuda_device], outs["cpu"]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_scheduler_on_the_card_matches_eager(cuda_device, kv_quant):
    """A preempting schedule on the card: f32 pools give every request
    its ``generate_eager`` tokens there; an int8 pool (whose attention
    reads quantized K/V) gives the tokens of the same schedule on a pool
    large enough that nothing is preempted."""
    _, dev = _nets(cuda_device)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 11, (1, 5)) for _ in range(3)]
    runs = []
    for blocks in (9, None):
        s = ContinuousDecodeScheduler(net=dev, slots=4, burst_tokens=4,
                                      block_size=4, num_blocks=blocks,
                                      kv_quant=kv_quant, start=False)
        pool = s._lane_for(None, None).pool
        assert pool.layers[0]["k"].device.type == cuda_device.type
        futs = [s.submit(p, 10) for p in prompts]
        assert s.drain(120)
        st = s.stats()
        assert st["pool"]["blocks_free"] == st["pool"]["blocks_total"]
        runs.append((st["preemptions"], [f.result(0) for f in futs]))
    assert runs[0][0] > 0 and runs[1][0] == 0
    for got, unpreempted, p in zip(runs[0][1], runs[1][1], prompts):
        np.testing.assert_array_equal(got, unpreempted)
        if kv_quant is None:
            np.testing.assert_array_equal(got, generate_eager(dev, p, 10))
