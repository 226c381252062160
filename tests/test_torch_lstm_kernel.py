"""The port's LSTM scan kernels' plain versions against the JAX package's
Pallas kernels, run the way ``tests/test_lstm_kernel.py`` runs them on
the CPU (interpret mode), and the dispatch gates' truth table.

Inputs come from numpy seeds; b 16, t 9, n 32 and 128 (n * itemsize <=
1024 and b % 8 == 0, so ``jax.vjp`` of ``fused_lstm_scan`` reaches the
Pallas backward). Tolerances: f32 1e-5 forward and 1e-4 gradients (the
JAX test's own); bf16: both sides round h, the streams and dg at the
same points, so they agree to one bf16 rounding of the stream (2^-7
relative: rtol 1e-2) with f32 sums in another order; gradients summed
over t and b from such values get rtol 2e-2. The ``cuda`` cases hold
the kernels against the plain versions on the card (``chip_smoke.py``
phase 2b does the same at full width).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.ops.lstm_kernel as jlk
from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.ops import lstm_kernel as lk

B, T = 16, 9
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FWD_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
           "bfloat16": dict(rtol=1e-2, atol=1e-2)}
GRAD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
            "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _inputs(n, seed=0, b=B, t=T):
    """xg [t, b, 4n], Wr [n, 4n], three peepholes [n], h0 and c0 [b, n]
    (nonzero), f32 numpy."""
    rng = np.random.default_rng(seed)
    mk = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return (mk(t, b, 4 * n), mk(n, 4 * n, scale=n ** -0.5),
            mk(n, scale=0.2), mk(n, scale=0.2), mk(n, scale=0.2),
            mk(b, n, scale=0.5), mk(b, n, scale=0.5))


def _both(arrays, dtype):
    """The same arrays as JAX and torch values; xg, Wr and h0 in
    ``dtype``, the peepholes and c0 in f32."""
    jdt, tdt = DTYPES[dtype]
    low = (0, 1, 5)
    j = [jnp.asarray(a, jdt if k in low else jnp.float32)
         for k, a in enumerate(arrays)]
    t = [torch.tensor(a).to(tdt if k in low else torch.float32)
         for k, a in enumerate(arrays)]
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [32, 128])
def test_forward_only_matches_jax_kernel(dtype, n):
    j, t = _both(_inputs(n, seed=1), dtype)
    h_j, (hl_j, cl_j) = jlk._fwd_pallas(*j, block_b=8, interpret=True,
                                         with_residuals=False)
    h_t, (hl_t, cl_t) = lk.lstm_fwd_plain(*t, with_residuals=False)
    assert h_t.dtype == DTYPES[dtype][1] and cl_t.dtype == torch.float32
    for a, b in ((h_j, h_t), (hl_j, hl_t), (cl_j, cl_t)):
        np.testing.assert_allclose(_np(b), _np(a), **FWD_TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [32, 128])
def test_residual_forward_matches_jax_kernel(dtype, n):
    """All six streams: h, i, f, o, blk, c."""
    j, t = _both(_inputs(n, seed=2), dtype)
    h_j, res_j = jlk._fwd_pallas(*j, block_b=8, interpret=True)
    h_t, res_t = lk.lstm_fwd_plain(*t)
    for name, a, b in zip("h i f o blk c".split(), (h_j, *res_j), (h_t, *res_t)):
        assert b.dtype == DTYPES[dtype][1], name
        np.testing.assert_allclose(_np(b), _np(a), err_msg=name,
                                   **FWD_TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [32, 128])
def test_backward_matches_jax_kernel(dtype, n):
    """The plain BPTT against ``_bwd_pallas`` on the same residuals:
    dg, dWr, the three peephole gradients, dh0 and dc0."""
    j, t = _both(_inputs(n, seed=3), dtype)
    _, res_j = jlk._fwd_pallas(*j, block_b=8, interpret=True)
    rng = np.random.default_rng(4)
    gout = rng.standard_normal((T, B, n)).astype(np.float32)
    gcl = rng.standard_normal((B, n)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    xg_j, wr_j, wci_j, wcf_j, wco_j, h0_j, c0_j = j
    want = jlk._bwd_pallas(tuple(res_j), wr_j, wci_j.reshape(1, n),
                           wcf_j.reshape(1, n), wco_j.reshape(1, n), h0_j,
                           c0_j, jnp.asarray(gout, jdt), jnp.asarray(gcl),
                           8, True)
    res_t = tuple(torch.tensor(_np(r)).to(tdt) for r in res_j)
    got = lk.lstm_bwd_plain(res_t, *t[1:], torch.tensor(gout).to(tdt),
                            torch.tensor(gcl))
    assert got[0].dtype == tdt and all(g.dtype == torch.float32 for g in got[1:])
    for name, a, b in zip(("dg", "dWr", "dwci", "dwcf", "dwco", "dh0", "dc0"),
                          want, got):
        np.testing.assert_allclose(_np(b), _np(a).reshape(b.shape),
                                   err_msg=name, **GRAD_TOL[dtype])


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_scan_and_its_gradients_match_jax(dtype, reverse):
    """``fused_lstm_scan`` end to end, both directions (the reverse one
    runs on the time-reversed gates, as ``_lstm_scan`` does): the outputs
    and carries, and the gradients of every input through the autograd
    function against ``jax.vjp`` of the reference's custom VJP."""
    n = 128
    j, t = _both(_inputs(n, seed=5), dtype)
    rng = np.random.default_rng(6)
    cots = (rng.standard_normal((T, B, n)).astype(np.float32),
            rng.standard_normal((B, n)).astype(np.float32),
            rng.standard_normal((B, n)).astype(np.float32))
    flip_j = (lambda z: z[::-1]) if reverse else (lambda z: z)
    flip_t = (lambda z: z.flip(0)) if reverse else (lambda z: z)

    def f_j(xg, *rest):
        h, (hl, cl) = jlk.fused_lstm_scan(flip_j(xg), *rest)
        return flip_j(h), hl, cl

    (h_j, hl_j, cl_j), vjp = jax.vjp(f_j, *j)
    jdt, tdt = DTYPES[dtype]
    g_j = vjp((jnp.asarray(cots[0], jdt), jnp.asarray(cots[1], jdt),
               jnp.asarray(cots[2], jnp.float32)))

    leaves = [z.clone().requires_grad_() for z in t]
    h, (hl, cl) = lk.fused_lstm_scan(flip_t(leaves[0]), *leaves[1:])
    h = flip_t(h)
    for a, b in ((h_j, h), (hl_j, hl), (cl_j, cl)):
        np.testing.assert_allclose(_np(b.detach()), _np(a), **FWD_TOL[dtype])
    g_t = torch.autograd.grad(
        (h, hl, cl), leaves,
        (torch.tensor(cots[0]).to(tdt), torch.tensor(cots[1]).to(tdt),
         torch.tensor(cots[2])))
    for name, a, b, leaf in zip(("xg", "Wr", "wci", "wcf", "wco", "h0", "c0"),
                                g_j, g_t, leaves):
        assert b.dtype == leaf.dtype, name
        np.testing.assert_allclose(_np(b), _np(a), err_msg=name,
                                   **GRAD_TOL[dtype])


def test_no_grad_takes_the_forward_only_variant():
    """Without a gradient to build, c_T is the f32 carry (the forward-only
    kernel's); with one, it is the rounded residual (``_vjp_fwd``)."""
    _, t = _both(_inputs(32, seed=7), "bfloat16")
    with torch.no_grad():
        _, (_, c_plain) = lk.fused_lstm_scan(*t)
    leaves = [z.clone().requires_grad_() for z in t]
    _, (_, c_res) = lk.fused_lstm_scan(*leaves)
    _, (_, c_want) = lk.lstm_fwd_plain(*t, with_residuals=False)
    assert torch.equal(c_plain, c_want)
    assert torch.equal(c_res.detach(), c_want.to(torch.bfloat16).float())


def test_applicability_gate(monkeypatch):
    """The reference's configuration conditions, and on a CUDA device
    the kernels' own shape limits (here against a card of 132 SMs)."""
    gate = lk.fused_lstm_applicable
    assert gate(16, 128, "sigmoid", "tanh", None)
    assert gate(7, 100, "sigmoid", "tanh", None)  # the plain versions take any shape
    assert not gate(16, 128, "hardsigmoid", "tanh", None)
    assert not gate(16, 128, "sigmoid", "relu", None)
    assert not gate(16, 128, "sigmoid", "tanh", torch.ones(16, 4))
    assert not gate(16, 128, "sigmoid", "tanh", None, device="meta")
    monkeypatch.setattr(lk, "_sm_count", lambda device: 132)
    cuda = torch.device("cuda")
    for b, n, itemsize, want in (
            (1024, 512, 2, True),    # training: 8 x 16 blocks
            (32, 512, 4, True),      # serving: 1 x 32
            (8, 128, 4, True), (1024, 128, 4, True), (128, 1024, 2, True),
            (32, 1024, 4, True), (128, 1024, 4, True),
            (1024, 1024, 2, False),  # 8 x 64 blocks do not fit 132 SMs
            (256, 1024, 4, False), (1024, 512, 4, False),
            (16, 100, 2, False), (16, 32, 2, False), (16, 2048, 2, False)):
        assert gate(b, n, "sigmoid", "tanh", None, itemsize=itemsize,
                    device=cuda) is want, (b, n, itemsize)
        assert lk.fused_lstm_train_applicable(
            b, n, "sigmoid", "tanh", None, itemsize=itemsize,
            device=cuda) is want
    assert not gate(1024, 512, "sigmoid", "tanh", torch.ones(1), device=cuda)


def test_block_shape():
    """(BB, U, bp) on a card of 132 SMs: the training shape fills 128
    SMs with 32-unit slices; small grids narrow their slices (to 16 units
    in bf16, 4 in f32) to spread over more SMs."""
    assert lk._block_shape(1024, 512, 2, 132) == (128, 32, 1024)
    assert lk._block_shape(32, 512, 4, 132) == (32, 4, 32)
    assert lk._block_shape(32, 512, 2, 132) == (32, 16, 32)
    assert lk._block_shape(8, 1024, 2, 132) == (16, 16, 16)
    assert lk._block_shape(8, 1024, 4, 132) == (16, 8, 16)
    assert lk._block_shape(200, 1024, 4, 132) == (128, 8, 256)


def test_dw_splits():
    """The bf16 lstm_dw's ranges of m on a card of 132 SMs: the training
    shape (32 tiles of 128 x 256) splits m 4 ways, one wave of 128
    blocks; small n stops at 8 splits, short m at one split per 8 of its
    64-row chunks; n 1024 (128 tiles) and f32 do not split."""
    assert lk._dw_tiles(512) == 32 and lk._dw_tiles(64) == 1
    assert lk._dw_splits(128 * 1024, 512, 2, 132) == 4
    assert lk._dw_splits(9 * 1024, 128, 2, 132) == 8
    assert lk._dw_splits(32 * 64, 128, 2, 132) == 4
    assert lk._dw_splits(9 * 16, 128, 2, 132) == 1
    assert lk._dw_splits(9 * 32, 1024, 2, 132) == 1
    assert lk._dw_splits(128 * 1024, 512, 4, 132) == 1


def test_wrappers_refuse_other_devices():
    _, t = _both(_inputs(32), "float32")
    meta = [z.to("meta") for z in t]
    with pytest.raises(ValueError, match="cuda or cpu"):
        lk.lstm_fwd(*meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        lk.lstm_bwd(tuple(meta[:1] * 5), *meta[1:], meta[0], meta[5])


def test_cpu_runs_launch_no_kernel():
    _, t = _both(_inputs(32), "float32")
    kernels.reset_launches()
    leaves = [z.clone().requires_grad_() for z in t]
    h, (hl, cl) = lk.fused_lstm_scan(*leaves)
    (h.sum() + hl.sum() + cl.sum()).backward()
    assert sum(kernels.LAUNCHES.values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,t,n", [
    ("float32", 8, 9, 128), ("bfloat16", 16, 9, 128), ("float32", 32, 1, 512),
    ("bfloat16", 32, 5, 512), ("bfloat16", 24, 3, 1024),
    # the bf16 design's edges (BB, U on 132 SMs in the comments)
    ("bfloat16", 200, 9, 512),    # b no multiple of BB: 128, U 16
    ("bfloat16", 1024, 4, 512),   # the training layout: 128, U 32
    ("bfloat16", 16, 9, 64),      # the smallest n: 16, U 16
    ("bfloat16", 128, 3, 1024),   # the largest n: 128, U 16
    ("bfloat16", 64, 1, 512),     # t 1: 64, U 16
    ("bfloat16", 32, 128, 512)])  # t 128: 32, U 16
def test_kernels_match_plain_on_card(cuda_device, dtype, b, t, n):
    """Forward-only, residual forward and the backward pair against their
    plain versions on the card (tolerances as ``chip_smoke.py`` 2b)."""
    _, ts = _both(_inputs(n, seed=8, b=b, t=t), dtype)
    ts = [z.to(cuda_device) for z in ts]
    g = torch.Generator(device=cuda_device).manual_seed(9)
    gout = torch.randn(t, b, n, generator=g, device=cuda_device).to(ts[0].dtype)
    gcl = torch.randn(b, n, generator=g, device=cuda_device)
    kernels.reset_launches()
    fo = lk.lstm_fwd(*ts, with_residuals=False)
    hs, res = lk.lstm_fwd(*ts)
    bwd = lk.lstm_bwd(res, *ts[1:], gout, gcl)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {lk.FWD_ONLY_KERNEL: 1, lk.FWD_KERNEL: 1,
                                      lk.BWD_KERNEL: 1, lk.DW_KERNEL: 1}
    fo_p = lk.lstm_fwd_plain(*ts, with_residuals=False)
    hs_p, res_p = lk.lstm_fwd_plain(*ts)
    bwd_p = lk.lstm_bwd_plain(res, *ts[1:], gout, gcl)
    rel = 3e-2 if dtype == "bfloat16" else None
    for a, p in zip((fo[0], *fo[1], hs, *res), (fo_p[0], *fo_p[1], hs_p, *res_p)):
        err = (a.float() - p.float()).abs().max().item()
        assert err <= (rel * max(1.0, p.float().abs().max().item()) if rel else 5e-5)
    for a, p in zip(bwd, bwd_p):
        err = (a.float() - p.float()).abs().max().item()
        ref = max(1.0, p.float().abs().max().item())
        assert err <= (rel or 1e-4) * ref


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_residuals", [False, True])
def test_nan_in_gates_reaches_h_on_card(cuda_device, dtype, with_residuals):
    """A NaN pre-activation spreads through the cell and the recurrence
    as in the plain version: every output has the plain version's NaNs,
    so a diverged run cannot pass for a finite one."""
    b, t, n = 128, 4, 512
    _, ts = _both(_inputs(n, seed=10, b=b, t=t), dtype)
    ts = [z.to(cuda_device) for z in ts]
    ts[0][1, 3, 7] = float("nan")          # step 1, row 3: i of unit 7
    ts[0][2, 5, 3 * n + 9] = float("nan")  # step 2, row 5: blk of unit 9
    got = lk.lstm_fwd(*ts, with_residuals=with_residuals)
    want = lk.lstm_fwd_plain(*ts, with_residuals=with_residuals)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[0][1, 3, 7])) and bool(torch.isnan(got[0][3, 5]).all())
    for a, p in zip((got[0], *got[1]), (want[0], *want[1])):
        assert torch.equal(torch.isnan(a), torch.isnan(p))


def _backward_inputs(device, dtype, b, t, n, seed):
    """Residuals of the forward kernel on seeded inputs, and gout and
    dL/dc_T, on the card."""
    _, ts = _both(_inputs(n, seed=seed, b=b, t=t), dtype)
    ts = [z.to(device) for z in ts]
    g = torch.Generator(device=device).manual_seed(seed + 1)
    gout = torch.randn(t, b, n, generator=g, device=device).to(ts[0].dtype)
    gcl = torch.randn(b, n, generator=g, device=device)
    _, res = lk.lstm_fwd(*ts)
    return res, ts[1:], gout, gcl


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_nan_in_gout_reaches_dg_and_dwr_on_card(cuda_device, dtype):
    """A NaN in dL/dh spreads through the gate chain, the dh recurrence
    and the weight gradient as in the plain version: dg and dWr have the
    plain version's NaNs."""
    b, t, n = 128, 4, 512
    res, rest, gout, gcl = _backward_inputs(cuda_device, dtype, b, t, n, 11)
    gout[2, 5, 9] = float("nan")  # step 2, row 5, unit 9
    got = lk.lstm_bwd(res, *rest, gout, gcl)
    want = lk.lstm_bwd_plain(res, *rest, gout, gcl)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[0][2, 5, 9])) and bool(torch.isnan(got[0][1, 5]).all())
    assert bool(torch.isnan(got[1]).any())
    for a, p in zip(got[:2], want[:2]):  # dg, dWr
        assert torch.equal(torch.isnan(a), torch.isnan(p))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,t,n", [
    ("bfloat16", 1024, 8, 512),   # the training layout: lstm_dw splits m
    ("bfloat16", 1024, 9, 128),   # one dWr row tile, m split 8 ways
    ("float32", 64, 9, 128)])
def test_backward_is_deterministic_on_card(cuda_device, dtype, b, t, n):
    """Two calls on the same inputs give bitwise the same gradients: no
    atomics on a result, and the m splits of lstm_dw summed in a fixed
    order."""
    res, rest, gout, gcl = _backward_inputs(cuda_device, dtype, b, t, n, 12)
    first = lk.lstm_bwd(res, *rest, gout, gcl)
    second = lk.lstm_bwd(res, *rest, gout, gcl)
    torch.cuda.synchronize()
    for a, p in zip(first, second):  # dg, dWr, dwci, dwcf, dwco, dh0, dc0
        assert torch.equal(a, p)


@pytest.mark.cuda
def test_timed_backward_gives_the_same_outputs_on_card(cuda_device):
    """The sweep's timed instantiation computes what the untimed one
    does, bit for bit, and stamps each block's steps in order."""
    b, t, n = 256, 4, 512
    res, rest, gout, gcl = _backward_inputs(cuda_device, "bfloat16", b, t, n, 13)
    kernels.reset_launches()
    *got, stamps = lk.lstm_bwd_timed(res, *rest, gout, gcl)
    want = lk.lstm_bwd(res, *rest, gout, gcl)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {lk.BWD_TIMED_KERNEL: 1, lk.BWD_KERNEL: 1,
                                      lk.DW_KERNEL: 2}
    for a, p in zip(got, want):
        assert torch.equal(a, p)
    st = stamps.cpu()
    assert st.shape[1:] == (t, 4) and bool((st > 0).all())
    assert bool((st.flatten(1).diff(dim=1) >= 0).all())
