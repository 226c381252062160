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


# (n, dtype, b, t): both dtypes at b 16, t 9; f32 also at the char-RNN's
# serving batch, at t 1 (its serving step) and t 9
FWD_CASES = ([pytest.param(n, dtype, B, T, id=f"{n}-{dtype}")
              for n in (32, 128) for dtype in DTYPES]
             + [pytest.param(n, "float32", 32, t, id=f"{n}-float32-b32-t{t}")
                for n in (32, 128) for t in (1, 9)])


@pytest.mark.parametrize("n,dtype,b,t", FWD_CASES)
def test_forward_only_matches_jax_kernel(n, dtype, b, t):
    j, ts = _both(_inputs(n, seed=1, b=b, t=t), dtype)
    h_j, (hl_j, cl_j) = jlk._fwd_pallas(*j, block_b=8, interpret=True,
                                         with_residuals=False)
    h_t, (hl_t, cl_t) = lk.lstm_fwd_plain(*ts, with_residuals=False)
    assert h_t.dtype == DTYPES[dtype][1] and cl_t.dtype == torch.float32
    assert h_t.shape == (t, b, n)
    for a, z in ((h_j, h_t), (hl_j, hl_t), (cl_j, cl_t)):
        np.testing.assert_allclose(_np(z), _np(a), **FWD_TOL[dtype])


@pytest.mark.parametrize("n,dtype,b,t", FWD_CASES)
def test_residual_forward_matches_jax_kernel(n, dtype, b, t):
    """All six streams: h, i, f, o, blk, c."""
    j, ts = _both(_inputs(n, seed=2, b=b, t=t), dtype)
    h_j, res_j = jlk._fwd_pallas(*j, block_b=8, interpret=True)
    h_t, res_t = lk.lstm_fwd_plain(*ts)
    for name, a, z in zip("h i f o blk c".split(), (h_j, *res_j), (h_t, *res_t)):
        assert z.dtype == DTYPES[dtype][1] and z.shape == (t, b, n), name
        np.testing.assert_allclose(_np(z), _np(a), err_msg=name,
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
    # n not 64 times a power of two: U a power of two all the same
    assert lk._block_shape(32, 320, 4, 132) == (32, 4, 32)
    assert lk._block_shape(32, 576, 2, 132) == (32, 16, 32)


def test_every_grid_that_fits_has_a_built_layout():
    """Wherever the gate sends a shape to the kernels (132 SMs), its block
    layout is one they are built for: bf16 16 or 32 units; f32 4 or 8
    units at any rows, 16 or 32 only at 128 rows (``launch_f32``,
    ``launch_bf16`` and the backward's switches)."""
    built = {2: {(u, bb) for u in (16, 32) for bb in (16, 32, 64, 128)},
             4: {(u, bb) for u in (4, 8) for bb in (16, 32, 64, 128)}
             | {(16, 128), (32, 128)}}
    for itemsize, layouts in built.items():
        for n in range(64, 1025, 64):
            for b in (*range(1, 130), *range(130, 4097, 61)):
                if lk._grid_fits(b, n, itemsize, 132):
                    bb, u, bp = lk._block_shape(b, n, itemsize, 132)
                    assert (u, bb) in layouts and n % u == 0 and bp % bb == 0, \
                        (itemsize, b, n, bb, u)


# the f32 sweep's layouts (units, rows), as launch_sweep_f32 builds them
F32_BWD_LAYOUTS = {(u, bb) for u in (4, 8) for bb in (16, 32, 64, 128)} \
    | {(16, 128), (32, 128)}


def _f32_sweep_smem(n, bb, u):
    """The f32 sweep's shared memory in bytes (``sweep_smem``): the
    resident Wt [4u][n], dg [4u][bb + 4] and the dh sums of its JG groups
    of threads [JG][bb][u]."""
    r128 = lambda x: -(-x // 128) * 128  # noqa: E731
    return r128(16 * u * n) + r128(16 * u * (bb + 4)) + 4 * max(1024, bb * u)


def test_every_grid_that_fits_has_a_built_f32_backward_layout():
    """Wherever the gate sends an f32 shape to the kernels (132 SMs), the
    backward sweep is built for its block layout, its shared memory fits
    a block (227 KB), and its scratch of dh partials is 2 bp (n / u) n
    floats, at most ~135 MB (b 128, n 1024)."""
    worst = 0
    for n in range(64, 1025, 64):
        for b in (*range(1, 130), *range(130, 4097, 61)):
            if lk._grid_fits(b, n, 4, 132):
                bb, u, bp = lk._block_shape(b, n, 4, 132)
                assert (u, bb) in F32_BWD_LAYOUTS, (b, n, bb, u)
                assert _f32_sweep_smem(n, bb, u) <= 232448, (b, n, bb, u)
                worst = max(worst, 2 * bp * (n // u) * n * 4)
    assert worst <= 135 * 2 ** 20


def test_timed_backward_refuses_cpu_tensors():
    """The timed sweep is a kernel only: CPU tensors of either dtype
    raise, they do not run the plain version."""
    for dtype in DTYPES:
        _, ts = _both(_inputs(32), dtype)
        res = tuple(ts[:1] * 5)
        with pytest.raises(ValueError, match="CUDA tensors"):
            lk.lstm_bwd_timed(res, *ts[1:], ts[5], ts[6])


def test_dw_splits():
    """The bf16 lstm_dw's ranges of m on a card of 132 SMs: the training
    shape (32 tiles of 128 x 256) splits m 4 ways, one wave of 128
    blocks; small n stops at 8 splits, short m at one split per 8 of its
    64-row chunks; n 1024 (128 tiles) does not split. f32 at the same
    shape (64 tiles of 128 x 128) splits m 2 ways."""
    assert lk._dw_tiles(512) == 32 and lk._dw_tiles(64) == 1
    assert lk._dw_splits(128 * 1024, 512, 2, 132) == 4
    assert lk._dw_splits(9 * 1024, 128, 2, 132) == 8
    assert lk._dw_splits(32 * 64, 128, 2, 132) == 4
    assert lk._dw_splits(9 * 16, 128, 2, 132) == 1
    assert lk._dw_splits(9 * 32, 1024, 2, 132) == 1
    assert lk._dw_splits(128 * 1024, 512, 4, 132) == 2


def test_f32_dw_splits():
    """The f32 lstm_dw's tiles are 128 x 128 of dWr: b 32, t 128, n 512
    (64 tiles) splits m 2 ways and the char-RNN example (b 64, t 64, n
    256: 16 tiles) 8 ways, a grid of 128 blocks each; n 1024 (256 tiles,
    two waves) does not split; short m splits down to one 64-row chunk a
    split (b 8, t 9, n 128: 3 of 144 rows); a ragged n (320: 3 row tiles,
    the last half empty) counts whole tiles."""
    assert lk._dw_tiles(512, 4) == 64 and lk._dw_tiles(256, 4) == 16
    assert lk._dw_tiles(64, 4) == 2 and lk._dw_tiles(320, 4) == 30
    assert lk._dw_splits(128 * 32, 512, 4, 132) == 2
    assert lk._dw_splits(64 * 64, 256, 4, 132) == 8
    assert lk._dw_splits(128 * 16, 1024, 4, 132) == 1
    assert lk._dw_splits(9 * 16, 128, 4, 132) == 3
    assert lk._dw_splits(1 * 32, 512, 4, 132) == 1
    assert lk._dw_splits(9 * 1024, 128, 4, 132) == 8


@pytest.mark.parametrize("u", [4, 8, 16, 32])
def test_pack_wr_puts_each_blocks_columns_side_by_side(u):
    """``_pack_wr``: packed[j, k, g, i] = Wr[k, g n + j u + i]."""
    n = 64
    wr = torch.arange(n * 4 * n, dtype=torch.float32).reshape(n, 4 * n)
    packed = lk._pack_wr(wr, u)
    assert packed.shape == (n // u, n, 4, u) and packed.is_contiguous()
    j, k, g, i = (torch.arange(m).reshape(-1, 1, 1, 1).movedim(0, d)
                  for d, m in enumerate(packed.shape))
    assert torch.equal(packed, wr[k, g * n + j * u + i])


def test_pack_wr_is_none_off_the_card():
    """Only the f32 kernel reads a packed Wr: none for CPU (or meta)
    tensors, whose forward is the plain version."""
    wr = torch.zeros(64, 256)
    assert lk.pack_wr(wr, 32) is None
    assert lk.pack_wr(wr.to("meta"), 32) is None


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
    ("bfloat16", 32, 128, 512),   # t 128: 32, U 16
    # the f32 design's layouts (BB, U; k-groups KS; h chunks in flight)
    ("float32", 32, 128, 512),    # the serving layout over a scan: 32, 4; 8; all 8
    ("float32", 64, 3, 512),      # 64, 4; 4
    ("float32", 200, 5, 512),     # b no multiple of BB: 128, 8; 1; 3 of 8
    ("float32", 512, 3, 512),     # 128, 16; sums over the ring
    ("float32", 1152, 2, 256),    # 128, 32 (16 rows a thread)
    ("float32", 8, 9, 1024),      # 16, 8; 8; all 16
    ("float32", 32, 9, 1024),     # 32, 8; 4; 10 of 16
    # n not 64 times a power of two (U rounded down to a power of two)
    ("float32", 32, 5, 320),      # 32, 4
    ("bfloat16", 32, 5, 576),     # 32, 16
    # the f32 backward's layouts (BB, U; the product's passes over n;
    # lstm_dw's m splits): each built sweep instantiation at least once
    ("float32", 64, 64, 256),     # the char-RNN example: 64, 4; 1 pass; 8
    ("float32", 128, 9, 256),     # 128, 4; 2 passes
    ("float32", 64, 5, 1024),     # 64, 8; 4 passes
    ("float32", 1024, 9, 128),    # 128, 8 over 8 batch groups; 8 splits
    ("float32", 16, 3, 64),       # 16, 4: half of each tile past n; 2 tiles
    ("float32", 8, 130, 512),     # 16, 4: the dh partials' two buffers, 130 steps
    ("float32", 4352, 1, 64)])    # 128, 32 over 34 batch groups at t 1
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
    ("float32", 64, 9, 128),
    ("float32", 32, 16, 512),     # the f32 scan layout: m split 2 ways
    ("float32", 64, 64, 256),     # the char-RNN example: m split 8 ways
    ("float32", 512, 3, 512)])    # 16 units, 128 rows: the product in 4 passes
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
@pytest.mark.parametrize("dtype,b,t,n", [
    ("bfloat16", 256, 4, 512), ("float32", 32, 9, 512),
    ("float32", 64, 5, 256)])
def test_timed_backward_gives_the_same_outputs_on_card(cuda_device, dtype, b,
                                                       t, n):
    """The sweep's timed instantiations compute what the untimed ones
    do, bit for bit, and stamp each block's steps in order."""
    res, rest, gout, gcl = _backward_inputs(cuda_device, dtype, b, t, n, 13)
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


@pytest.mark.cuda
@pytest.mark.parametrize("with_residuals", [False, True])
@pytest.mark.parametrize("b,t,n", [(32, 1, 512), (32, 9, 512), (1024, 3, 128)])
def test_f32_forward_is_deterministic_on_card(cuda_device, b, t, n,
                                              with_residuals):
    """Two calls of the f32 forward on the same inputs give the same
    bits: the k-groups' sums are added in a fixed order."""
    _, ts = _both(_inputs(n, seed=16, b=b, t=t), "float32")
    ts = [z.to(cuda_device) for z in ts]
    first = lk.lstm_fwd(*ts, with_residuals=with_residuals)
    second = lk.lstm_fwd(*ts, with_residuals=with_residuals)
    torch.cuda.synchronize()
    for a, p in zip((first[0], *first[1]), (second[0], *second[1])):
        assert torch.equal(a, p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_t1_forward_needs_no_counter_on_card(cuda_device, dtype):
    """At t = 1 the forward kernels take a null counter (a plain launch,
    no barrier); at t > 1 they refuse one."""
    b, n = 32, 512
    lib = lk._lib(lk.FWD_SOURCE)
    for t, want_ok in ((1, True), (2, False)):
        _, ts = _both(_inputs(n, seed=17, b=b, t=t), dtype)
        ts = [z.to(cuda_device).contiguous() for z in ts]
        bb, u, bp = lk._block_shape(b, n, ts[0].element_size(),
                                    lk._sm_count(cuda_device))
        assert bp == b
        h_seq = torch.empty(t, b, n, dtype=ts[0].dtype, device=cuda_device)
        h_t = torch.empty(b, n, dtype=ts[0].dtype, device=cuda_device)
        c_t = torch.empty(b, n, dtype=torch.float32, device=cuda_device)
        err = lib.dl4j_lstm_fwd_only(
            *[z.data_ptr() for z in ts], h_seq.data_ptr(), h_t.data_ptr(),
            c_t.data_ptr(), None, t, bp, n, bb, u, lk._DTYPE_CODES[ts[0].dtype],
            0, lk._stream(cuda_device))
        torch.cuda.synchronize()
        assert (err == 0) is want_ok, (t, err)
        if want_ok:
            want = lk.lstm_fwd_plain(*ts, with_residuals=False)
            rel = 3e-2 if dtype == "bfloat16" else None
            for a, p in zip((h_seq, h_t, c_t), (want[0], *want[1])):
                err = (a.float() - p.float()).abs().max().item()
                assert err <= (rel * max(1.0, p.float().abs().max().item())
                               if rel else 5e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,t,with_residuals", [
    ("float32", 32, 1, False), ("float32", 32, 4, True),
    ("bfloat16", 256, 4, True)])
def test_timed_forward_gives_the_same_outputs_on_card(cuda_device, dtype, b, t,
                                                      with_residuals):
    """The forward's timed instantiations compute what the untimed ones
    do, bit for bit, and stamp each block's steps in order."""
    n = 512
    _, ts = _both(_inputs(n, seed=18, b=b, t=t), dtype)
    ts = [z.to(cuda_device) for z in ts]
    kernels.reset_launches()
    *got, stamps = lk.lstm_fwd_timed(*ts, with_residuals=with_residuals)
    want = lk.lstm_fwd(*ts, with_residuals=with_residuals)
    torch.cuda.synchronize()
    name = lk.FWD_KERNEL if with_residuals else lk.FWD_ONLY_KERNEL
    assert dict(kernels.LAUNCHES) == {lk.TIMED_KERNEL: 1, name: 1}
    for a, p in zip((got[0], *got[1]), (want[0], *want[1])):
        assert torch.equal(a, p)
    st = stamps.cpu()
    assert st.shape[1:] == (t, 4) and bool((st > 0).all())
    assert bool((st.flatten(1).diff(dim=1) >= 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("with_residuals", [False, True])
@pytest.mark.parametrize("b,t,n", [(32, 1, 512), (32, 5, 512), (8, 9, 128),
                                   (1024, 3, 128), (512, 2, 512),
                                   (32, 9, 1024)])
def test_packed_wr_gives_the_same_bits_on_card(cuda_device, b, t, n,
                                               with_residuals):
    """The f32 kernel reading ``pack_wr``'s copy computes what it computes
    from Wr, bit for bit, at every f32 layout (4 to 16 units, a ring that
    refills, row passes)."""
    _, ts = _both(_inputs(n, seed=19, b=b, t=t), "float32")
    ts = [z.to(cuda_device) for z in ts]
    packed = lk.pack_wr(ts[1], b)
    assert packed is not None
    got = lk.lstm_fwd(*ts, with_residuals=with_residuals, wr_packed=packed)
    want = lk.lstm_fwd(*ts, with_residuals=with_residuals)
    torch.cuda.synchronize()
    for a, p in zip((got[0], *got[1]), (want[0], *want[1])):
        assert torch.equal(a, p)


@pytest.mark.cuda
def test_packed_wr_of_another_batch_raises_on_card(cuda_device):
    """A copy packed for another block shape (b 512: 16 units a block)
    is refused at b 32 (4 units), as is one for bf16."""
    n = 512
    _, ts = _both(_inputs(n, seed=20, b=32, t=1), "float32")
    ts = [z.to(cuda_device) for z in ts]
    with pytest.raises(ValueError, match="packed Wr"):
        lk.lstm_fwd(*ts, with_residuals=False,
                    wr_packed=lk.pack_wr(ts[1], 512))
    _, tb = _both(_inputs(n, seed=20, b=32, t=1), "bfloat16")
    tb = [z.to(cuda_device) for z in tb]
    with pytest.raises(ValueError, match="packed Wr"):
        lk.lstm_fwd(*tb, with_residuals=False,
                    wr_packed=lk.pack_wr(ts[1], 32))
