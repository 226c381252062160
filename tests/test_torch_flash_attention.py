"""Port flash attention (deeplearning4j_tpu_torch.ops.flash_attention)
against the JAX package's Pallas kernel and its XLA oracle.

The JAX side runs as its own tests run it on the CPU: ``_flash_fwd_impl``
and ``flash_attention`` through the Pallas interpreter. The port's CPU
side is the kernel's plain version; the CUDA kernel itself is held
against that plain version on the card (``cuda`` tests, and
``chip_smoke.py``). Tolerances are those of tests/test_flash_attention.py:
2e-5 in f32, 3e-2 in bf16.
"""

import os
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops.attention import (
    scaled_dot_product_attention as jax_sdpa,
)
from deeplearning4j_tpu.ops.flash_attention import (
    _flash_fwd_impl,
    flash_attention as jax_flash,
)
from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.ops.attention import scaled_dot_product_attention
from deeplearning4j_tpu_torch.ops.flash_attention import (
    _flash_fwd_cuda,
    _head_width,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_fwd_plain,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _arrays(rng, shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax(a, dtype):
    return jnp.asarray(a, jnp.float32).astype(getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.tensor(a).to(getattr(torch, dtype))


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


# -------------------------------------- plain version vs the Pallas kernel

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk,bq,bk", [
    (64, 64, 64, 64),      # one block
    (32, 128, 32, 32),     # tq < tk: the causal offset, several k blocks
    (64, 256, 16, 64),     # several q and k blocks
])
def test_plain_matches_pallas_fwd(rng, dtype, causal, tq, tk, bq, bk):
    q, k, v = _arrays(rng, [(4, tq, 32), (4, tk, 32), (4, tk, 32)])
    jo, jl = _flash_fwd_impl(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                             causal, bq, bk, interpret=True)
    to, tl = flash_attention_fwd_plain(_torch(q, dtype), _torch(k, dtype),
                                       _torch(v, dtype), causal, bq, bk)
    assert to.dtype == getattr(torch, dtype) and tl.dtype == torch.float32
    assert tuple(tl.shape) == (4, tq, 1)
    _close(to.float().numpy(), jo, dtype)
    _close(tl.numpy(), jl, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(40, 40), (24, 40)])
def test_plain_at_kernel_tiles_matches_pallas_on_ragged_tiles(rng, dtype,
                                                              causal, tq, tk):
    """The kernel's oracle at the kernel's own 64 x 64 tiles, where the
    one tile is ragged in q and in k (and, at tq < tk, the diagonal is
    offset), against the Pallas kernel at exact blocks of 8."""
    q, k, v = _arrays(rng, [(3, tq, 16), (3, tk, 16), (3, tk, 16)])
    jo, jl = _flash_fwd_impl(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                             causal, 8, 8, interpret=True)
    to, tl = flash_attention_fwd_plain(_torch(q, dtype), _torch(k, dtype),
                                       _torch(v, dtype), causal, 64, 64)
    _close(to.float().numpy(), jo, dtype)
    _close(tl.numpy(), jl, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(40, 40), (24, 40)])
@pytest.mark.parametrize("block_q", [32, 16])
def test_plain_at_wide_1024_tiles_matches_pallas(rng, dtype, causal, tq, tk,
                                                 block_q):
    """The oracle at the wide kernel's tiles for heads of 1024 (32 or 16
    query rows, 16 keys), ragged in q and in k (and, at tq < tk, with the
    diagonal offset), against the Pallas kernel at exact blocks of 8."""
    q, k, v = _arrays(rng, [(2, tq, 1024), (2, tk, 1024), (2, tk, 1024)])
    jo, jl = _flash_fwd_impl(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                             causal, 8, 8, interpret=True)
    to, tl = flash_attention_fwd_plain(_torch(q, dtype), _torch(k, dtype),
                                       _torch(v, dtype), causal, block_q, 16)
    _close(to.float().numpy(), jo, dtype)
    _close(tl.numpy(), jl, dtype)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_blocking_does_not_change_the_result(rng, causal):
    """The kernel tiles 64 x 64; the plain version with other blocks,
    ragged edges included, computes the same function."""
    q, k, v = (torch.tensor(a) for a in
               _arrays(rng, [(3, 100, 16), (3, 164, 16), (3, 164, 16)]))
    o64, l64 = flash_attention_fwd_plain(q, k, v, causal)
    o7, l7 = flash_attention_fwd_plain(q, k, v, causal, 7, 33)
    np.testing.assert_allclose(o7.numpy(), o64.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(l7.numpy(), l64.numpy(), rtol=2e-5, atol=2e-5)


def test_sdpa_matches_reference(rng):
    q, k, v = _arrays(rng, [(2, 12, 3, 8), (2, 20, 3, 8), (2, 20, 3, 8)])
    mask = np.ones((2, 20), np.float32)
    mask[1, 13:] = 0.0
    for causal in (False, True):
        for m in (None, mask):
            want = jax_sdpa(_jax(q, "float32"), _jax(k, "float32"),
                            _jax(v, "float32"), causal=causal,
                            mask=None if m is None else jnp.asarray(m))
            got = scaled_dot_product_attention(
                torch.tensor(q), torch.tensor(k), torch.tensor(v),
                causal=causal, mask=None if m is None else torch.tensor(m))
            _close(got.numpy(), want, "float32")


# ------------------------------------------------ the wrapper's dispatch

@pytest.mark.parametrize("case", [
    dict(tq=64, tk=64, causal=False),                     # kernel branch
    dict(tq=64, tk=64, causal=True),                      # kernel branch
    dict(tq=32, tk=128, causal=True),                     # kernel, offset
    dict(tq=32, tk=256, causal=False, bq=32, bk=64),      # forced blocks
    dict(tq=16, tk=16, causal=False, masked=True),        # key mask -> plain
    dict(tq=17, tk=23, causal=False),                     # no block -> plain
    dict(tq=4, tk=4, causal=True),                        # short prompt -> plain
    dict(tq=32, tk=16, causal=True),                      # causal tq > tk -> plain
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_matches_reference_wrapper(rng, case, dtype):
    b, h, d = 2, 2, 16
    tq, tk = case["tq"], case["tk"]
    q, k, v = _arrays(rng, [(b, tq, h, d), (b, tk, h, d), (b, tk, h, d)])
    mask = None
    if case.get("masked"):
        mask = np.ones((b, tk), np.float32)
        mask[:, tk - 5:] = 0.0
    kw = dict(causal=case["causal"], block_q=case.get("bq"),
              block_k=case.get("bk"))
    want = jax_flash(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                     mask=None if mask is None else jnp.asarray(mask), **kw)
    got = flash_attention(_torch(q, dtype), _torch(k, dtype),
                          _torch(v, dtype),
                          mask=None if mask is None else torch.tensor(mask),
                          **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, tq, h, d)
    _close(got.float().numpy(), want, dtype)
    oracle = jax_sdpa(_jax(q, "float32"), _jax(k, "float32"),
                      _jax(v, "float32"), causal=case["causal"],
                      mask=None if mask is None else jnp.asarray(mask))
    _close(got.float().numpy(), oracle, dtype)


def test_cpu_path_launches_no_kernel(rng):
    kernels.reset_launches()
    q, k, v = (torch.tensor(a) for a in
               _arrays(rng, [(1, 64, 2, 16)] * 3))
    flash_attention(q, k, v, causal=True)
    assert kernels.LAUNCHES["flash_fwd"] == 0


def test_backward_matches_plain_formulation(rng):
    """The flash backward's gradients are those of the plain
    formulation."""
    arrays = _arrays(rng, [(1, 64, 2, 16)] * 3)
    q, k, v = (torch.tensor(a, requires_grad=True) for a in arrays)
    flash_attention(q, k, v, causal=True).sum().backward()
    rq, rk, rv = (torch.tensor(a, requires_grad=True) for a in arrays)
    scaled_dot_product_attention(rq, rk, rv, causal=True).sum().backward()
    for got, want in ((q, rq), (k, rk), (v, rv)):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_unsupported_device_raises(rng):
    q = torch.zeros(1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_fwd(q, q, q, False)


@pytest.mark.parametrize("d,width", [(8, 64), (63, 64), (64, 64), (96, 128),
                                     (128, 128), (129, 256), (256, 256),
                                     (257, 512), (512, 512), (513, 1024),
                                     (1024, 1024)])
def test_head_width_pads_up_to_a_built_size(d, width):
    assert _head_width(d) == width


@pytest.mark.parametrize("d", [160, 256, 320, 512, 1024])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_heads_match_reference_wrapper(rng, dtype, causal, d):
    """A head wider than 128 (the kernels pad 129-256 to 256, 257-512 to
    512 and 513-1024 to 1024) runs through the flash wrapper's plain
    version on the CPU and
    matches the reference's wrapper, which runs its Pallas kernel at any
    head size."""
    b, h, t = 1, 2, 64
    q, k, v = _arrays(rng, [(b, t, h, d)] * 3)
    want = jax_flash(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                     causal=causal)
    kernels.reset_launches()
    got = flash_attention(_torch(q, dtype), _torch(k, dtype),
                          _torch(v, dtype), causal=causal)
    assert sum(kernels.LAUNCHES.values()) == 0
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, t, h, d)
    _close(got.float().numpy(), want, dtype)


def test_head_width_rejects_heads_past_1024():
    with pytest.raises(ValueError, match="up to 1024"):
        _head_width(1025)


# ------------------------------------------------- the kernel on the card

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,tq,tk", [
    (8, 128, 320),     # tq < tk: the causal offset
    (8, 200, 200),     # ragged last q- and k-tiles
    (8, 72, 200),      # an offset with a ragged diagonal
    (1, 2048, 2048),   # few blocks, a long key loop
])
def test_kernel_matches_plain_on_card(cuda_device, dtype, tol, d, causal,
                                      bh, tq, tk):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(bh, t, d, generator=g, device=cuda_device)
               .to(getattr(torch, dtype)) for t in (tq, tk, tk))
    kernels.reset_launches()
    o, lse = flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_fwd"] == 1
    op, lp = flash_attention_fwd_plain(q, k, v, causal)
    assert (o.float() - op.float()).abs().max().item() <= tol
    assert (lse - lp).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("d", [8, 96])  # zero-padded to 64 and 128
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,tq,tk", [(8, 200, 200), (8, 72, 200)])
def test_kernel_takes_other_head_sizes_on_card(cuda_device, dtype, tol, d,
                                               causal, bh, tq, tk):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(bh, t, d, generator=g, device=cuda_device)
               .to(getattr(torch, dtype)) for t in (tq, tk, tk))
    kernels.reset_launches()
    o, lse = flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_fwd"] == 1
    assert o.shape == q.shape and o.is_contiguous()
    op, lp = flash_attention_fwd_plain(q, k, v, causal)
    assert (o.float() - op.float()).abs().max().item() <= tol
    assert (lse - lp).abs().max().item() <= 1e-4


@pytest.mark.cuda
# the wide kernel at 256, 512 and 1024 (640 and 1000 zero-padded to 1024)
@pytest.mark.parametrize("d", [160, 256, 320, 512, 640, 1000, 1024])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,tq,tk", [
    (8, 128, 320),     # tq < tk: the causal offset
    (8, 72, 200),      # an offset with a ragged diagonal
    (1, 2048, 2048),   # few blocks, a long key loop
])
def test_wide_bf16_forward_matches_plain_on_card(cuda_device, d, causal, bh,
                                                 tq, tk):
    """The bf16 heads of 129-1024 run the wide tensor-core forward (one
    launch a call) and match its plain version within bf16's 2e-2 on o
    and 1e-4 on lse."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(bh, t, d, generator=g, device=cuda_device)
               .to(torch.bfloat16) for t in (tq, tk, tk))
    kernels.reset_launches()
    o, lse = flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"flash_fwd": 1}
    assert o.shape == q.shape and o.is_contiguous()
    op, lp = flash_attention_fwd_plain(q, k, v, causal)
    assert (o.float() - op.float()).abs().max().item() <= 2e-2
    assert (lse - lp).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("block_q", [0, 16, 32])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,tq,tk", [(8, 72, 200), (2, 1024, 1024)])
def test_wide_1024_forward_sums_the_four_partials_alike_on_card(
        cuda_device, causal, bh, tq, tk, block_q):
    """At d 1024 the four warps of a row group each contract S over 256
    columns and sum the four partials; with q's columns 0-255 scaled by 8
    the first partial dominates the others, so a warp that left one out,
    counted one twice or summed another row group's would give o and lse
    far from the plain version's. In both tilings (16 and 32 query rows a
    block) and the one the kernel picks (0)."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn(bh, t, 1024, generator=g, device=cuda_device)
               .to(torch.bfloat16) for t in (tq, tk, tk))
    q[..., :256] *= 8
    kernels.reset_launches()
    o, lse = _flash_fwd_cuda(q, k, v, causal, block_q)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"flash_fwd": 1}
    op, lp = flash_attention_fwd_plain(q, k, v, causal)
    assert (o.float() - op.float()).abs().max().item() <= 2e-2
    assert (lse - lp).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("d", [160, 256, 320, 512, 1024])  # run at 256, 512, 1024
@pytest.mark.parametrize("causal", [False, True])
def test_wide_heads_run_the_kernels_on_card(cuda_device, dtype, tol, d, causal):
    """A head of 129-1024 runs the kernels on the card, forward and
    backward, one launch of each, at a ragged length (t 200: no multiple
    of any tile), and matches their plain versions (the backward within
    the bf16 bound relative to max |ref|, as in
    tests/test_torch_flash_backward.py)."""
    bh, tq, tk = 4, 72, 200
    g = torch.Generator(device=cuda_device).manual_seed(0)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(bh, t, d, generator=g, device=cuda_device).to(dt)
                   for t in (tq, tk, tk, tq))
    kernels.reset_launches()
    o, lse = flash_attention_fwd(q, k, v, causal)
    grads = flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"flash_fwd": 1, "flash_dq": 1,
                                      "flash_dkv": 1}
    op, lp = flash_attention_fwd_plain(q, k, v, causal)
    assert o.shape == q.shape and o.is_contiguous()
    assert (o.float() - op.float()).abs().max().item() <= tol
    assert (lse - lp).abs().max().item() <= 1e-4
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    for a, b in zip(grads, want):
        assert a.shape == b.shape and a.is_contiguous()
        ref = b.float().abs().max().item()
        bound = tol if dtype == "float32" else tol * ref
        assert (a.float() - b.float()).abs().max().item() <= bound


@pytest.mark.cuda
# the 3xTF32 kernel at 64, 128, 256 and 512 (100, 200 and 300 zero-padded)
@pytest.mark.parametrize("d", [64, 100, 128, 200, 256, 300, 512])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,tq,tk", [
    (8, 128, 320),     # tq < tk: the causal offset
    (8, 200, 200),     # ragged last q- and k-tiles
    (8, 72, 200),      # an offset with a ragged diagonal
    (1, 2048, 2048),   # few blocks, a long key loop
])
def test_f32_forward_matches_plain_on_card(cuda_device, d, causal, bh, tq, tk):
    """The f32 heads of 1-512 run flash_fwd_kernel_tf32x3 (the scores one
    f32 chain each, P.V in 3xTF32), one launch a call, within the f32
    tolerance of the plain version on o and lse."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = (torch.randn(bh, t, d, generator=g, device=cuda_device) for t in (tq, tk, tk))
    kernels.reset_launches()
    o, lse = flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"flash_fwd": 1}
    assert o.shape == q.shape and o.is_contiguous() and bool(torch.isfinite(o).all())
    op, lp = flash_attention_fwd_plain(q, k, v, causal)
    assert (o - op).abs().max().item() <= TOL["float32"]
    assert (lse - lp).abs().max().item() <= TOL["float32"]


@pytest.mark.cuda
@pytest.mark.parametrize("block_q", [0, 16, 32])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,tq,tk", [(8, 128, 320), (8, 200, 200), (8, 72, 200),
                                      (2, 1024, 1024)])
def test_f32_1024_forward_matches_plain_in_both_tilings_on_card(cuda_device, causal, bh,
                                                                tq, tk, block_q):
    """The f32 head of 1024 runs flash_fwd_kernel_tf32x3 in blocks of 16
    rows (one row group, 64-key tiles) or 32 (two row groups, 32-key
    tiles, a row group's rows past tq or keys above its diagonal
    skipped), and the one the kernel picks (0): one launch, within the f32
    tolerance of the plain version on o and lse, at an offset, ragged
    tiles and a full tile."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v = (torch.randn(bh, t, 1024, generator=g, device=cuda_device) for t in (tq, tk, tk))
    kernels.reset_launches()
    o, lse = _flash_fwd_cuda(q, k, v, causal, block_q)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"flash_fwd": 1}
    assert bool(torch.isfinite(o).all())
    op, lp = flash_attention_fwd_plain(q, k, v, causal)
    assert (o - op).abs().max().item() <= TOL["float32"]
    assert (lse - lp).abs().max().item() <= TOL["float32"]


def _profiled_forward(fn):
    """The profiled names of the flash forward kernels one call of ``fn``
    runs. A profile that kept none of them (the card's machine sometimes
    drops device events) is taken again with a wider idle margin."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = set()
    for pad in (0.02, 0.2, 1.0, 2.0):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        seen = {e.key for e in prof.key_averages()
                if e.self_device_time_total > 0 and "flash_fwd_kernel" in e.key}
        if seen:
            break
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256, 512, 1024])
def test_f32_forward_runs_the_kernel_its_head_takes_on_card(cuda_device, d):
    """An f32 head of every width the kernels are built for, 1024
    included, runs flash_fwd_kernel_tf32x3 and nothing else."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v = (torch.randn(2, 200, d, generator=g, device=cuda_device) for _ in range(3))
    name = chip_smoke.fwd_kernel_name("float32", d)
    assert name == "flash_fwd_kernel_tf32x3<"
    seen = _profiled_forward(lambda: flash_attention_fwd(q, k, v, True))
    assert seen and all(name in key for key in seen), (seen, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d,block_q", [(1024, 64), (1024, 8), (512, 16), (512, 32),
                                       (256, 64)])
def test_kernel_refuses_other_tilings_on_card(cuda_device, d, block_q, dtype):
    """The kernel takes a block of query rows only where it has that
    tiling (bf16: 64 or 128 at heads of 64 and 128; 16 or 32 at 1024 in
    either dtype) and raises on any other, launching nothing."""
    q = torch.zeros(2, 128, d, dtype=getattr(torch, dtype), device=cuda_device)
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        _flash_fwd_cuda(q, q, q, True, block_q)
    assert sum(kernels.LAUNCHES.values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_wide_heads_on_card_raise(cuda_device, dtype, causal):
    """On the card a head above 1024 raises in ``flash_attention`` (no
    kernel is built for it, and no plain formulation stands in) and
    launches nothing."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(2, 128, 4, 1025, generator=g, device=cuda_device)
               .to(getattr(torch, dtype)) for _ in range(3))
    kernels.reset_launches()
    with pytest.raises(ValueError, match="up to 1024"):
        flash_attention(q, k, v, causal=causal)
    assert sum(kernels.LAUNCHES.values()) == 0
