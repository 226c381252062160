"""Port flash-attention backward (deeplearning4j_tpu_torch.ops.
flash_attention) against the JAX package's Pallas backward and its
autodiff.

The JAX side runs as its own tests run it on the CPU: ``_flash_bwd_impl``
and ``jax.grad`` of ``flash_attention`` through the Pallas interpreter.
The port's CPU side is the kernels' plain version; the CUDA kernels
``flash_dq`` and ``flash_dkv`` are held against that plain version on
the card (``cuda`` tests, and ``chip_smoke.py``). Tolerances: the
reference's own, 2e-5 in f32 and 3e-2 in bf16 for the backward pass;
2e-4 for gradients through the whole wrapper, as
tests/test_flash_attention.py holds its gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops.flash_attention import (
    _flash_bwd_impl,
    _flash_fwd_impl,
    flash_attention as jax_flash,
)
from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.ops.flash_attention import (
    _bwd_block,
    _prescale,
    _scale,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_fwd_plain,
)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
GRAD_TOL = 2e-4


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
    return torch.tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------- plain version vs the Pallas backward

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk,bq,bk", [
    (64, 64, 64, 64),      # one block
    (32, 128, 32, 32),     # tq < tk: the causal offset, several k blocks
    (64, 256, 16, 64),     # several q and k blocks
])
def test_plain_matches_pallas_bwd(rng, dtype, causal, tq, tk, bq, bk):
    q, k, v = _arrays(rng, [(4, tq, 32), (4, tk, 32), (4, tk, 32)])
    (g,) = _arrays(rng, [(4, tq, 32)])
    jq, jk, jv, jg = (_jax(a, dtype) for a in (q, k, v, g))
    jo, jl = _flash_fwd_impl(jq, jk, jv, causal, bq, bk, interpret=True)
    want = _flash_bwd_impl(jq, jk, jv, jo, jl, jg, causal, bq, bk,
                           interpret=True)
    got = flash_attention_bwd_plain(
        *(_torch(a, dtype) for a in (q, k, v, jo)),
        torch.tensor(np.asarray(jl)), _torch(g, dtype), causal, bq, bk)
    for t, w in zip(got, want):
        assert t.dtype == getattr(torch, dtype) and t.shape == w.shape
        _close(t.float().numpy(), w, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(40, 40), (24, 40)])
def test_plain_bwd_at_kernel_tiles_matches_pallas_on_ragged_tiles(
        rng, dtype, causal, tq, tk):
    """The kernels' oracle at the kernels' own 64 x 64 tiles, where the
    one tile is ragged in q and in k (and, at tq < tk, the diagonal is
    offset), against the Pallas backward at exact blocks of 8."""
    q, k, v = _arrays(rng, [(3, tq, 16), (3, tk, 16), (3, tk, 16)])
    (g,) = _arrays(rng, [(3, tq, 16)])
    jq, jk, jv, jg = (_jax(a, dtype) for a in (q, k, v, g))
    jo, jl = _flash_fwd_impl(jq, jk, jv, causal, 8, 8, interpret=True)
    want = _flash_bwd_impl(jq, jk, jv, jo, jl, jg, causal, 8, 8,
                           interpret=True)
    got = flash_attention_bwd_plain(
        *(_torch(a, dtype) for a in (q, k, v, jo)),
        torch.tensor(np.asarray(jl)), _torch(g, dtype), causal, 64, 64)
    for t, w in zip(got, want):
        assert t.dtype == getattr(torch, dtype) and t.shape == w.shape
        _close(t.float().numpy(), w, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
def test_prescale_is_one_rounding_of_the_exact_product(dtype, d):
    """What lets the kernels pre-scale q themselves: the bf16 kernels
    round the f32 product of a bf16 q and the bf16 scale (exact in f32)
    once to bf16, the f32 kernels round q * scale once to f32; both equal
    the plain versions' torch product bit for bit (at d = 128 the scale
    is not a power of two)."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((4, 256, d)) * np.exp(rng.uniform(-20, 20, (4, 256, 1)))
    q = torch.tensor(x, dtype=torch.float32).to(getattr(torch, dtype))
    if dtype == "bfloat16":
        one_rounding = (q.float() * _scale(q)).to(torch.bfloat16)
    else:  # an f32 x f32 product is exact in f64
        one_rounding = (q.double() * _scale(q)).to(torch.float32)
    assert torch.equal(one_rounding.view(torch.int16 if dtype == "bfloat16"
                                         else torch.int32),
                       _prescale(q).view(torch.int16 if dtype == "bfloat16"
                                         else torch.int32))


@pytest.mark.parametrize("causal", [False, True])
def test_plain_bwd_blocking_does_not_change_the_result(rng, causal):
    """The kernels tile 64 x 64; the plain version with other blocks,
    ragged edges included, computes the same gradients."""
    q, k, v, g = (torch.tensor(a) for a in _arrays(
        rng, [(3, 100, 16), (3, 164, 16), (3, 164, 16), (3, 100, 16)]))
    o, lse = flash_attention_fwd_plain(q, k, v, causal)
    ref = flash_attention_bwd_plain(q, k, v, o, lse, g, causal)
    for bq, bk in ((7, 33), (100, 164), (32, 16)):
        got = flash_attention_bwd_plain(q, k, v, o, lse, g, causal, bq, bk)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                       atol=2e-5)


def test_bwd_block_rule():
    """Cap at 512; no divisor <= 512 (t = 1028 = 4 * 257) keeps the
    forward block."""
    assert _bwd_block(1024, 1024) == 512
    assert _bwd_block(64, 1024) == 64
    assert _bwd_block(1028, 1028) == 1028
    assert _bwd_block(96, 512) == 32


# ------------------- gradients through the wrapper against jax.grad

@pytest.mark.parametrize("case", [
    dict(tq=64, tk=64, causal=False),                      # kernel branch
    dict(tq=64, tk=64, causal=True),                       # kernel branch
    dict(tq=32, tk=128, causal=True),                      # kernel, offset
    dict(tq=32, tk=256, causal=False, bq=32, bk=64),       # forced blocks
    dict(tq=1028, tk=1028, causal=False, bq=1028, bk=1028, h=1),  # bwd block fallback
    dict(tq=16, tk=16, causal=False, masked=True),         # key mask -> SDPA
    dict(tq=17, tk=23, causal=False),                      # no block -> SDPA
    dict(tq=32, tk=16, causal=True),                       # causal tq > tk -> SDPA
])
def test_gradients_match_jax_grad(rng, case):
    b, h, d = 1 if case.get("h") else 2, case.get("h", 2), 16
    tq, tk = case["tq"], case["tk"]
    q, k, v = _arrays(rng, [(b, tq, h, d), (b, tk, h, d), (b, tk, h, d)])
    (w,) = _arrays(rng, [(b, tq, h, d)])
    mask = None
    if case.get("masked"):
        mask = np.ones((b, tk), np.float32)
        mask[:, tk - 5:] = 0.0
    kw = dict(causal=case["causal"], block_q=case.get("bq"),
              block_k=case.get("bk"))

    def jloss(q, k, v):
        o = jax_flash(q, k, v, mask=None if mask is None else jnp.asarray(mask),
                      **kw)
        return jnp.sum(o * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(_jax(a, "float32") for a in (q, k, v)))
    tq_, tk_, tv_ = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = flash_attention(tq_, tk_, tv_,
                        mask=None if mask is None else torch.tensor(mask), **kw)
    (o * torch.tensor(w)).sum().backward()
    for t, g in zip((tq_, tk_, tv_), want):
        _close(t.grad.numpy(), g, GRAD_TOL)


@pytest.mark.parametrize("d", [160, 256, 320, 512, 1024])
@pytest.mark.parametrize("causal", [False, True])
def test_wide_head_gradients_match_jax_grad(rng, d, causal):
    """Heads wider than 128 (run at 256, 512 and 1024 on the card) through the
    wrapper's plain backward on the CPU against ``jax.grad`` of the
    reference's wrapper, whose Pallas backward takes any head size."""
    b, h, t = 1, 2, 64
    q, k, v, w = _arrays(rng, [(b, t, h, d)] * 4)

    def jloss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=causal) * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(_jax(a, "float32") for a in (q, k, v)))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    kernels.reset_launches()
    (flash_attention(*ts, causal=causal) * torch.tensor(w)).sum().backward()
    assert sum(kernels.LAUNCHES.values()) == 0
    for t_, g in zip(ts, want):
        _close(t_.grad.numpy(), g, GRAD_TOL)


def test_bf16_gradients_close_to_jax(rng):
    q, k, v, w = _arrays(rng, [(2, 64, 2, 16)] * 4)

    def jloss(q, k, v):
        o = jax_flash(q, k, v, causal=True)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(_jax(a, "bfloat16") for a in (q, k, v)))
    ts = [_torch(a, "bfloat16").requires_grad_() for a in (q, k, v)]
    o = flash_attention(*ts, causal=True)
    (o.float() * torch.tensor(w)).sum().backward()
    for t, g in zip(ts, want):
        assert t.grad.dtype == torch.bfloat16
        _close(t.grad.float().numpy(), g, TOL["bfloat16"])


def test_cpu_backward_launches_no_kernel(rng):
    kernels.reset_launches()
    q, k, v = (torch.tensor(a, requires_grad=True) for a in
               _arrays(rng, [(1, 64, 2, 16)] * 3))
    flash_attention(q, k, v, causal=True).sum().backward()
    assert kernels.LAUNCHES["flash_dq"] == 0
    assert kernels.LAUNCHES["flash_dkv"] == 0
    assert q.grad is not None and k.grad is not None and v.grad is not None


def test_unsupported_device_raises_in_backward(rng):
    q = torch.zeros(1, 8, 8, device="meta")
    lse = torch.zeros(1, 8, 1, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_bwd(q, q, q, q, lse, q, False)


# ------------------------------------------------ the kernels on the card

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,tq,tk", [
    (4, 128, 128),
    (4, 100, 164),
    (4, 128, 320),     # tq < tk: the causal offset
    (8, 200, 200),     # ragged last q- and k-tiles
    (8, 72, 200),      # an offset with a ragged diagonal
    (1, 2048, 2048),   # few blocks, a long loop
])
def test_kernels_match_plain_on_card(cuda_device, dtype, d, causal, bh, tq, tk):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(bh, t, d, generator=g, device=cuda_device).to(dt)
                   for t in (tq, tk, tk, tq))
    o, lse = flash_attention_fwd(q, k, v, causal)
    kernels.reset_launches()
    got = flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_dq"] == 1
    assert kernels.LAUNCHES["flash_dkv"] == 1
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    for a, b in zip(got, want):
        ref = b.float().abs().max().item()
        # f32: CUDA-core FMAs in another order; bf16: ds is rounded to
        # bf16 and summed in another order, so the bound scales with |ref|
        tol = 2e-5 if dtype == "float32" else 2e-2 * ref
        assert (a.float() - b.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 96])  # zero-padded to 64 and 128
@pytest.mark.parametrize("causal", [False, True])
def test_kernels_take_other_head_sizes_on_card(cuda_device, dtype, d, causal):
    bh, tq, tk = 8, 72, 200
    g = torch.Generator(device=cuda_device).manual_seed(0)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(bh, t, d, generator=g, device=cuda_device).to(dt)
                   for t in (tq, tk, tk, tq))
    o, lse = flash_attention_fwd(q, k, v, causal)
    kernels.reset_launches()
    got = flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_dq"] == 1
    assert kernels.LAUNCHES["flash_dkv"] == 1
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.is_contiguous()
        ref = b.float().abs().max().item()
        tol = 2e-5 if dtype == "float32" else 2e-2 * ref
        assert (a.float() - b.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_autograd_runs_the_kernels_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn(2, 128, 4, 64, generator=g, device=cuda_device)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    kernels.reset_launches()
    flash_attention(q, k, v, causal=True).float().sum().backward()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_dq"] == 1 and kernels.LAUNCHES["flash_dkv"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [160, 256, 320, 512])  # run at 256 and 512
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,tq,tk", [
    (8, 200, 200),     # ragged last q- and k-tiles
    (8, 72, 200),      # tq < tk: an offset with a ragged diagonal
    (1, 2048, 2048),   # one head: few blocks, a long loop
])
def test_wide_bf16_backward_matches_plain_on_card(cuda_device, d, causal, bh, tq, tk):
    """The bf16 heads of 129-512 run flash_dq_kernel_wide and
    flash_dkv_kernel_wide, one launch each per backward call, within
    2e-2 x max |ref| of the plain backward (ds and p rounded to bf16,
    the partial scores summed in another order)."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v, do = (torch.randn(bh, t, d, generator=g, device=cuda_device)
                   .to(torch.bfloat16) for t in (tq, tk, tk, tq))
    o, lse = flash_attention_fwd(q, k, v, causal)
    kernels.reset_launches()
    got = flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"flash_dq": 1, "flash_dkv": 1}
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.is_contiguous()
        assert bool(torch.isfinite(a.float()).all())
        ref = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= 2e-2 * ref
