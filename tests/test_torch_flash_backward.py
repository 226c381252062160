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
tests/test_flash_attention.py holds its gradients. The f32 kernels at
heads up to 512 compute their products in 3xTF32; an emulation of those
products on the CPU runs through the plain backward against the JAX
package at the f32 tolerance. C3 and C4: the JAX package's own f32
errors at scores of ±60 (``chip_smoke.scale4_arrays``), from an f64
forward and backward, are pinned in ``chip_smoke.py`` and re-measured
here, and the f32 kernels of every head up to 1024 are held to twice them
on the card.
"""

import os
import sys
import time

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
    _flash_bwd_cuda,
    _flash_fwd_cuda,
    _prescale,
    _scale,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_fwd_plain,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
GRAD_TOL = 2e-4
# the 3xTF32 kernels against the plain f32 backward at inputs drawn at
# scale 4 (test_tf32x3_kernels_hold_hard_f32_inputs_on_card), relative to
# max |ref|: scores of ±40 and more, where p's exponential scales up each
# score's rounding (the plain version's scores are not the kernels'
# chains, so the two part by several times the f32 error there), under
# this bound, one TF32 product's dozens of times over it
SCALE4_REL = 1e-4
# C3 and C4: the JAX package's own f32 errors on
# ``chip_smoke.scale4_arrays(d)`` ([2, 128, d], 4 x randn from numpy
# seeds: scores of ±60 and more), relative to max |ref|, measured on the
# CPU and pinned in chip_smoke.py, whose phase 2 fails where the port's
# f32 kernels pass twice them: the backward's (dq, dk, dv from
# ``chip_smoke.bwd_f64``; test_reference_error_at_scale4_is_pinned) and
# the forward's (o, lse from ``chip_smoke.fwd_f64``;
# test_reference_fwd_error_at_scale4_is_pinned). The reference's two
# passes compute the scores alike, so s - lse cancels their rounding; the
# port's f32 kernels take every score in the f32 forward's order for that
REF_SCALE4_REL = chip_smoke.REF_SCALE4_REL
REF_SCALE4_FWD_REL = chip_smoke.REF_SCALE4_FWD_REL


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


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(40, 40), (24, 40)])
@pytest.mark.parametrize("bq,bk", [
    (128, 64), (128, 32),          # flash_dq_kernel_tf32x3: 128 rows, key tiles of 64 / 32
    (64, 128), (32, 128), (16, 128),  # flash_dkv_kernel_tf32x3: 128 keys, query tiles and steps
])
def test_plain_bwd_at_tf32x3_tiles_matches_pallas_on_ragged_tiles(
        rng, causal, tq, tk, bq, bk):
    """The f32 kernels' oracle at the 3xTF32 kernels' own tiles (one
    ragged tile in q and in k; at tq < tk an offset diagonal) against the
    Pallas backward at exact blocks of 8, at the f32 tolerance."""
    q, k, v = _arrays(rng, [(3, tq, 16), (3, tk, 16), (3, tk, 16)])
    (g,) = _arrays(rng, [(3, tq, 16)])
    jq, jk, jv, jg = (_jax(a, "float32") for a in (q, k, v, g))
    jo, jl = _flash_fwd_impl(jq, jk, jv, causal, 8, 8, interpret=True)
    want = _flash_bwd_impl(jq, jk, jv, jo, jl, jg, causal, 8, 8,
                           interpret=True)
    got = flash_attention_bwd_plain(
        *(_torch(a, "float32") for a in (q, k, v, jo)),
        torch.tensor(np.asarray(jl)), _torch(g, "float32"), causal, bq, bk)
    for t, w in zip(got, want):
        assert t.dtype == torch.float32 and t.shape == w.shape
        _close(t.numpy(), w, TOL["float32"])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(40, 40), (24, 40)])
@pytest.mark.parametrize("d,bq,bk", [
    (256, 64, 16), (512, 32, 8),   # flash_dq_kernel_wide_tf32x3: resident rows, key tiles
    (256, 16, 64), (512, 8, 32),   # flash_dkv_kernel_wide_tf32x3: query tiles, resident keys
    (1024, 16, 8), (1024, 8, 16),  # the same at 1024: 16 resident rows, 8-row tiles
])
def test_plain_bwd_at_wide_tf32x3_tiles_matches_pallas_on_ragged_tiles(
        rng, causal, tq, tk, d, bq, bk):
    """The f32 kernels' oracle at the wide 3xTF32 kernels' own tiles and
    heads (one ragged tile in q and in k; at tq < tk an offset diagonal)
    against the Pallas backward at exact blocks of 8, at the f32
    tolerance."""
    q, k, v = _arrays(rng, [(2, tq, d), (2, tk, d), (2, tk, d)])
    (g,) = _arrays(rng, [(2, tq, d)])
    jq, jk, jv, jg = (_jax(a, "float32") for a in (q, k, v, g))
    jo, jl = _flash_fwd_impl(jq, jk, jv, causal, 8, 8, interpret=True)
    want = _flash_bwd_impl(jq, jk, jv, jo, jl, jg, causal, 8, 8,
                           interpret=True)
    got = flash_attention_bwd_plain(
        *(_torch(a, "float32") for a in (q, k, v, jo)),
        torch.tensor(np.asarray(jl)), _torch(g, "float32"), causal, bq, bk)
    for t, w in zip(got, want):
        assert t.dtype == torch.float32 and t.shape == w.shape
        _close(t.numpy(), w, TOL["float32"])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(40, 40), (24, 40)])
@pytest.mark.parametrize("bq,bk", [
    (16, 16),  # flash_dq_kernel_wide<1024, 16>: 16 rows, 16-key tiles;
               # flash_dkv_kernel_wide<1024>: 16 keys, 16-query tiles
    (32, 8),   # flash_dq_kernel_wide<1024, 32>: 32 rows, 8-key tiles
])
def test_plain_bwd_at_wide_1024_tiles_matches_pallas_on_ragged_tiles(
        rng, causal, tq, tk, bq, bk):
    """The bf16 kernels' oracle at the wide bf16 kernels' own tiles at a
    head of 1024 (one ragged tile in q and in k; at tq < tk an offset
    diagonal) against the Pallas backward at exact blocks of 8, at the
    bf16 tolerance."""
    q, k, v = _arrays(rng, [(2, tq, 1024), (2, tk, 1024), (2, tk, 1024)])
    (g,) = _arrays(rng, [(2, tq, 1024)])
    jq, jk, jv, jg = (_jax(a, "bfloat16") for a in (q, k, v, g))
    jo, jl = _flash_fwd_impl(jq, jk, jv, causal, 8, 8, interpret=True)
    want = _flash_bwd_impl(jq, jk, jv, jo, jl, jg, causal, 8, 8,
                           interpret=True)
    got = flash_attention_bwd_plain(
        *(_torch(a, "bfloat16") for a in (q, k, v, jo)),
        torch.tensor(np.asarray(jl)), _torch(g, "bfloat16"), causal, bq, bk)
    for t, w in zip(got, want):
        assert t.dtype == torch.bfloat16 and t.shape == w.shape
        _close(t.float().numpy(), w, TOL["bfloat16"])


@pytest.mark.parametrize("d", sorted(REF_SCALE4_REL))
def test_reference_error_at_scale4_is_pinned(d):
    """C3 on the CPU: the JAX package's f32 backward on the scale-4
    arrays, from the f64 backward, stays within twice the pinned
    figures (either way): the yardstick of the card's C3 test."""
    q, k, v, g = chip_smoke.scale4_arrays(np, d)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jo, jl = _flash_fwd_impl(jq, jk, jv, True, 128, 128, interpret=True)
    got = _flash_bwd_impl(jq, jk, jv, jo, jl, jg, True, 128, 128, interpret=True)
    ref = chip_smoke.bwd_f64(torch, *(torch.tensor(a) for a in (q, k, v, g)), True)
    errs = chip_smoke.rel_errors([torch.tensor(np.asarray(a)) for a in got], ref)
    for err, pinned in zip(errs, REF_SCALE4_REL[d]):
        assert pinned / 2 <= err <= 2 * pinned, (d, errs)


@pytest.mark.parametrize("d", sorted(REF_SCALE4_FWD_REL))
def test_reference_fwd_error_at_scale4_is_pinned(d):
    """C4 on the CPU: the JAX package's f32 forward on the scale-4
    arrays, o and lse from the f64 forward, stays within twice the
    pinned figures (either way): the yardstick of the 3xTF32 forward."""
    q, k, v, _ = chip_smoke.scale4_arrays(np, d)
    jo, jl = _flash_fwd_impl(*(jnp.asarray(a) for a in (q, k, v)), True, 128, 128,
                             interpret=True)
    ref = chip_smoke.fwd_f64(torch, *(torch.tensor(a) for a in (q, k, v)), True)
    got = [torch.tensor(np.asarray(jo)), torch.tensor(np.asarray(jl)).reshape(ref[1].shape)]
    assert got[0].dtype == got[1].dtype == torch.float32
    errs = chip_smoke.rel_errors(got, ref)
    for err, pinned in zip(errs, REF_SCALE4_FWD_REL[d]):
        assert pinned / 2 <= err <= 2 * pinned, (d, errs)


@pytest.fixture(scope="module")
def scale4_emulation_rows():
    """The rows ``scripts/scale4_emulation.py`` prints, one per head."""
    import importlib.util
    import io
    import json
    from contextlib import redirect_stdout

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "scale4_emulation", os.path.join(root, "scripts", "scale4_emulation.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    out = io.StringIO()
    with redirect_stdout(out):
        assert module.main() == 0
    return [json.loads(ln.split(" ", 1)[1]) for ln in out.getvalue().splitlines()]


def test_scale4_emulation_puts_the_error_in_the_scores_order(scale4_emulation_rows):
    """C3's emulation (``scripts/scale4_emulation.py``): with lse from the
    f32 forward's scores, the backward that takes its scores in the
    forward's order stays within twice the JAX package's own error at
    every head, and scores from the tensor cores, over the head's width
    up to 128 or over halves of it, do not."""
    rows = scale4_emulation_rows
    assert [r["d"] for r in rows] == sorted(REF_SCALE4_REL)
    for r in rows:
        ref, width = REF_SCALE4_REL[r["d"]], min(r["d"], 128)
        assert all(e <= 2 * x for e, x in zip(r["errors"]["forward_order"], ref))
        for chain in (width, width // 2):
            assert any(e > 2 * x for e, x in zip(r["errors"][f"tensor_cores_{chain}"], ref))


def test_scale4_emulation_splits_the_chain_at_1024(scale4_emulation_rows):
    """Why the f32 kernels at 1024 sum a chain over each quarter of the
    head (``score_chain_cols``): one chain over all 1024 columns, in the
    forward and the backward alike, passes twice the JAX package's own
    error in the forward or the backward after it, and the quarters
    hold both."""
    (r,) = [r for r in scale4_emulation_rows if r["d"] == 1024]
    ref_f, ref_b = REF_SCALE4_FWD_REL[1024], REF_SCALE4_REL[1024]
    errs = r["errors"]
    assert any(e > 2 * x for e, x in zip(errs["one_chain_forward"], ref_f)) or \
        any(e > 2 * x for e, x in zip(errs["one_chain"], ref_b)), errs
    assert all(e <= 2 * x for e, x in zip(errs["forward"], ref_f)), errs
    assert all(e <= 2 * x for e, x in zip(errs["forward_order"], ref_b)), errs
    assert [x["d"] for x in scale4_emulation_rows if "one_chain" in x["errors"]] == [1024]


@pytest.mark.parametrize("d", sorted(REF_SCALE4_FWD_REL))
def test_scale4_emulation_holds_the_tf32x3_forward(scale4_emulation_rows, d):
    """C4's emulation: the f32 forward as ``flash_fwd_kernel_tf32x3``
    computes it (scores in the forward's order, the online softmax over
    its key tiles, P.V in 3xTF32 into zeroed partials) stays within
    twice the JAX package's own forward error in o and lse, and the
    backward in the forward's order after it (its lse and o) within
    twice the reference's backward error."""
    (r,) = [r for r in scale4_emulation_rows if r["d"] == d]
    fwd, after = r["errors"]["forward"], r["errors"]["after_forward"]
    assert len(fwd) == 2 and len(after) == 3
    assert all(e <= 2 * x for e, x in zip(fwd, REF_SCALE4_FWD_REL[d])), (d, fwd)
    assert all(e <= 2 * x for e, x in zip(after, REF_SCALE4_REL[d])), (d, after)


# ------------------- the 3xTF32 products of the f32 kernels, emulated

def _tf32_round(x):
    """x (f32) rounded to TF32, 10 mantissa bits, nearest with ties away
    from zero: cvt.rna.tf32.f32's bits, which the kernels get by an
    integer add and mask."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_read(x):
    """x as the tensor cores read a TF32 operand: its top 19 bits (sign,
    exponent, 10 mantissa bits), the rest dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _matmul_tf32x3(a, b):
    """a @ b as the f32 kernels compute it: each f32 operand split into
    big = TF32(x) and small = x - big (read as the tensor cores read it),
    and a_small b_big + a_big b_small + a_big b_big, each product exact
    (f64), the sum rounded once to f32."""
    ab, bb = _tf32_round(a), _tf32_round(b)
    as_, bs = _tf32_read(a - ab), _tf32_read(b - bb)
    return (as_.double() @ bb.double() + ab.double() @ bs.double()
            + ab.double() @ bb.double()).float()


def _matmul_tf32(a, b):
    """a @ b from the big halves alone: one TF32 product (what a kernel
    that dropped the small terms would compute)."""
    return (_tf32_round(a).double() @ _tf32_round(b).double()).float()


class _Products(torch.overrides.TorchFunctionMode):
    """Every f32 ``a @ b`` inside the block computed by ``matmul`` (the
    mode is off inside its own handler, so ``matmul`` runs plain torch)."""

    def __init__(self, matmul):
        super().__init__()
        self.matmul = matmul

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__) and \
                all(a.dtype == torch.float32 for a in args):
            return self.matmul(*args)
        return func(*args, **(kwargs or {}))


def _bwd_with_products(matmul, *args):
    """``flash_attention_bwd_plain(*args)`` with its products by ``matmul``."""
    with _Products(matmul):
        return flash_attention_bwd_plain(*args)


def test_tf32_split_is_exact_and_small():
    """big + small is x, big is a TF32 value (nearest, ties away from
    zero), and |small| is at most half a TF32 ulp of x."""
    x = torch.tensor([1.0, -1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      3.14159265, -2.718281828e-20, 6.5e30, 0.0], dtype=torch.float32)
    big = _tf32_round(x)
    assert torch.equal(big + (x - big), x)
    assert torch.equal(_tf32_read(big), big)
    # ties round away from zero, below half an ulp rounds down
    assert big[2].item() == 1.0 + 2.0 ** -10 and big[3].item() == -(1.0 + 2.0 ** -10)
    assert big[4].item() == 1.0
    assert bool(((x - big).abs() <= x.abs() * 2.0 ** -11).all())


@pytest.mark.parametrize("bh,t,d,bq,bk", [
    (2, 512, 128, 128, 32),   # flash_dq_kernel_tf32x3's tiles at d 128
    (1, 256, 256, 64, 16),    # flash_dq_kernel_wide_tf32x3's at 256
    (1, 256, 512, 32, 8),     # and at 512
])
def test_tf32x3_products_hold_the_f32_tolerance(rng, bh, t, d, bq, bk):
    """The precision argument of the f32 kernels on the CPU: the blocked
    backward with every product in emulated 3xTF32, at [2, 512, 128] f32
    causal (and [1, 256, 256], [1, 256, 512]) with q scaled so that the
    scores span about ±8, holds dq, dk and dv within 2e-5 of the JAX
    package's Pallas backward; from the big halves alone (one TF32
    product) it does not."""
    q, k, v, g = _arrays(rng, [(bh, t, d)] * 4)
    q = q * 1.8
    jq, jk, jv, jg = (_jax(a, "float32") for a in (q, k, v, g))
    jo, jl = _flash_fwd_impl(jq, jk, jv, True, 256, 256, interpret=True)
    want = [np.asarray(w) for w in _flash_bwd_impl(
        jq, jk, jv, jo, jl, jg, True, 256, 256, interpret=True)]
    args = (*(torch.tensor(a) for a in (q, k, v)), torch.tensor(np.asarray(jo)),
            torch.tensor(np.asarray(jl)), torch.tensor(g), True, bq, bk)
    span = (_prescale(args[0]) @ args[1].transpose(1, 2)).abs().max().item()
    assert 6.0 < span < 12.0
    got = _bwd_with_products(_matmul_tf32x3, *args)
    for a, w in zip(got, want):
        _close(a.numpy(), w, TOL["float32"])
    one = _bwd_with_products(_matmul_tf32, *args)
    assert max(np.abs(a.numpy() - w).max() for a, w in zip(one, want)) > 1e-4


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

def _bwd_kernel_names(dtype, d):
    """The two backward kernels a padded head of ``d`` runs in ``dtype``
    (as chip_smoke.bwd_kernel_names has them)."""
    if dtype == "bfloat16":
        suffix = "" if d <= 128 else "_wide"
    else:
        suffix = "_tf32x3" if d <= 128 else "_wide_tf32x3"
    return (f"flash_dq_kernel{suffix}<", f"flash_dkv_kernel{suffix}<")


def _assert_profiled(fn, names):
    """torch.profiler sees one call of ``fn`` run the two backward
    kernels ``names`` and no other flash backward kernel. A profile that
    kept none of them (the card's machine sometimes drops device events)
    is taken again with a wider idle margin around the call."""
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
        seen = {e.key for e in prof.key_averages() if e.self_device_time_total > 0
                and ("flash_dq_kernel" in e.key or "flash_dkv_kernel" in e.key)}
        if len(seen) == 2:
            break
    assert all(any(n in key for n in names) for key in seen), (seen, names)
    assert all(any(n in key for key in seen) for n in names), (seen, names)


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
        # f32: 3xTF32 products in another order; bf16: ds is rounded to
        # bf16 and summed in another order, so the bound scales with |ref|
        tol = 2e-5 if dtype == "float32" else 2e-2 * ref
        assert (a.float() - b.float()).abs().max().item() <= tol
    # the f32 heads run the 3xTF32 kernels, the bf16 heads the mma.sync ones
    _assert_profiled(lambda: flash_attention_bwd(q, k, v, o, lse, do, causal),
                     _bwd_kernel_names(dtype, d))


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
    _assert_profiled(lambda: flash_attention_bwd(q, k, v, o, lse, do, causal),
                     _bwd_kernel_names(dtype, d))


def _hard_f32_inputs(kind, bh, tq, tk, d, device):
    """f32 (q, k, v, dO) that a fault of the 3xTF32 kernels would show
    on: "scale4" draws them at scale 4 (scores of ±40 and more: p is
    peaked, so a wrong permutation of the depth index or a misread
    fragment moves whole rows); "fine" adds 1e-3 x randn to randn, so
    every value needs more than TF32's 10 mantissa bits (a kernel that
    dropped the small terms misses the f32 tolerance)."""
    g = torch.Generator(device=device).manual_seed(5)
    xs = [torch.randn(bh, t, d, generator=g, device=device) for t in (tq, tk, tk, tq)]
    if kind == "scale4":
        return [4.0 * x for x in xs]
    return [x + 1e-3 * torch.randn(x.shape, generator=g, device=device) for x in xs]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256, 512])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,tq,tk", [(4, 128, 128), (8, 72, 200)])
@pytest.mark.parametrize("kind", ["scale4", "fine"])
def test_tf32x3_kernels_hold_hard_f32_inputs_on_card(cuda_device, kind, d, causal,
                                                     bh, tq, tk):
    """The 3xTF32 kernels (the wide ones at 256 and 512) on inputs that a
    wrong depth permutation, a misread fragment or a dropped small term
    would fail. "fine": within
    the f32 tolerance 2e-5 of the plain backward, which the big halves
    alone (one TF32 product, emulated on the card through the same
    blocked backward) miss. "scale4": scores of ±40 and more carry f32
    roundings of their own in both versions, which p's exponential
    scales up (SCALE4_REL x max |ref|, against errors of 1e-3 x max |ref|
    and more from the faults)."""
    q, k, v, do = _hard_f32_inputs(kind, bh, tq, tk, d, cuda_device)
    o, lse = flash_attention_fwd(q, k, v, causal)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    one = _bwd_with_products(_matmul_tf32, q, k, v, o, lse, do, causal)
    errs, ones, refs = [], [], []
    for a, b, c in zip(got, want, one):
        assert bool(torch.isfinite(a).all())
        errs.append((a - b).abs().max().item())
        ones.append((c - b).abs().max().item())
        refs.append(b.abs().max().item())
    if kind == "fine":
        assert max(errs) <= 2e-5 < max(ones), (errs, ones)
    else:
        assert all(e <= SCALE4_REL * r < o for e, r, o in zip(errs, refs, ones)), \
            (errs, ones, refs)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [160, 256, 320, 512, 640, 1024])  # run at 256, 512, 1024
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,tq,tk", [
    (2, 72, 200),      # tq < tk: an offset with a ragged diagonal
    (8, 200, 200),     # ragged last q- and k-tiles
])
def test_wide_f32_backward_matches_plain_on_card(cuda_device, d, causal, bh, tq, tk):
    """The f32 heads of 129-1024 run flash_dq_kernel_wide_tf32x3 and
    flash_dkv_kernel_wide_tf32x3, one launch each per backward call,
    within 2e-5 of the plain f32 backward."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v, do = (torch.randn(bh, t, d, generator=g, device=cuda_device)
                   for t in (tq, tk, tk, tq))
    o, lse = flash_attention_fwd(q, k, v, causal)
    kernels.reset_launches()
    got = flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"flash_dq": 1, "flash_dkv": 1}
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.is_contiguous()
        assert bool(torch.isfinite(a).all())
        assert (a - b).abs().max().item() <= 2e-5
    assert _bwd_kernel_names("float32", d) == ("flash_dq_kernel_wide_tf32x3<",
                                               "flash_dkv_kernel_wide_tf32x3<")
    _assert_profiled(lambda: flash_attention_bwd(q, k, v, o, lse, do, causal),
                     _bwd_kernel_names("float32", d))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256, 512, 1024])
def test_wide_tf32x3_kernels_hold_the_reference_error_at_scale4_on_card(cuda_device, d):
    """C3 and C4 on the card: on the scale-4 arrays (scores of ±60 and
    more), the f32 backward's error from the f64 backward, after the
    port's f32 forward, is at most twice the JAX package's own f32 error
    (REF_SCALE4_REL) for each of dq, dk and dv: the 3xTF32 kernels at 64
    and 128, the wide ones at 256, 512 and 1024
    (flash_dq_kernel_wide_tf32x3<1024>, flash_dkv_kernel_wide_tf32x3<1024>,
    each score the sum of one chain over each quarter of the head), all of
    whose scores are the forward's own chains."""
    q, k, v, do = (torch.tensor(a, device=cuda_device)
                   for a in chip_smoke.scale4_arrays(np, d))
    ref = chip_smoke.bwd_f64(torch, q, k, v, do, True)
    o, lse = flash_attention_fwd(q, k, v, True)
    errs = chip_smoke.rel_errors(flash_attention_bwd(q, k, v, o, lse, do, True), ref)
    assert all(e <= 2 * r for e, r in zip(errs, REF_SCALE4_REL[d])), (errs, d)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256, 512, 1024])
def test_tf32x3_forward_holds_the_reference_error_at_scale4_on_card(cuda_device, d):
    """C4's forward on the card: on the scale-4 arrays the 3xTF32
    forward's o and lse, from the f64 forward, are within twice the JAX
    package's own f32 forward error (REF_SCALE4_FWD_REL)."""
    q, k, v, _ = (torch.tensor(a, device=cuda_device)
                  for a in chip_smoke.scale4_arrays(np, d))
    kernels.reset_launches()
    errs = chip_smoke.rel_errors(flash_attention_fwd(q, k, v, True),
                                 chip_smoke.fwd_f64(torch, q, k, v, True))
    assert dict(kernels.LAUNCHES) == {"flash_fwd": 1}
    assert all(e <= 2 * r for e, r in zip(errs, REF_SCALE4_FWD_REL[d])), (errs, d)


@pytest.mark.cuda
@pytest.mark.parametrize("block_q", [16, 32])
def test_f32_1024_forward_holds_the_reference_error_at_scale4_in_both_tilings_on_card(
        cuda_device, block_q):
    """C4 at 1024 in each tiling of the f32 forward (16 or 32 query rows a
    block; the scale-4 arrays' small grid takes 16): its o and lse within
    twice the JAX package's own forward error, and the wide 3xTF32
    backward after it within twice its backward error (the two take the
    same quarter chains, so s - lse cancels)."""
    q, k, v, do = (torch.tensor(a, device=cuda_device)
                   for a in chip_smoke.scale4_arrays(np, 1024))
    o, lse = _flash_fwd_cuda(q, k, v, True, block_q)
    fwd = chip_smoke.rel_errors((o, lse), chip_smoke.fwd_f64(torch, q, k, v, True))
    assert all(e <= 2 * r for e, r in zip(fwd, REF_SCALE4_FWD_REL[1024])), fwd
    bwd = chip_smoke.rel_errors(flash_attention_bwd(q, k, v, o, lse, do, True),
                                chip_smoke.bwd_f64(torch, q, k, v, do, True))
    assert all(e <= 2 * r for e, r in zip(bwd, REF_SCALE4_REL[1024])), bwd


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
@pytest.mark.parametrize("d", [160, 256, 320, 512, 640, 1024])  # run at 256, 512, 1024
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,tq,tk", [
    (8, 200, 200),     # ragged last q- and k-tiles
    (8, 72, 200),      # tq < tk: an offset with a ragged diagonal
    (1, 2048, 2048),   # one head: few blocks, a long loop
])
def test_wide_bf16_backward_matches_plain_on_card(cuda_device, d, causal, bh, tq, tk):
    """The bf16 heads of 129-1024 run flash_dq_kernel_wide and
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
    assert _bwd_kernel_names("bfloat16", d) == ("flash_dq_kernel_wide<",
                                                "flash_dkv_kernel_wide<")
    _assert_profiled(lambda: flash_attention_bwd(q, k, v, o, lse, do, causal),
                     _bwd_kernel_names("bfloat16", d))


@pytest.mark.cuda
@pytest.mark.parametrize("block_q", [0, 16, 32])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,tq,tk", [(8, 128, 320), (8, 200, 200), (8, 72, 200),
                                      (2, 1024, 1024)])
def test_bf16_1024_backward_matches_plain_in_both_tilings_on_card(cuda_device, causal, bh,
                                                                 tq, tk, block_q):
    """The bf16 head of 1024 runs flash_dq_kernel_wide in blocks of 16
    rows (eight warps on one row group, 16-key tiles) or 32 (two row
    groups of four warps, 8-key tiles, a row group's rows past tq or keys
    above its diagonal skipped), and the one the kernel picks (0), beside
    flash_dkv_kernel_wide: one launch each, within 2e-2 x max |ref| of
    the plain backward, at an offset, ragged tiles and full tiles."""
    g = torch.Generator(device=cuda_device).manual_seed(10)
    q, k, v, do = (torch.randn(bh, t, 1024, generator=g, device=cuda_device)
                   .to(torch.bfloat16) for t in (tq, tk, tk, tq))
    o, lse = flash_attention_fwd(q, k, v, causal)
    kernels.reset_launches()
    got = _flash_bwd_cuda(q, k, v, o, lse, do, causal, block_q)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"flash_dq": 1, "flash_dkv": 1}
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a.float()).all())
        ref = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= 2e-2 * ref
