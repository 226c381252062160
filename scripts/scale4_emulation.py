#!/usr/bin/env python3
"""C3 and C4 on the CPU: why the f32 flash backward's error at scores of
±60 depends on how its scores are computed, by emulation (numpy, f64),
and what the f32 forward of the tensor cores gives there.

On ``chip_smoke.scale4_arrays`` (causal), each variant below computes
the backward's scores s and dP one way, takes lse from the scores of the
f32 forward (``flash_fwd_kernel_tf32x3``: one fma chain over the head in
order, at 1024 one over each quarter of it with the sums added in order,
``score_chain_cols`` in ``flash_common.cuh``, which the emulation
repeats), and the rest exactly; it prints each variant's error in dq, dk
and dv from the exact backward, relative to max |ref| (the measure of
``chip_smoke.phase_scale4`` and the card tests):

- ``forward_order``: the forward's own chains (what every f32 backward
  kernel computes);
- ``one_chain`` (at 1024 only, where the forward's order splits the
  head): one chain over the whole head, in the forward and the backward
  alike, with the forward below run on it (``one_chain_forward``);
- ``exact``: the exact scores, rounded once to f32;
- ``tensor_cores_K``: 3xTF32 on the tensor cores as mma.sync m16n8k8
  sums them (each product exact, each mma's sum truncated to f32), over
  chains of K columns from zero added with rounded adds: the head's
  whole width up to 128 (the first design of the kernels of heads <= 128),
  and halves and quarters of it.

Then the f32 forward as ``flash_fwd_kernel_tf32x3`` computes it: the
forward's scores, the online softmax over its key tiles in f32, and P V
in 3xTF32 (each 8-key mma.sync's sum truncated, each tile's sum in a
zeroed partial added to O with one rounded fma); it prints the
forward's errors in o and lse from the exact forward (``forward``), and
the errors of the backward in the forward's order that takes this
forward's lse and o (``after_forward``).

    python3 scripts/scale4_emulation.py

Runs on the CPU in seconds; imports nothing of JAX. The tensor cores'
truncation is a model: the card's figures (``flash_bwd_scale4`` lines of
``chip_smoke.py``) are the measurement.
"""

from __future__ import annotations

import importlib.util
import json
import os

import numpy as np


def _smoke():
    """This checkout's chip_smoke.py as a module."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tf32(x, rounded):
    """x as TF32: rounded to nearest (the big half) or truncated (as the
    tensor cores read the small half)."""
    i = x.astype(np.float32).view(np.int32)
    return (((i + 0x1000) if rounded else i) & -0x2000).view(np.float32)


def _truncate(x):
    """x (f64) to f32, rounded toward zero."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def fma_chain(a, b):
    """a b^T in f32, each entry one fma chain over the columns in order."""
    s = np.zeros((a.shape[0], a.shape[1], b.shape[1]), np.float32)
    for i in range(a.shape[-1]):
        s = (s + a[..., i, None].astype(np.float64) * b[:, None, :, i]).astype(np.float32)
    return s


def tensor_cores(a, b, chain):
    """a b^T in 3xTF32 (small terms first), 8 columns an mma, each mma's
    sum truncated, chains of ``chain`` columns from zero added in f32."""
    ab, bb = _tf32(a, True), _tf32(b, True)
    asm, bsm = _tf32(a - ab, False), _tf32(b - bb, False)
    out = np.zeros((a.shape[0], a.shape[1], b.shape[1]), np.float32)
    for c0 in range(0, a.shape[-1], chain):
        acc = np.zeros_like(out)
        for k in range(c0, c0 + chain, 8):
            for x, y in ((asm, bb), (ab, bsm), (ab, bb)):
                acc = _truncate(acc + np.einsum("bmk,bnk->bmn", x[..., k:k + 8].astype(np.float64),
                                                y[..., k:k + 8].astype(np.float64)))
        out = (out + acc).astype(np.float32)
    return out


# key tiles of flash_fwd_kernel_tf32x3 (FwdTf32Tiles::T) at each head, at
# 1024 in the 16-row blocks that the scale-4 arrays' small grid takes
FWD_TILE = {64: 64, 128: 32, 256: 32, 512: 32, 1024: 64}


def score_chain_cols(d):
    """The columns of one chain of a score at a head of ``d``
    (``score_chain_cols``, flash_common.cuh)."""
    return d if d < 1024 else 256


def forward_order(a, b):
    """a b^T in the f32 kernels' order: fma chains over
    ``score_chain_cols`` columns each, their sums added in column order."""
    cols = score_chain_cols(a.shape[-1])
    s = fma_chain(a[..., :cols], b[..., :cols])
    for c0 in range(cols, a.shape[-1], cols):
        s = (s + fma_chain(a[..., c0:c0 + cols], b[..., c0:c0 + cols])).astype(np.float32)
    return s


def _dead(t):
    """The causal mask's dead (row, key) pairs."""
    return np.arange(t)[:, None] < np.arange(t)[None]


def forward(s, v, tile):
    """(o, lse [bh, t, 1]) in f32 from the f32 scores s (causal) as the
    3xTF32 forward takes them: per key tile the online softmax in f32
    (masked scores at -1e30), P V in 3xTF32 into a zeroed partial, O =
    O corr + partial rounded once, then o = O / l and lse = m + log l."""
    bh, t, _ = s.shape
    s = np.where(_dead(t), np.float32(-1e30), s).astype(np.float32)
    m = np.full((bh, t, 1), -1e30, np.float32)
    l = np.zeros((bh, t, 1), np.float32)
    acc = np.zeros((bh, t, v.shape[-1]), np.float32)
    for k0 in range(0, t, tile):
        st = s[..., k0:k0 + tile]
        m_new = np.maximum(m, st.max(-1, keepdims=True))
        corr = np.exp(m - m_new)
        p = np.exp(st - m_new)
        l = (corr * l + p.sum(-1, keepdims=True, dtype=np.float32)).astype(np.float32)
        part = tensor_cores(p, v[:, k0:k0 + tile].transpose(0, 2, 1), tile)
        acc = (acc.astype(np.float64) * corr + part).astype(np.float32)
        m = m_new
    denom = np.maximum(l, np.float32(1e-30))
    return acc / denom, (m + np.log(denom)).astype(np.float32)


def backward(qs, k, v, do, s_fwd, s, dp, fwd=None):
    """(dq / scale, dk, dv) exactly from the scores s and dP, with lse
    and delta from the forward's scores s_fwd (causal), or from ``fwd``,
    a forward's (o, lse)."""
    t = s.shape[1]
    dead = _dead(t)
    sf, sb = (np.where(dead, -np.inf, x.astype(np.float64)) for x in (s_fwd, s))
    m = sf.max(-1, keepdims=True)
    lse = m + np.log(np.exp(sf - m).sum(-1, keepdims=True))
    delta = (do * (np.exp(sf - lse) @ v)).sum(-1, keepdims=True)
    if fwd is not None:
        o, lse = (x.astype(np.float64) for x in fwd)
        delta = (do * o).sum(-1, keepdims=True)
    p = np.exp(sb - lse)
    ds = p * (dp - delta)
    return ds @ k, ds.transpose(0, 2, 1) @ qs, p.transpose(0, 2, 1) @ do


def _rel(got, ref):
    """max |got - ref| / max |ref| of each output."""
    return [float(np.abs(a - r).max() / np.abs(r).max()) for a, r in zip(got, ref)]


def main() -> int:
    smoke = _smoke()
    for d in smoke.SCALE4_HEADS:
        q, k, v, do = smoke.scale4_arrays(np, d)
        qs = (q * np.float32(1.0 / d ** 0.5)).astype(np.float32)
        q64, k64, v64, do64 = (x.astype(np.float64) for x in (qs, k, v, do))
        s64, dp64 = q64 @ k64.transpose(0, 2, 1), do64 @ v64.transpose(0, 2, 1)
        ref = backward(q64, k64, v64, do64, s64, s64, dp64)
        s_fwd = forward_order(qs, k)
        variants = {"forward_order": (s_fwd, fma_chain(do, v)),
                    "exact": (s64.astype(np.float32), dp64.astype(np.float32))}
        width = min(d, 128)  # a warp's columns: the whole head up to 128
        for chain in (width, width // 2, width // 4):
            # each warp's columns summed in f32, as the wide kernels sum them
            s, dp = (sum(tensor_cores(a[..., w:w + width], b[..., w:w + width], chain)
                         for w in range(0, d, width)) for a, b in ((qs, k), (do, v)))
            variants[f"tensor_cores_{chain}"] = (s, dp)
        errs = {}
        for name, (s, dp) in variants.items():
            got = backward(q64, k64, v64, do64, s_fwd, s, dp)
            errs[name] = _rel(got, ref)
        if score_chain_cols(d) < d:
            s_one = fma_chain(qs, k)
            errs["one_chain"] = _rel(backward(q64, k64, v64, do64, s_one, s_one,
                                              fma_chain(do, v)), ref)
        # the 3xTF32 forward, against the exact forward, and the backward
        # in the forward's order after it
        dead = _dead(q.shape[1])
        s_ref = np.where(dead, -np.inf, s64)
        lse_ref = np.log(np.exp(s_ref - s_ref.max(-1, keepdims=True)).sum(-1, keepdims=True)) \
            + s_ref.max(-1, keepdims=True)
        fwd = forward(s_fwd, v, FWD_TILE[d])
        errs["forward"] = _rel(fwd, (np.exp(s_ref - lse_ref) @ v64, lse_ref))
        if score_chain_cols(d) < d:
            errs["one_chain_forward"] = _rel(forward(s_one, v, FWD_TILE[d]),
                                             (np.exp(s_ref - lse_ref) @ v64, lse_ref))
        errs["after_forward"] = _rel(backward(q64, k64, v64, do64, s_fwd, s_fwd,
                                              fma_chain(do, v), fwd), ref)
        print("scale4_emulation " + json.dumps(dict(d=d, errors=errs)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
