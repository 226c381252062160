"""Flash attention forward: the hand-written CUDA kernel, its plain
PyTorch version, and the reference's dispatch rules.

Counterpart of ``deeplearning4j_tpu/ops/flash_attention.py``. The TPU
kernel ``_flash_fwd_impl`` -> ``_fwd_kernel`` becomes
``kernels/flash_fwd.cu`` (see its header for the Hopper design). Which
of the two runs is decided by the tensor's device alone: on the CPU the
plain version, on a CUDA device the kernel (a build or launch that
fails raises). Only the forward is ported; the backward kernels (dq,
dk/dv) are ROADMAP Queue B5, and until then a gradient through the
kernel raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.ops.attention import scaled_dot_product_attention

_NEG_INF = -1e30  # the reference's finite sentinel for masked scores
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL = "flash_fwd"


def _pick_block(t: int, preferred: int) -> int:
    for b in (preferred, 512, 256, 128, 64, 32, 16, 8):
        if b <= preferred and t % b == 0:
            return b
    return 0


def _prescale(q: torch.Tensor) -> torch.Tensor:
    """q * 1/sqrt(d), the scale rounded to q's dtype first (as the
    reference's weakly typed scalar is). The rounded scale is an exact
    Python float, so the product rounds as a same-dtype product would."""
    scale = torch.tensor(1.0 / q.shape[-1] ** 0.5, dtype=q.dtype).item()
    return q * scale


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool,
                              block_q: int = 64, block_k: int = 64
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's algorithm in torch ops: q, k, v [bh, t, d] ->
    (o [bh, tq, d] in q's dtype, lse [bh, tq, 1] f32). Blocked online
    softmax with f32 statistics and accumulator; the probabilities are
    rounded to v's dtype before the P.V product, as on the tensor cores;
    causal key blocks above the diagonal are skipped."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    offset = tk - tq
    q = _prescale(q)
    o = torch.empty_like(q)
    lse = torch.empty(bh, tq, 1, dtype=torch.float32, device=q.device)
    for q0 in range(0, tq, block_q):
        qb = q[:, q0:q0 + block_q].float()
        bq = qb.shape[1]
        rows = torch.arange(q0, q0 + bq, device=q.device)[:, None] + offset
        m = torch.full((bh, bq, 1), _NEG_INF, device=q.device)
        l = torch.zeros(bh, bq, 1, device=q.device)
        acc = torch.zeros(bh, bq, d, device=q.device)
        for k0 in range(0, tk, block_k):
            if causal and k0 > q0 + bq - 1 + offset:
                break  # this and every later key block is dead
            kb = k[:, k0:k0 + block_k].float()
            s = qb @ kb.transpose(1, 2)
            if causal:
                cols = torch.arange(k0, k0 + kb.shape[1], device=q.device)
                s = s.masked_fill(rows < cols[None, :], _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = corr * l + p.sum(dim=-1, keepdim=True)
            vb = v[:, k0:k0 + block_k]
            acc = acc * corr + p.to(vb.dtype).float() @ vb.float()
            m = m_new
        denom = l.clamp_min(1e-30)
        o[:, q0:q0 + bq] = (acc / denom).to(o.dtype)
        lse[:, q0:q0 + bq] = m + torch.log(denom)
    return o, lse


def _flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    bh, tq, d = q.shape
    tk = k.shape[1]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash kernel needs q, k and v of one dtype")
    if k.shape != (bh, tk, d) or v.shape != (bh, tk, d):
        raise ValueError(f"flash kernel shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash kernel needs q, k and v on one device")
    lib = kernels.load(KERNEL)
    lib.dl4j_flash_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    lib.dl4j_flash_fwd.restype = ctypes.c_int
    if not lib.dl4j_flash_fwd_supports(d):
        raise ValueError(f"flash kernel is built for head size 64 or 128, got {d}")
    q = _prescale(q).contiguous()
    k, v = k.contiguous(), v.contiguous()
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash kernel needs 16-byte aligned inputs")
    o = torch.empty_like(q)
    lse = torch.empty(bh, tq, 1, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dl4j_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), lse.data_ptr(), bh, tq, tk, d,
                                 int(bool(causal)), _DTYPE_CODES[q.dtype],
                                 stream)
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    kernels.LAUNCHES[KERNEL] += 1
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, block_q: int = 64, block_k: int = 64
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v [bh, t, d] -> (o, lse [bh, tq, 1]): the CUDA kernel for
    CUDA tensors, the plain version (with these blocks) for CPU ones.
    The kernel tiles by its own 64 x 64 blocks."""
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, block_q, block_k)
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        return flash_attention_fwd(q, k, v, causal, block_q, block_k)[0]

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the flash-attention backward kernels (dq, dk/dv) are not "
            "ported yet: ROADMAP Queue B5")


def flash_attention(
    q: torch.Tensor,  # [b, tq, h, d]
    k: torch.Tensor,  # [b, tk, h, d]
    v: torch.Tensor,  # [b, tk, h, d]
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Drop-in for ``scaled_dot_product_attention`` with the reference's
    dispatch rules: a key mask, a length that no block in
    (preferred, 512, ..., 8) divides, or causal with tq > tk takes the
    plain formulation; every other case runs the flash forward."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if block_q is None:
        block_q = 1024 if causal else 512
    if block_k is None:
        block_k = 1024
    bq = _pick_block(tq, block_q)
    bk = _pick_block(tk, block_k)
    if mask is not None or not bq or not bk or (causal and tq > tk):
        return scaled_dot_product_attention(q, k, v, causal=causal, mask=mask)

    def fold(z):
        return z.transpose(1, 2).reshape(b * h, z.shape[1], d)

    o = _FlashAttention.apply(fold(q), fold(k), fold(v), causal, bq, bk)
    return o.reshape(b, h, tq, d).transpose(1, 2)
