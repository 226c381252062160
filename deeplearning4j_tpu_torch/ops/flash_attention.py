"""Flash attention, forward and backward: the hand-written CUDA kernels,
their plain PyTorch versions, and the reference's dispatch rules.

Counterpart of ``deeplearning4j_tpu/ops/flash_attention.py``. The TPU
kernels become CUDA kernels: ``_flash_fwd_impl`` -> ``_fwd_kernel`` is
``kernels/flash_fwd.cu``; ``_flash_bwd_impl`` -> ``_dq_kernel`` and
``_dkv_kernel`` are ``flash_dq`` and ``flash_dkv`` in
``kernels/flash_bwd.cu`` (see each file's header for its Hopper design).
Which of the two runs is decided by the tensor's device alone: on the
CPU the plain version, on a CUDA device the kernel (a build or launch
that fails raises). The kernels are built for head sizes 64, 128, 256
and 512; a smaller head runs zero-padded to the next of them, a larger
one raises on the card (the CPU's plain versions take any head size).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.ops.attention import scaled_dot_product_attention

_NEG_INF = -1e30  # the reference's finite sentinel for masked scores
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL = "flash_fwd"  # the forward's kernel and source name
BWD_SOURCE = "flash_bwd"  # kernels/flash_bwd.cu: the two backward kernels
DQ_KERNEL = "flash_dq"
DKV_KERNEL = "flash_dkv"


def _pick_block(t: int, preferred: int) -> int:
    for b in (preferred, 512, 256, 128, 64, 32, 16, 8):
        if b <= preferred and t % b == 0:
            return b
    return 0


def _scale(q: torch.Tensor) -> float:
    """1/sqrt(d) rounded to q's dtype (as the reference's weakly typed
    scalar is), as an exact Python float."""
    return torch.tensor(1.0 / q.shape[-1] ** 0.5, dtype=q.dtype).item()


def _head_width(d: int) -> int:
    """The head size the kernels run a head of ``d`` at: 64, 128, 256 or
    512, the sizes they are built for (the bf16 heads of 64 and 128 on
    the tensor cores, the rest on the CUDA cores). A smaller head is
    padded with zeros up to it, which adds 0 to every score and product,
    so the unpadded columns of every output are the same; the scales stay
    those of ``d``."""
    for width in (64, 128, 256, 512):
        if d <= width:
            return width
    raise ValueError(f"flash kernels take head sizes up to 512, got {d}")


def _pad_head(x: torch.Tensor, width: int) -> torch.Tensor:
    """x [.., d] contiguous, zero-padded to [.., width]."""
    d = x.shape[-1]
    return x.contiguous() if d == width else F.pad(x, (0, width - d))


def _prescale(q: torch.Tensor) -> torch.Tensor:
    """q * 1/sqrt(d) with the scale of :func:`_scale`: the product rounds
    as a same-dtype product would (the plain versions' pre-scale; every
    kernel does this itself as it loads q)."""
    return q * _scale(q)


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


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
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


def _flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, block_q: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel on the unscaled q (it scales q as it
    loads it), at the head width of :func:`_head_width`. ``block_q``:
    the bf16 tensor-core kernel's query rows per block (heads of 64 and
    128), 64 or 128 (for measurements only), or 0: the kernel chooses by
    tq and the size of the grid."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    _check_inputs(q, k, v)
    width, scale = _head_width(d), _scale(q)
    lib = kernels.load(KERNEL)
    lib.dl4j_flash_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.dl4j_flash_fwd.restype = ctypes.c_int
    q, k, v = (_pad_head(x, width) for x in (q, k, v))
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash kernel needs 16-byte aligned inputs")
    o = torch.empty_like(q)
    lse = torch.empty(bh, tq, 1, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dl4j_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), lse.data_ptr(), bh, tq, tk,
                                 width, int(bool(causal)),
                                 _DTYPE_CODES[q.dtype], scale, block_q, stream)
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    kernels.LAUNCHES[KERNEL] += 1
    return (o if width == d else o[..., :d].contiguous()), lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, block_q: int = 64, block_k: int = 64
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v [bh, t, d] -> (o, lse [bh, tq, 1]): the CUDA kernel for
    CUDA tensors, the plain version (with these blocks) for CPU ones.
    The kernel tiles by its own blocks (64 keys; 64 or 128 queries)."""
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, block_q, block_k)
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


def _bwd_block(t: int, block: int) -> int:
    """The reference's backward block rule (``_flash_bwd``): cap at 512;
    where no candidate <= 512 divides ``t``, keep the forward block
    (it ran, so it divides ``t``)."""
    return _pick_block(t, min(block, 512)) or block


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool, block_q: int = 64,
                              block_k: int = 64
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' algorithm in torch ops: (q, k, v, o, lse,
    dO) -> (dq, dk, dv) in the dtypes of q, k, v. q is pre-scaled once,
    ``delta = rowsum(dO * O)`` is f32, and the probabilities are rebuilt
    blockwise from (q, k, lse): a dq pass with the keys innermost and a
    dk/dv pass with the queries innermost, causal key blocks above the
    diagonal skipped, masked scores at the -1e30 sentinel. ``p`` and
    ``ds`` are rounded to the operand dtype before their products (as
    on the tensor cores); dq takes the scale at the end."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    offset = tk - tq
    scale = 1.0 / d ** 0.5
    qs = _prescale(q)
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)  # [bh, tq, 1]
    lse = lse.reshape(bh, tq, 1)
    dev = q.device

    def scores(q0, qb, k0, kb):
        """s = qs kᵀ for one block, causal entries at the sentinel."""
        s = qb @ kb.transpose(1, 2)
        if causal:
            rows = torch.arange(q0, q0 + qb.shape[1], device=dev)[:, None]
            cols = torch.arange(k0, k0 + kb.shape[1], device=dev)
            s = s.masked_fill(rows + offset < cols[None, :], _NEG_INF)
        return s

    def dead(q0, bq, k0):
        return causal and k0 > q0 + bq - 1 + offset

    def block(q0, k0, bq, bk):
        qb = qs[:, q0:q0 + bq].float()
        kb = k[:, k0:k0 + bk].float()
        dob = do[:, q0:q0 + bq].float()
        p = torch.exp(scores(q0, qb, k0, kb) - lse[:, q0:q0 + bq])
        dp = dob @ v[:, k0:k0 + bk].float().transpose(1, 2)
        ds = (p * (dp - delta[:, q0:q0 + bq])).to(q.dtype).float()
        return qb, kb, dob, p, ds

    dq = torch.empty_like(q)
    for q0 in range(0, tq, block_q):
        bq = min(block_q, tq - q0)
        acc = torch.zeros(bh, bq, d, device=dev)
        for k0 in range(0, tk, block_k):
            if dead(q0, bq, k0):
                break  # this and every later key block is dead
            _, kb, _, _, ds = block(q0, k0, bq, block_k)
            acc = acc + ds @ kb
        dq[:, q0:q0 + bq] = (acc * scale).to(q.dtype)

    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for k0 in range(0, tk, block_k):
        bk = min(block_k, tk - k0)
        dk_acc = torch.zeros(bh, bk, d, device=dev)
        dv_acc = torch.zeros(bh, bk, d, device=dev)
        for q0 in range(0, tq, block_q):
            if dead(q0, min(block_q, tq - q0), k0):
                continue
            qb, _, dob, p, ds = block(q0, k0, block_q, bk)
            dv_acc = dv_acc + p.to(v.dtype).float().transpose(1, 2) @ dob
            dk_acc = dk_acc + ds.transpose(1, 2) @ qb
        dk[:, k0:k0 + bk] = dk_acc.to(k.dtype)
        dv[:, k0:k0 + bk] = dv_acc.to(v.dtype)
    return dq, dk, dv


def _flash_bwd_cuda(q, k, v, o, lse, do, causal
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of each backward kernel on the unscaled q (each scales
    q by :func:`_scale` as it loads it; ``flash_dq`` also takes the f32
    1/sqrt(d) that multiplies its sum), at the head width of
    :func:`_head_width`. ``flash_dq`` computes delta = rowsum(dO * O) in
    f32 and writes it for ``flash_dkv``, which runs after it on the same
    stream."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    _check_inputs(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or lse.numel() != bh * tq:
        raise ValueError(f"flash backward shapes o {tuple(o.shape)}, "
                         f"dO {tuple(do.shape)}, lse {tuple(lse.shape)} "
                         f"for q {tuple(q.shape)}")
    width, q_scale = _head_width(d), _scale(q)
    lib = kernels.load(BWD_SOURCE)
    lib.dl4j_flash_dq.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
        + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    lib.dl4j_flash_dq.restype = ctypes.c_int
    lib.dl4j_flash_dkv.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
        + [ctypes.c_float, ctypes.c_void_p]
    lib.dl4j_flash_dkv.restype = ctypes.c_int
    dt = q.dtype
    q, k, v, o, do = (_pad_head(x.to(dt), width) for x in (q, k, v, o, do))
    lse = lse.reshape(bh, tq).float().contiguous()
    for t in (q, k, v, o, do):
        if t.data_ptr() % 16:
            raise ValueError("flash kernels need 16-byte aligned inputs")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(bh, tq, dtype=torch.float32, device=q.device)
    dtype = _DTYPE_CODES[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dl4j_flash_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                delta.data_ptr(), dq.data_ptr(), bh, tq, tk,
                                width, int(bool(causal)), dtype, q_scale,
                                1.0 / d ** 0.5, stream)
        if err:
            raise RuntimeError(f"flash_dq kernel launch failed: CUDA error {err}")
        kernels.LAUNCHES[DQ_KERNEL] += 1
        err = lib.dl4j_flash_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 do.data_ptr(), lse.data_ptr(),
                                 delta.data_ptr(), dk.data_ptr(),
                                 dv.data_ptr(), bh, tq, tk, width,
                                 int(bool(causal)), dtype, q_scale, stream)
        if err:
            raise RuntimeError(f"flash_dkv kernel launch failed: CUDA error {err}")
        kernels.LAUNCHES[DKV_KERNEL] += 1
    if width != d:
        dq, dk, dv = (x[..., :d].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool,
                        block_q: int = 64, block_k: int = 64
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): the two CUDA kernels for CUDA tensors, the plain
    version (with these blocks) for CPU ones. The kernels tile by their
    own 64 x 64 blocks."""
    if q.device.type == "cuda":
        return _flash_bwd_cuda(q, k, v, o, lse, do, causal)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                         block_q, block_k)
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward saves (q, k, v, o,
    lse); the backward takes its blocks by ``_bwd_block``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        o, lse = flash_attention_fwd(q, k, v, causal, block_q, block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.blocks = (_bwd_block(q.shape[1], block_q),
                      _bwd_block(k.shape[1], block_k))
        return o

    @staticmethod
    def backward(ctx, grad):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, grad, ctx.causal,
                                         *ctx.blocks)
        return dq, dk, dv, None, None, None


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
    plain formulation; every other case runs the flash forward (on the
    card a head wider than the kernels' 512 raises)."""
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
