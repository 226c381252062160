"""Fused Graves-LSTM scan: the hand-written CUDA kernels, their plain
PyTorch versions, and the reference's dispatch gates.

Counterpart of ``deeplearning4j_tpu/ops/lstm_kernel.py``. Its three TPU
kernels become CUDA kernels (see each source's header for its Hopper
design):

- ``_fwd_pallas(with_residuals=True)`` -> ``_fwd_kernel`` is
  ``lstm_fwd`` in ``kernels/lstm_fwd.cu``: h and the residuals i, f, o,
  blk, c for the backward;
- ``_fwd_only_kernel`` is ``lstm_fwd_only`` in the same source: h, h_T
  and c_T, no residual streams;
- ``_bwd_pallas`` -> ``_bwd_kernel`` is two kernels in
  ``kernels/lstm_bwd.cu``: ``lstm_bwd``, the reverse-time sweep (the
  gate chain and the dh recurrence), and ``lstm_dw``, the weight and
  peephole gradients.

Which version runs is decided by the tensor's device alone: on the CPU
the plain version, on a CUDA device the kernel (a shape the kernel does
not take, or a build or launch that fails, raises). The reference's
precision contract holds in both: gate math in f32 with the recurrent
product accumulated in f32, the h carry rounded to the stream dtype every
step and the c carry in f32; in the backward, dg rounded to Wr's dtype
before both products, h_prev rebuilt from the rounded residuals, dWr
and the peephole sums in f32. The reference's environment seams
(``DL4J_TPU_LSTM_TRAIN``, ``DL4J_TPU_LSTM_BWD``,
``DL4J_TPU_LSTM_BWD_BLOCK``) are not ported: on the card they could only
route around the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch import kernels

FWD_SOURCE = "lstm_fwd"      # kernels/lstm_fwd.cu: both forward kernels
BWD_SOURCE = "lstm_bwd"      # kernels/lstm_bwd.cu: the sweep and the weights
FWD_KERNEL = "lstm_fwd"      # forward with residuals (training)
FWD_ONLY_KERNEL = "lstm_fwd_only"
TIMED_KERNEL = "lstm_fwd_timed"  # lstm_fwd's bf16 kernel with its step timer
BWD_KERNEL = "lstm_bwd"
BWD_TIMED_KERNEL = "lstm_bwd_timed"  # lstm_bwd's bf16 sweep, timed
DW_KERNEL = "lstm_dw"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

Residuals = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                  torch.Tensor]


# ------------------------------------------------------------ plain versions

def _cell(xg_t, h, c, wr, wci, wcf, wco, n: int):
    """One Graves step in f32 (the reference's ``_cell``): ``h`` in the
    stream dtype, ``c`` f32, peepholes f32. Returns (i, f, o, blk, c_new,
    h_new), all f32."""
    g = xg_t.float() + h.float() @ wr.float()
    i = torch.sigmoid(g[:, :n] + c * wci)
    f = torch.sigmoid(g[:, n:2 * n] + c * wcf)
    blk = torch.tanh(g[:, 3 * n:])
    c_new = f * c + i * blk
    o = torch.sigmoid(g[:, 2 * n:3 * n] + c_new * wco)
    return i, f, o, blk, c_new, o * torch.tanh(c_new)


def lstm_fwd_plain(xg, wr, wci, wcf, wco, h0, c0, with_residuals: bool = True):
    """The forward kernels' algorithm in torch ops: xg [t, b, 4n] ->
    with residuals ``(h_seq, (i, f, o, blk, c))``, all [t, b, n] in xg's
    dtype; else ``(h_seq, (h_T, c_T))`` with h_T in xg's dtype and c_T
    f32."""
    t, _, g4 = xg.shape
    n = g4 // 4
    dt = xg.dtype
    wci, wcf, wco = wci.float(), wcf.float(), wco.float()
    h, c = h0.to(dt), c0.float()
    hs, res = [], []
    for s in range(t):
        i, f, o, blk, c, h_new = _cell(xg[s], h, c, wr, wci, wcf, wco, n)
        h = h_new.to(dt)
        hs.append(h)
        if with_residuals:
            res.append(tuple(z.to(dt) for z in (i, f, o, blk, c)))
    h_seq = torch.stack(hs)
    if with_residuals:
        return h_seq, tuple(torch.stack(z) for z in zip(*res))
    return h_seq, (h, c)


def _bptt_gates(i_t, f_t, o_t, blk_t, c_prev, th, dh, dc_carry, wci, wcf, wco):
    """One reverse Graves step's gate-derivative chain (the reference's
    ``_bptt_gates``), all f32. Returns (da_i, da_f, da_o, da_g, dc_next)."""
    do = dh * th
    da_o = do * o_t * (1.0 - o_t)
    dc = dh * o_t * (1.0 - th * th) + dc_carry + da_o * wco
    da_g = dc * i_t * (1.0 - blk_t * blk_t)
    da_i = dc * blk_t * i_t * (1.0 - i_t)
    da_f = dc * c_prev * f_t * (1.0 - f_t)
    dc_next = dc * f_t + da_i * wci + da_f * wcf
    return da_i, da_f, da_o, da_g, dc_next


def lstm_bwd_plain(res: Residuals, wr, wci, wcf, wco, h0, c0, gout, g_clast):
    """The backward kernels' algorithm in torch ops (the reference's
    ``_bwd_from_residuals``, at the TPU kernel's rounding points): the
    reverse scan of ``_bptt_gates`` over the residuals, then the
    hoisted reductions. ``gout`` [t, b, n] (the residual dtype) is
    dL/dh_seq with dL/dh_T folded into its last step; ``g_clast`` [b, n]
    starts the dc carry. Returns (dg [t, b, 4n] in the residual dtype,
    dWr [n, 4n] f32, dwci, dwcf, dwco [n] f32, dh0, dc0 [b, n] f32)."""
    i, f, o, blk, c = (r.float() for r in res)
    t, b, n = i.shape
    wdt = wr.dtype
    wrf = wr.float()
    wci, wcf, wco = wci.float(), wcf.float(), wco.float()
    c_prev = torch.cat([c0.float()[None], c[:-1]])
    tanh_c = torch.tanh(c)
    dh_rec = torch.zeros(b, n, dtype=torch.float32, device=i.device)
    dc = g_clast.float()
    dgs = [None] * t
    for s in reversed(range(t)):
        da_i, da_f, da_o, da_g, dc = _bptt_gates(
            i[s], f[s], o[s], blk[s], c_prev[s], tanh_c[s],
            gout[s].float() + dh_rec, dc, wci, wcf, wco)
        dgs[s] = torch.cat([da_i, da_f, da_o, da_g], dim=-1)
        # the dh recurrence on dg rounded to Wr's dtype, f32 sums
        dh_rec = dgs[s].to(wdt).float() @ wrf.t()
    dg32 = torch.stack(dgs)
    # h_{t-1} = o_{t-1} tanh(c_{t-1}) from the rounded residuals, h0 at 0
    h_prev = torch.cat([h0.float()[None], (o * tanh_c)[:-1]])
    dwr = torch.einsum("tbn,tbg->ng", h_prev.to(wdt).float(),
                       dg32.to(wdt).float())
    dwci = (dg32[..., :n] * c_prev).sum(dim=(0, 1))
    dwcf = (dg32[..., n:2 * n] * c_prev).sum(dim=(0, 1))
    dwco = (dg32[..., 2 * n:3 * n] * c).sum(dim=(0, 1))
    return dg32.to(res[0].dtype), dwr, dwci, dwcf, dwco, dh_rec, dc


# ------------------------------------------------------------ CUDA kernels

_BATCH_BLOCKS = (16, 32, 64, 128)  # batch rows a block may own


def _block_shape(b: int, n: int, itemsize: int, sms: int) -> Tuple[int, int, int]:
    """(BB, U, bp): the batch rows and hidden units one block owns, and
    the batch padded to a multiple of BB. U keeps Wr's slice for the
    block's units at about 128 KB of shared memory (n 4U elements); a
    grid that would fill under half of the card's ``sms`` SMs takes
    narrower slices (down to 16 units in bf16, the tensor-core tile, and
    4 in f32), so that small batches spread over more SMs."""
    u = min(32, (16384 if itemsize == 2 else 8192) // n)
    bb = next(c for c in _BATCH_BLOCKS if c >= min(b, 128))
    bp = -(-b // bb) * bb
    u_min = 16 if itemsize == 2 else 4
    while u > u_min and (bp // bb) * (n // u) * 2 <= sms:
        u //= 2
    return bb, u, bp


def _grid_fits(b: int, n: int, itemsize: int, sms: int) -> bool:
    """The Hopper kernels' own limits: 64 <= n <= 1024 with n % 64 == 0
    (64-deep product chunks and the f32 lstm_dw's 64 x 64 dWr tiles; U
    >= 16 for the bf16 tensor-core tiles), and a persistent grid of
    (bp / BB) x (n / U) blocks that fits a card of ``sms`` SMs at one
    block per SM (each
    takes ~128 KB of shared memory), since the blocks of a batch group
    wait for each other every step."""
    if itemsize not in (2, 4) or n % 64 or not 64 <= n <= 1024 or b < 1:
        return False
    bb, u, bp = _block_shape(b, n, itemsize, sms)
    return (bp // bb) * (n // u) <= sms


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _kernel_takes(b: int, n: int, itemsize: int, device: torch.device) -> bool:
    return _grid_fits(b, n, itemsize, _sm_count(device))


def _lib(source: str) -> ctypes.CDLL:
    lib = kernels.load(source)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if source == FWD_SOURCE:
        lib.dl4j_lstm_fwd.argtypes = [ptr] * 14 + [i32] * 6 + [ptr]
        lib.dl4j_lstm_fwd_only.argtypes = [ptr] * 11 + [i32] * 6 + [ptr]
        lib.dl4j_lstm_fwd_timed.argtypes = [ptr] * 15 + [i32] * 6 + [ptr]
        lib.dl4j_lstm_fwd.restype = lib.dl4j_lstm_fwd_only.restype = i32
        lib.dl4j_lstm_fwd_timed.restype = i32
    else:
        lib.dl4j_lstm_bwd.argtypes = [ptr] * 19 + [i32] * 6 + [ptr]
        lib.dl4j_lstm_bwd_timed.argtypes = [ptr] * 20 + [i32] * 6 + [ptr]
        lib.dl4j_lstm_dw.argtypes = [ptr] * 9 + [i32] * 5 + [ptr]
        lib.dl4j_lstm_bwd.restype = lib.dl4j_lstm_dw.restype = i32
        lib.dl4j_lstm_bwd_timed.restype = i32
    return lib


_DW_TILE = (128, 256)  # the bf16 lstm_dw's tile of dWr: units x gate columns


def _dw_tiles(n: int) -> int:
    return -(-n // _DW_TILE[0]) * (4 * n // _DW_TILE[1])


_DW_MAX_SPLITS = 8  # the last split of a tile sums the others' partials alone
_DW_MIN_CHUNKS = 8  # 64-row chunks a split walks, at least


def _dw_splits(m: int, n: int, itemsize: int, sms: int) -> int:
    """The ranges of the m = t * bp rows the bf16 ``lstm_dw`` splits its
    sum into: as many as keep its grid (tiles x splits) within one wave
    of the card's ``sms`` SMs (n 512: 32 tiles, 4 splits), at most
    ``_DW_MAX_SPLITS`` (n 128: 2 tiles, 8 splits rather than 66, whose
    one summing block took ~0.3 ms) and none shorter than
    ``_DW_MIN_CHUNKS`` chunks (b 8, t 9, n 128: 1 split rather than 3 of
    one chunk, which took 0.045 ms against 0.0055 before the split); 1
    for f32, whose grid is its tiles alone."""
    if itemsize != 2:
        return 1
    chunks = -(-m // 64)
    return max(1, min(sms // _dw_tiles(n), chunks // _DW_MIN_CHUNKS,
                      _DW_MAX_SPLITS))


def _pad(z: torch.Tensor, bp: int, dim: int, dtype=None) -> torch.Tensor:
    """``z`` in ``dtype``, contiguous, its batch dim zero-padded to bp."""
    z = z.to(dtype) if dtype is not None else z
    b = z.shape[dim]
    if b != bp:
        shape = list(z.shape)
        shape[dim] = bp
        out = torch.zeros(shape, dtype=z.dtype, device=z.device)
        out.narrow(dim, 0, b).copy_(z)
        z = out
    return z.contiguous()


def _check(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _check_shapes(xg_like: torch.Tensor, wr, peepholes, carries, n: int) -> None:
    dt = xg_like.dtype
    if dt not in _DTYPE_CODES:
        raise TypeError(f"LSTM kernels take float32 or bfloat16, got {dt}")
    if wr.dtype != dt:
        raise TypeError(f"LSTM kernels need Wr in the stream dtype {dt}, "
                        f"got {wr.dtype}")
    if tuple(wr.shape) != (n, 4 * n) or any(tuple(w.shape) != (n,)
                                            for w in peepholes):
        raise ValueError(f"LSTM kernel shapes: Wr {tuple(wr.shape)}, "
                         f"peepholes {[tuple(w.shape) for w in peepholes]} "
                         f"for n {n}")
    b = xg_like.shape[1]
    if any(tuple(z.shape) != (b, n) for z in carries):
        raise ValueError(f"LSTM kernel carries {[tuple(z.shape) for z in carries]}"
                         f", expected ({b}, {n})")
    tensors = (xg_like, wr, *peepholes, *carries)
    if any(z.device != xg_like.device for z in tensors):
        raise ValueError("LSTM kernels need every input on one device")
    if not _kernel_takes(b, n, xg_like.element_size(), xg_like.device):
        raise ValueError(f"the LSTM kernels do not take b {b}, n {n} in {dt} "
                         "(see fused_lstm_applicable)")


def _check_aligned(*tensors: torch.Tensor) -> None:
    """The kernels move 16-byte pieces: every input must start on a
    16-byte boundary (a view into a larger tensor may not)."""
    if any(z.data_ptr() % 16 for z in tensors):
        raise ValueError("LSTM kernels need 16-byte aligned inputs")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _lstm_fwd_cuda(xg, wr, wci, wcf, wco, h0, c0, with_residuals: bool,
                   timed: bool = False):
    """The forward kernels on CUDA tensors; ``timed`` (with residuals,
    bf16) launches the timed instantiation and also returns its stamps."""
    t, b, g4 = xg.shape
    n = g4 // 4
    _check_shapes(xg, wr, (wci, wcf, wco), (h0, c0), n)
    dt = xg.dtype
    bb, u, bp = _block_shape(b, n, xg.element_size(), _sm_count(xg.device))
    lib = _lib(FWD_SOURCE)
    xg_p = _pad(xg, bp, 1)
    h0_p, c0_p = _pad(h0, bp, 0, dt), _pad(c0, bp, 0, torch.float32)
    wr = wr.contiguous()
    wci, wcf, wco = (w.float().contiguous() for w in (wci, wcf, wco))
    _check_aligned(xg_p, wr, h0_p, c0_p)
    dev = xg.device
    h_seq = torch.empty(t, bp, n, dtype=dt, device=dev)
    counter = (torch.zeros(bp // bb, dtype=torch.int32, device=dev)
               if t > 1 else None)
    cptr = None if counter is None else counter.data_ptr()
    ins = [z.data_ptr() for z in (xg_p, wr, wci, wcf, wco, h0_p, c0_p)]
    dims = [t, bp, n, bb, u, _DTYPE_CODES[dt]]
    with torch.cuda.device(dev):
        if with_residuals:
            res = [torch.empty(t, bp, n, dtype=dt, device=dev) for _ in range(5)]
            ptrs = [*ins, h_seq.data_ptr(), *[r.data_ptr() for r in res], cptr]
            if timed:
                stamps = torch.zeros((bp // bb) * (n // u), t, 4,
                                     dtype=torch.int64, device=dev)
                name = TIMED_KERNEL
                err = lib.dl4j_lstm_fwd_timed(*ptrs, stamps.data_ptr(), *dims,
                                              _stream(dev))
            else:
                name = FWD_KERNEL
                err = lib.dl4j_lstm_fwd(*ptrs, *dims, _stream(dev))
            _check(name, err)
            kernels.LAUNCHES[name] += 1
            out = (h_seq[:, :b], tuple(r[:, :b] for r in res))
            return out + (stamps,) if timed else out
        h_t = torch.empty(bp, n, dtype=dt, device=dev)
        c_t = torch.empty(bp, n, dtype=torch.float32, device=dev)
        err = lib.dl4j_lstm_fwd_only(*ins, h_seq.data_ptr(), h_t.data_ptr(),
                                     c_t.data_ptr(), cptr, *dims, _stream(dev))
        _check(FWD_ONLY_KERNEL, err)
        kernels.LAUNCHES[FWD_ONLY_KERNEL] += 1
        return h_seq[:, :b], (h_t[:b], c_t[:b])


def _lstm_bwd_cuda(res: Residuals, wr, wci, wcf, wco, h0, c0, gout, g_clast,
                   timed: bool = False):
    """The backward kernels on CUDA tensors; ``timed`` (bf16) launches the
    sweep's timed instantiation and also returns its stamps."""
    t, b, n = res[0].shape
    dt = res[0].dtype
    _check_shapes(gout, wr, (wci, wcf, wco), (h0, c0, g_clast), n)
    if any(r.dtype != dt or tuple(r.shape) != (t, b, n) for r in (*res, gout)):
        raise ValueError("LSTM backward needs five residuals and gout of one "
                         f"shape ({t}, {b}, {n}) and dtype {dt}")
    bb, u, bp = _block_shape(b, n, res[0].element_size(),
                             _sm_count(res[0].device))
    lib = _lib(BWD_SOURCE)
    res_p = [_pad(r, bp, 1) for r in res]
    gout_p = _pad(gout, bp, 1)
    h0_p = _pad(h0.float(), bp, 0, dt)  # h0 through f32 into Wr's dtype
    c0_p, gcl_p = (_pad(z, bp, 0, torch.float32) for z in (c0, g_clast))
    wr = wr.contiguous()
    wci, wcf, wco = (w.float().contiguous() for w in (wci, wcf, wco))
    _check_aligned(*res_p, gout_p, wr, h0_p)
    dev = res[0].device
    nb = bp // bb
    dg = torch.empty(t, bp, 4 * n, dtype=dt, device=dev)
    hp = torch.empty(t, bp, n, dtype=dt, device=dev)
    dh0 = torch.empty(bp, n, dtype=torch.float32, device=dev)
    dc0 = torch.empty_like(dh0)
    partial = torch.empty(nb, 3, n, dtype=torch.float32, device=dev)
    splits = _dw_splits(t * bp, n, res[0].element_size(), _sm_count(dev))
    # the sweep's batch-group counters and lstm_dw's per-tile counters
    counters = torch.zeros(nb + (_dw_tiles(n) if splits > 1 else 0),
                           dtype=torch.int32, device=dev)
    counter = counters[:nb]
    ws = (torch.empty(splits, n, 4 * n, dtype=torch.float32, device=dev)
          if splits > 1 else None)
    dwr = torch.empty(n, 4 * n, dtype=torch.float32, device=dev)
    dwci, dwcf, dwco = (torch.empty(n, dtype=torch.float32, device=dev)
                        for _ in range(3))
    code = _DTYPE_CODES[dt]
    ptrs = [z.data_ptr() for z in (*res_p, gout_p, wr, wci, wcf, wco, h0_p,
                                   c0_p, gcl_p, dg, hp, dh0, dc0, partial,
                                   counter)]
    dims = [t, bp, n, bb, u, code]
    with torch.cuda.device(dev):
        if timed:
            stamps = torch.zeros(nb * (n // u), t, 4, dtype=torch.int64,
                                 device=dev)
            name = BWD_TIMED_KERNEL
            err = lib.dl4j_lstm_bwd_timed(*ptrs, stamps.data_ptr(), *dims,
                                          _stream(dev))
        else:
            name = BWD_KERNEL
            err = lib.dl4j_lstm_bwd(*ptrs, *dims, _stream(dev))
        _check(name, err)
        kernels.LAUNCHES[name] += 1
        err = lib.dl4j_lstm_dw(
            *[z.data_ptr() for z in (hp, dg, partial, dwr, dwci, dwcf, dwco)],
            None if ws is None else ws.data_ptr(),
            None if ws is None else counters[nb:].data_ptr(),
            t * bp, n, nb, splits, code, _stream(dev))
        _check(DW_KERNEL, err)
        kernels.LAUNCHES[DW_KERNEL] += 1
    out = (dg[:, :b], dwr, dwci, dwcf, dwco, dh0[:b], dc0[:b])
    return out + (stamps,) if timed else out


# ------------------------------------------------------------ dispatch

def lstm_fwd(xg, wr, wci, wcf, wco, h0, c0, with_residuals: bool = True):
    """The forward: ``lstm_fwd`` (with residuals) or ``lstm_fwd_only``
    for CUDA tensors, the plain version for CPU ones (see
    :func:`lstm_fwd_plain` for what it returns)."""
    if xg.device.type == "cuda":
        return _lstm_fwd_cuda(xg, wr, wci, wcf, wco, h0, c0, with_residuals)
    if xg.device.type == "cpu":
        return lstm_fwd_plain(xg, wr, wci, wcf, wco, h0, c0, with_residuals)
    raise ValueError(f"the LSTM scan runs on cuda or cpu, not {xg.device}")


def lstm_fwd_timed(xg, wr, wci, wcf, wco, h0, c0):
    """``lstm_fwd``'s bf16 kernel in its timed instantiation, on CUDA
    tensors only: ``(h_seq, residuals, stamps)``, with stamps [blocks, t,
    4] int64 the card's globaltimer (ns) per block and step after the
    barrier, after the last h chunk landed, after its product, and after
    the cell and its stores. A measurement entry point: no path of the
    port calls it."""
    if xg.device.type != "cuda" or xg.dtype != torch.bfloat16:
        raise ValueError("the timed LSTM kernel runs on bfloat16 CUDA "
                         f"tensors, not {xg.dtype} on {xg.device}")
    return _lstm_fwd_cuda(xg, wr, wci, wcf, wco, h0, c0, True, timed=True)


def lstm_bwd(res: Residuals, wr, wci, wcf, wco, h0, c0, gout, g_clast):
    """The backward: ``lstm_bwd`` then ``lstm_dw`` for CUDA tensors, the
    plain version for CPU ones (see :func:`lstm_bwd_plain`)."""
    if res[0].device.type == "cuda":
        return _lstm_bwd_cuda(res, wr, wci, wcf, wco, h0, c0, gout, g_clast)
    if res[0].device.type == "cpu":
        return lstm_bwd_plain(res, wr, wci, wcf, wco, h0, c0, gout, g_clast)
    raise ValueError(f"the LSTM scan runs on cuda or cpu, not {res[0].device}")


def lstm_bwd_timed(res: Residuals, wr, wci, wcf, wco, h0, c0, gout, g_clast):
    """``lstm_bwd`` with the bf16 sweep in its timed instantiation, on
    CUDA tensors only: its outputs, then stamps [blocks, t, 4] int64, the
    card's globaltimer (ns) per block and step after the barrier, after
    the last dg chunk landed, after the product, and after the gate chain
    and its stores. A measurement entry point: no path of the port calls
    it."""
    if res[0].device.type != "cuda" or res[0].dtype != torch.bfloat16:
        raise ValueError("the timed LSTM kernel runs on bfloat16 CUDA "
                         f"tensors, not {res[0].dtype} on {res[0].device}")
    return _lstm_bwd_cuda(res, wr, wci, wcf, wco, h0, c0, gout, g_clast,
                          timed=True)


class _FusedLSTM(torch.autograd.Function):
    """The reference's ``custom_vjp`` (``_vjp_fwd``/``_vjp_bwd``): the
    forward streams the residuals, the backward runs the BPTT on them.
    Outputs (h_seq, h_T, c_T) with c_T the rounded residual in f32."""

    @staticmethod
    def forward(ctx, xg, wr, wci, wcf, wco, h0, c0):
        h_seq, res = lstm_fwd(xg, wr, wci, wcf, wco, h0, c0)
        ctx.save_for_backward(*res, wr, wci, wcf, wco, h0, c0)
        return h_seq, h_seq[-1].clone(), res[4][-1].float()

    @staticmethod
    def backward(ctx, g_hseq, g_hlast, g_clast):
        i, f, o, blk, c, wr, wci, wcf, wco, h0, c0 = ctx.saved_tensors
        # fold dL/dh_T into the sequence stream, in the residual dtype;
        # dL/dc_T enters the dc carry directly
        gout = g_hseq.float().clone()
        gout[-1] += g_hlast.float()
        dg, dwr, dwci, dwcf, dwco, dh0, dc0 = lstm_bwd(
            (i, f, o, blk, c), wr, wci, wcf, wco, h0, c0,
            gout.to(i.dtype), g_clast)
        return (dg.to(i.dtype), dwr.to(wr.dtype), dwci.to(wci.dtype),
                dwcf.to(wcf.dtype), dwco.to(wco.dtype), dh0.to(h0.dtype),
                dc0.to(c0.dtype))


def fused_lstm_scan(xg, wr, wci, wcf, wco, h0, c0
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """xg [t, b, 4n] pre-projected gates -> (h_seq [t, b, n], (h_T, c_T)).

    With no gradient wanted (grad mode off, or no input requires one)
    the forward-only kernel runs, as the reference's ``_fused`` primal;
    otherwise the residual forward, with the BPTT kernels as its
    backward. The final carries take gradients too."""
    ins = (xg, wr, wci, wcf, wco, h0, c0)
    if not (torch.is_grad_enabled() and any(z.requires_grad for z in ins)):
        return lstm_fwd(*ins, with_residuals=False)
    h_seq, h_t, c_t = _FusedLSTM.apply(*ins)
    return h_seq, (h_t, c_t)


def fused_lstm_applicable(b: int, n: int, gate_act: str, block_act: str,
                          mask, itemsize: int = 2,
                          device: Optional[torch.device] = None) -> bool:
    """The fused scan covers the default Graves configuration (no mask,
    sigmoid gates, tanh block), as the reference's gate. On a CUDA
    ``device`` the kernels must take the shape too (``_kernel_takes``);
    on the CPU (the default) the plain versions take any shape."""
    if mask is not None or gate_act != "sigmoid" or block_act != "tanh":
        return False
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        return _kernel_takes(b, n, itemsize, dev)
    return dev.type == "cpu"


def fused_lstm_train_applicable(b: int, n: int, gate_act: str,
                                block_act: str, mask, itemsize: int = 2,
                                device: Optional[torch.device] = None) -> bool:
    """Training through the fused scan: the BPTT kernels take the same
    shapes as the forward ones (one grid layout), so this is
    :func:`fused_lstm_applicable`; the reference's VMEM budget for its
    backward (``_BWD_MAX_N``) has no counterpart on Hopper."""
    return fused_lstm_applicable(b, n, gate_act, block_act, mask,
                                 itemsize=itemsize, device=device)
