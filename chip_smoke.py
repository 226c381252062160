#!/usr/bin/env python3
"""Smoke test of the PyTorch port (deeplearning4j_tpu_torch) on one
NVIDIA GPU; the quickest proof that the port still starts on the card.

    python3 chip_smoke.py                 # every phase, as the check runs it
    python3 chip_smoke.py --only 2b,5     # phases 0 and 1, then just these

Phases (any failure ends the run with a non-zero exit and no result):

0. device: the card's name and power limit (nvidia-smi); fails without
   CUDA.
1. build: every kernel source in this checkout, one ``nvcc`` each, all
   started together, from an empty build directory, timed; fails if a
   bf16 ``flash_fwd_kernel``, ``flash_dq_kernel``, ``flash_dkv_kernel``,
   ``lstm_fwd_kernel``, ``lstm_bwd_kernel`` or ``lstm_dw_kernel`` spills
   registers (``BF16_KERNELS``).
2. kernels: each kernel's wrapper on card tensors against its plain
   PyTorch version on the same inputs, at the main paths' shapes, at
   larger ones and at ragged ones (t = 200, tq 72 / tk 200, one head of
   2048), with stated tolerances; a forward call must be one launch of
   ``flash_fwd_kernel``, and the bf16 forward is also run and timed at
   both of its tilings (64 and 128 query rows per block); median times
   beside the plain version, the one PyTorch call that computes the same
   function (a yardstick only, never used by the port) and the least
   time the card could take (the bound). ``ms`` columns are device time
   (torch.profiler: the card's work per call); ``call_ms`` columns are
   CUDA-event time per single call, which includes the host's launch
   work. The forward (``flash_fwd``) first, then the backward
   (``flash_dq``, ``flash_dkv``) at the same shapes, ragged ones
   included; a backward call must launch each of the two once.
2b. LSTM kernels: first one call of ``lstm_fwd``'s timed bf16
   instantiation at the training shape, printed as ``lstm_fwd_phases``:
   the mean µs per step (over blocks and steps) of the barrier wait, the
   h chunks up to the landing of the last one (their copies and waits
   and the products of all but the last), the last chunk's product, and
   the cell with its stores, from the card's globaltimer; then one call
   of ``lstm_bwd``'s timed bf16 sweep on that forward's residuals,
   printed as ``lstm_bwd_phases`` (the same four phases of its step:
   barrier wait, dg chunks but the last, the last chunk's product, the
   gate chain with its stores and the next step's prefetch), whose
   outputs must equal the untimed kernels' bit for bit. Then
   ``lstm_fwd_only``, ``lstm_fwd`` and the backward pair ``lstm_bwd`` +
   ``lstm_dw`` against their plain versions, f32 and bf16, nonzero h0
   and c0, at the char-RNN's two main shapes (b 1024, t 128,
   n 512 bf16 for training; b 32, t 1, n 512 f32 for serving) and at
   n 128 / 1024, b 8 / 32 / 1024, t 1 / 9 / 128; the yardstick is
   PyTorch's ``nn.LSTM`` (cuDNN where it takes the dtype), which has no
   peepholes: the same products, not the same function.
3. serving at full width: ``gpt`` (vocab 8192, d_model 512, 8 layers,
   8 heads, max_len 512, bf16) with random weights from a numpy seed,
   greedy ``generate`` of 128 tokens for 8 prompts of 64. Launch counts
   are zeroed right before this run and read right after it; every
   kernel of the path must have launched. ``generate`` must equal
   ``generate_eager``, the prefill logits must agree with the same net
   run with the plain attention, and everything must be finite.
4. training at full width: the JAX package's GPT training benchmark
   width (vocab 8192, d_model 512, 8 layers, 8 heads, seq 1024, batch
   16, bf16, Adam at 3e-4) with random weights from a numpy seed and
   ids from a numpy seed, labels the ids rolled by one. Counts zeroed
   before one ``fit`` step and read after it: ``flash_fwd``,
   ``flash_dq`` and ``flash_dkv`` each launch once per block. Loss and
   gradients with the kernels agree with the same step run with the
   plain versions on the card; 20 steps on the batch give finite losses
   that fall; step time, tokens/s, MFU, the device busy share (beside
   the share of the port's kernel events the profile kept) and the
   attention kernels' device time per step are printed.
5. char-RNN serving at full width: the JAX package's LSTM decode
   benchmark (vocab 64, two GravesLSTM of 512, RnnOutputLayer softmax,
   f32), random weights from a numpy seed, greedy ``generate`` of 128
   tokens for 32 prompts of 32. ``lstm_fwd_only`` launches once per layer
   per prompt step and per decode step, 2 x (32 + 127) times, and no
   other LSTM kernel; ``generate`` equals ``generate_eager``; ``output``
   on the prompt agrees with the plain versions; ``rnn_time_step`` fed
   the prompt step by step ends on ``output``'s last step.
6. char-RNN training at full width: the JAX package's LSTM training
   benchmark (the same stack, bf16, Adam at 0.01, batch 1024, seq 128,
   one-hot ids of a seeded Markov chain, labels the ids rolled by one). One
   ``gradient_and_score`` with the kernels against the plain versions;
   one ``fit`` step launches ``lstm_fwd``, ``lstm_bwd`` and ``lstm_dw``
   once per layer and ``lstm_fwd_only`` never; 20 steps give finite
   losses that fall; step time, tokens/s, MFU, busy share (and kept
   share), the LSTM
   kernels' device ms per step and peak memory are printed. Then a
   witness (printed, not gated): 20 steps through the plain scan on the
   card, from these weights and from a second seed of weights and ids;
   before each, the loss and gradients on the same weights through the
   kernels, and through the forward kernel with the plain backward,
   against the plain scan's.

The last lines are the card's name and power limit, one JSON object
with every kernel's numbers, and ``{"ok": true, "device": {...}}``
(only when every phase ran). Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

# bf16 products on the tensor cores; f32 products in full f32 (no TF32)
# so that f32 comparisons hold to 2e-5
TOL = {  # kernel vs its plain version: max |o - o_plain|, max |lse - lse_plain|
    "float32": (2e-5, 2e-5),
    # one bf16 ulp at |o| < 4 is 0.0156; the plain version rounds P and o
    # at the same places but sums in another order
    "bfloat16": (2e-2, 1e-4),
}
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM dense
PEAK_BYTES = 3.35e12
GPT = dict(vocab_size=8192, d_model=512, n_layers=8, num_heads=8, max_len=512,
           compute_dtype="bfloat16")
BATCH, PROMPT, NEW = 8, 64, 128
# prefill logits with the flash kernel vs with the plain attention, same
# card and matmuls: the attention outputs differ by about a bf16 ulp and
# that difference passes through 8 bf16 layers
LOGIT_TOL = 5e-2
# backward kernels vs their plain version, max |dq/dk/dv - plain|:
# f32: CUDA-core FMAs without TF32, only the order of the sums differs;
# bf16: ds and p are rounded to bf16 before their products, and a score
# that differs in the last f32 bit can round ds to the neighbouring bf16
# value, summed in another order; so the bound scales with max |ref|
BWD_TOL_F32 = 2e-5
BWD_REL_BF16 = 2e-2
TRAIN = dict(vocab_size=8192, d_model=512, n_layers=8, num_heads=8,
             max_len=1024, compute_dtype="bfloat16")
TRAIN_BATCH, TRAIN_STEPS = 16, 20
# the flash kernels' wide heads (the SIMT design, phase 2): the shape
# their times are recorded at, [32, 1024, 256] causal, and a ragged head
# of 512 (t 200: no multiple of its 16-row tiles)
WIDE_HEAD = (256, 32, 1024)
WIDE_HEAD_CASES = {dtype: [(dtype, WIDE_HEAD[0], WIDE_HEAD[1], WIDE_HEAD[2],
                            WIDE_HEAD[2], True), (dtype, 512, 8, 200, 200, True)]
                   for dtype in ("bfloat16", "float32")}
# one step's loss and gradients with the kernels vs with the plain
# versions on the card: bf16 attention outputs and gradients that differ
# by bf16 roundings pass through 8 bf16 layers
TRAIN_LOSS_TOL, TRAIN_GRAD_REL = 1e-2, 2e-2

# LSTM kernels vs their plain versions (phase 2b). f32: CUDA-core FMAs
# (no TF32) against cuBLAS f32, so only the order of the sums differs,
# carried through up to 128 steps of the recurrence (forward outputs are
# at most ~1 in size: an absolute bound; gradients relative to max
# |ref|). bf16: both sides round h, the streams and dg at the same
# points, but a product that differs in its last f32 bit can round to
# the neighbouring bf16 value, and the recurrence carries that on; so
# the bound is relative to max(1, max |ref|), as the flash backward's.
LSTM_TOL_F32, LSTM_BWD_REL_F32 = 5e-5, 1e-4
LSTM_REL_BF16 = 3e-2
LSTM_CASES = [  # (dtype, b, t, n); the training and serving shapes first
    ("bfloat16", 1024, 128, 512), ("float32", 32, 1, 512),
    ("bfloat16", 32, 1, 512), ("float32", 32, 128, 512),
    ("bfloat16", 8, 9, 128), ("float32", 8, 9, 128),
    ("bfloat16", 1024, 9, 128), ("float32", 1024, 9, 128),
    ("bfloat16", 32, 9, 1024), ("float32", 32, 9, 1024),
    ("bfloat16", 128, 128, 1024), ("float32", 8, 128, 1024),
]
CHAR_VOCAB, CHAR_HIDDEN = 64, 512
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 32, 32, 128
# output with the kernels vs the plain versions (f32): the sums of the
# recurrent product in another order, through two layers and 32 steps
SERVE_OUT_TOL = 1e-5
CHAR_BATCH, CHAR_SEQ, CHAR_STEPS = 1024, 128, 20
# one bf16 step, kernels vs plain versions on the card: loss, and the
# relative L2 of each parameter's gradient (bf16 roundings of h and dg
# that differ, carried through 128 steps and two layers)
CHAR_LOSS_TOL, CHAR_GRAD_REL = 1e-2, 3e-2


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def _time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median of ``reps`` timings by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# the one name of _device_times's result when torch.profiler kept no
# whole profile
EVENT_TIMED = "whole call, by CUDA events (torch.profiler kept no whole profile)"


# seconds of idle host time around the calls inside each profile, per
# attempt: the profiler keeps only device events whose timestamps, mapped
# to the host's clock, fall inside the profile; where that mapping is off
# by more than the margin, a profile can come back empty or keep only
# some of its device events
PROFILE_PADS = (0.02, 0.1, 0.5, 1.0, 2.0)


# the port's kernels as torch.profiler names them (bf16 and f32 alike) ->
# the names under which their wrappers count launches in kernels.LAUNCHES
PORT_KERNELS = {"flash_fwd_kernel": ("flash_fwd",),
                "flash_dq_kernel": ("flash_dq",),
                "flash_dkv_kernel": ("flash_dkv",),
                "lstm_fwd_kernel": ("lstm_fwd", "lstm_fwd_only"),
                "lstm_bwd_kernel": ("lstm_bwd",),
                "lstm_dw_kernel": ("lstm_dw",)}


def _port_kernel(name: str):
    """The ``PORT_KERNELS`` key of a profiler name, or None."""
    m = re.search(r"::(\w+?_kernel)(?:_f32)?<", name)
    return m.group(1) if m and m.group(1) in PORT_KERNELS else None


class _Profile(dict):
    """Device ms per call by name; ``kept_share``: the share of the
    port's kernel launches whose events the profile kept (None where the
    calls launched none of them)."""
    kept_share = None


def _device_times(torch, fn, reps: int) -> dict:
    """Device ms per call of ``fn`` for each kernel, copy and fill name
    that torch.profiler saw in ``reps`` calls (after one warm-up call).
    Unlike the event time it leaves out the host's share. A profile may
    keep only some of its device events (on the chip's machine it often
    drops a few, and in a long process up to most of them), so a name's
    time per call is the mean of the events it kept times its launches
    per call. For the port's kernels those are known: each wrapper
    counts its launches in ``kernels.LAUNCHES``, so their times are
    exact however many events were dropped (several instantiations of
    one kernel share its count in proportion to their events). For any
    other name (library kernels, copies, fills) they are estimated as
    ``ceil(count / reps)``: exact for a name launched once per call; for
    one launched k times per call, it reads low by a launch for every
    ``reps`` of its events dropped. The result's ``kept_share`` is the
    share of the port's launches whose events were kept, the measure of
    how far a sum over other names may read low. A profile that recorded
    no device time at all, or no event of a port kernel that the calls
    launched, is taken again with a wider idle margin around the calls
    (``PROFILE_PADS``); if none was whole in that sense, the result is
    the CUDA-event time of ``reps`` calls issued back to back, per call,
    under the one name ``EVENT_TIMED`` (so a query for a kernel's own
    name then fails)."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch import kernels

    fn()
    torch.cuda.synchronize()
    for attempt, pad in enumerate(PROFILE_PADS):
        before = collections.Counter(kernels.LAUNCHES)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        ran = kernels.LAUNCHES - before
        seen = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        groups = collections.defaultdict(list)
        for e in seen:
            groups[_port_kernel(e.key)].append(e)
        unseen = sorted(key for key, names in PORT_KERNELS.items()
                        if key not in groups and any(ran[w] for w in names))
        if seen and not unseen:
            if attempt:
                print(f"chip_smoke: torch.profiler recorded no device time "
                      f"(or none of a port kernel that ran) with margins "
                      f"{PROFILE_PADS[:attempt]} s, and did with {pad} s",
                      flush=True)
            out, launched, kept = _Profile(), 0, 0
            for key, events in groups.items():
                if key is None:
                    for e in events:
                        out[e.key] = (e.self_device_time_total / 1e3 / e.count
                                      * -(-e.count // reps))
                    continue
                n = sum(ran[w] for w in PORT_KERNELS[key])
                c = sum(e.count for e in events)
                _check(n > 0, f"torch.profiler saw {key} in calls that "
                       f"launched none: {dict(ran)}")
                launched, kept = launched + n, kept + c
                for e in events:
                    out[e.key] = e.self_device_time_total / 1e3 / c * n / reps
            if launched:
                out.kept_share = kept / launched
            short = sum(e.count % reps > 0 for e in groups.get(None, ()))
            if short or kept < launched:
                print(f"chip_smoke: partial profile: kept {kept} events of "
                      f"{launched} port kernel launches; {short} other names "
                      f"kept a count of events that is not a multiple of "
                      f"{reps} calls", flush=True)
            return out
        if seen:
            print(f"chip_smoke: profile at margin {pad} s kept no event of "
                  f"{unseen}, launched {dict(ran)}", flush=True)
        else:
            print(f"chip_smoke: empty profile at margin {pad} s: "
                  f"{len(prof.events())} events, none on the device",
                  flush=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    print(f"chip_smoke: torch.profiler kept no whole profile in "
          f"{len(PROFILE_PADS)} attempts; {EVENT_TIMED}: {ms} ms", flush=True)
    return {EVENT_TIMED: ms}


def _sum_ms(per_name: dict, match: str = "") -> float:
    """The device ms of the names in ``per_name`` that contain ``match``
    (all of them by default); fails where there are none."""
    ms = sum(t for name, t in per_name.items() if match in name)
    _check(ms > 0, f"torch.profiler recorded no device time for {match!r}")
    return ms


def _device_ms(torch, fn, reps: int, match: str = "") -> float:
    """Device ms per call of ``fn``, of the names containing ``match``."""
    return _sum_ms(_device_times(torch, fn, reps), match)


def _clocks() -> str:
    """The card's SM and memory clocks, power draw and temperature now."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,"
                        "power.draw,temperature.gpu", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _ptxas(report):
    """[(kernel, registers, spill bytes stored and loaded)] from
    ``-Xptxas -v``."""
    out, fn, spill = [], None, 0
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            fn, spill = ln.split("'")[1], 0
        elif "bytes spill stores" in ln:
            spill = int(ln.split("bytes spill stores")[0].split(",")[-1]) \
                + int(ln.split("bytes spill loads")[0].split(",")[-1])
        elif "Used " in ln and fn is not None:
            out.append((fn, int(ln.split("Used ")[1].split()[0]), spill))
            fn = None
    return out


def _card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _live_pairs(tq, tk, causal):
    """The (q, k) pairs the causal mask leaves (all of them otherwise)."""
    offset = tk - tq
    return sum(min(tk, r + offset + 1) for r in range(tq)) if causal \
        else tq * tk


def _flash_bound(bh, tq, tk, d, causal, dtype):
    """(bound_ms, bound_by): the work this input needs (the (q, k) pairs
    the causal mask leaves, at 4 d flops each) over the peak rate of its
    type, or its bytes (q, k, v read once, o and lse written once) over
    the memory rate, whichever is larger."""
    flops = 4.0 * bh * d * _live_pairs(tq, tk, causal)
    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * bh * d * (2 * tq + 2 * tk) + 4 * bh * tq
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _flash_bwd_bound(bh, tq, tk, d, causal, dtype, flops_per_pair, n_out):
    """(bound_ms, bound_by) of one backward kernel: ``flops_per_pair``
    per live (q, k) pair (6 d for dq: the s, dP and ds.k products; 8 d
    for dk/dv: s, dP, p^T.dO and ds^T.q) over the peak rate of its type,
    or its bytes (q, k, v, dO read once, lse and delta once, ``n_out``
    [.., d] outputs written once; dq, which computes delta, also reads
    O) over the memory rate."""
    flops = float(flops_per_pair) * bh * _live_pairs(tq, tk, causal)
    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * bh * d * (2 * tq + 2 * tk) + 8 * bh * tq \
        + size * bh * d * (2 * tq if n_out == 1 else 2 * tk)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_bwd_kernels(torch, F, kernels, flash):
    """Phase 2, backward: flash_dq and flash_dkv against the plain
    backward on the same (q, k, v, o, lse, dO)."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(4321)
    cases = []
    for dtype in ("bfloat16", "float32"):
        for d in (64, 128):
            for t, bh in ((64, 64), (1024, 128), (2048, 8)):
                for causal in (False, True):
                    cases.append((dtype, d, bh, t, t, causal))
            cases.append((dtype, d, 16, 512, 2048, True))  # tq < tk: offset
            # ragged last q- and k-tiles; an offset with a ragged diagonal;
            # few blocks with a long loop (the forward's ragged cases)
            cases += [(dtype, d, 8, 200, 200, False), (dtype, d, 8, 200, 200, True),
                      (dtype, d, 8, 72, 200, True), (dtype, d, 1, 2048, 2048, False),
                      (dtype, d, 1, 2048, 2048, True)]
        cases += WIDE_HEAD_CASES[dtype]
    for dtype, d, bh, tq, tk, causal in cases:
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.randn(bh, t, d, generator=g, device="cuda").to(dt)
                       for t in (tq, tk, tk, tq))
        o, lse = flash.flash_attention_fwd(q, k, v, causal)
        blocks = (flash._bwd_block(tq, 1024 if causal else 512),
                  flash._bwd_block(tk, 1024))
        kernels.reset_launches()
        got = flash.flash_attention_bwd(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        tag = f"{dtype} d{d} bh{bh} tq{tq} tk{tk} causal={causal}"
        launched = dict(kernels.LAUNCHES)
        _check(launched == {flash.DQ_KERNEL: 1, flash.DKV_KERNEL: 1},
               f"flash bwd {tag}: one call launched {launched}")
        want = flash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                               *blocks)
        errs = {}
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            _check(bool(torch.isfinite(a.float()).all()), f"finite {name}")
            err = (a.float() - b.float()).abs().max().item()
            ref = b.float().abs().max().item()
            tol = BWD_TOL_F32 if dtype == "float32" else BWD_REL_BF16 * ref
            _check(err <= tol, f"flash bwd {name} {tag}: err {err} > tol {tol}")
            errs[name] = err
        kernel = lambda: flash.flash_attention_bwd(  # noqa: E731
            q, k, v, o, lse, do, causal)
        plain = lambda: flash.flash_attention_bwd_plain(  # noqa: E731
            q, k, v, o, lse, do, causal, *blocks)
        # SDPA's backward as a yardstick: its fwd+bwd device time less
        # its fwd time, on [1, bh, t, d] (is_causal where tq == tk, which
        # lets it pick its flash backend; an explicit mask otherwise)
        qs_, ks_, vs_ = (z[None].detach().requires_grad_() for z in (q, k, v))
        mask = None
        if causal and tq != tk:
            mask = torch.ones(tq, tk, dtype=torch.bool, device="cuda").tril(tk - tq)
        lib_kw = dict(attn_mask=mask, is_causal=causal and mask is None)
        lib_fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs_, ks_, vs_, **lib_kw)
        lib_fb = lambda: torch.autograd.grad(  # noqa: E731
            lib_fwd(), (qs_, ks_, vs_), do[None])
        times = _device_times(torch, kernel, 10)
        dq_bound = _flash_bwd_bound(bh, tq, tk, d, causal, dtype, 6 * d, 1)
        dkv_bound = _flash_bwd_bound(bh, tq, tk, d, causal, dtype, 8 * d, 2)
        row = dict(dtype=dtype, bh=bh, tq=tq, tk=tk, d=d, causal=causal,
                   err_dq=errs["dq"], err_dk=errs["dk"], err_dv=errs["dv"],
                   ms=_sum_ms(times),
                   dq_kernel_only_ms=_sum_ms(times, "flash_dq_kernel"),
                   dkv_kernel_only_ms=_sum_ms(times, "flash_dkv_kernel"),
                   plain_ms=_device_ms(torch, plain, 2),
                   library_ms=(_device_ms(torch, lib_fb, 10)
                               - _device_ms(torch, lib_fwd, 10)),
                   dq_bound_ms=dq_bound[0], dq_bound_by=dq_bound[1],
                   dkv_bound_ms=dkv_bound[0], dkv_bound_by=dkv_bound[1],
                   call_ms=_time_ms(torch, kernel, 10),
                   plain_call_ms=_time_ms(torch, plain, 2, warmup=1))
        print("flash_bwd " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


def phase_kernels(torch, F, flash):
    """Phase 2: the flash kernel against its plain version."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(1234)
    cases = []
    for dtype in ("bfloat16", "float32"):
        for d in (64, 128):
            # (64, 64) is the prefill shape, (1024, 128) the training one
            for t, bh in ((64, 64), (512, 16), (1024, 128), (2048, 8)):
                for causal in (False, True):
                    cases.append((dtype, d, bh, t, t, causal))
            cases.append((dtype, d, 16, 512, 2048, True))  # tq < tk: offset
            # ragged last q- and k-tiles; an offset with a ragged diagonal;
            # few blocks with a long key loop
            cases += [(dtype, d, 8, 200, 200, False), (dtype, d, 8, 200, 200, True),
                      (dtype, d, 8, 72, 200, True), (dtype, d, 1, 2048, 2048, False),
                      (dtype, d, 1, 2048, 2048, True)]
        cases += WIDE_HEAD_CASES[dtype]
    for dtype, d, bh, tq, tk, causal in cases:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(bh, t, d, generator=g, device="cuda").to(dt)
                   for t in (tq, tk, tk))
        op, lp = flash.flash_attention_fwd_plain(q, k, v, causal)
        tol_o, tol_l = TOL[dtype]
        tag = f"{dtype} d{d} bh{bh} tq{tq} tk{tk} causal={causal}"

        def errors(o, lse, what):
            torch.cuda.synchronize()
            _check(bool(torch.isfinite(o.float()).all()), f"finite o {what} {tag}")
            err_o = (o.float() - op.float()).abs().max().item()
            err_l = (lse - lp).abs().max().item()
            _check(err_o <= tol_o and err_l <= tol_l,
                   f"flash {what} {tag}: o err {err_o} (tol {tol_o}), "
                   f"lse err {err_l} (tol {tol_l})")
            return err_o, err_l

        err_o, err_l = errors(*flash.flash_attention_fwd(q, k, v, causal), "")
        # SDPA as a yardstick, on [1, bh, t, d]: is_causal where tq == tk
        # (which lets it pick its flash backend), an explicit mask otherwise
        mask = None
        if causal and tq != tk:
            mask = torch.ones(tq, tk, dtype=torch.bool, device="cuda").tril(tk - tq)
        kernel = lambda: flash.flash_attention_fwd(q, k, v, causal)  # noqa: E731
        plain = lambda: flash.flash_attention_fwd_plain(q, k, v, causal)  # noqa: E731
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q[None], k[None], v[None], attn_mask=mask,
            is_causal=causal and mask is None)
        bound_ms, bound_by = _flash_bound(bh, tq, tk, d, causal, dtype)
        times = _device_times(torch, kernel, 20)
        # the whole call is one launch of the kernel (q is scaled inside)
        _check(all("flash_fwd_kernel" in name for name in times),
               f"flash_fwd call {tag} ran more than its kernel: {sorted(times)}")
        by_block_q = {}
        if dtype == "bfloat16" and tq > 64 and d <= 128:  # the mma kernel's two tilings
            for bq in (64, 128):
                run = lambda: flash._flash_fwd_cuda(q, k, v, causal, bq)  # noqa: E731
                errors(*run(), f"block_q {bq}")
                by_block_q[bq] = _device_ms(torch, run, 20, "flash_fwd_kernel")
        row = dict(dtype=dtype, bh=bh, tq=tq, tk=tk, d=d, causal=causal,
                   err_o=err_o, err_lse=err_l,
                   ms=_sum_ms(times),
                   kernel_only_ms=_sum_ms(times, "flash_fwd_kernel"),
                   kernel_only_ms_by_block_q=by_block_q,
                   plain_ms=_device_ms(torch, plain, 3),
                   library_ms=_device_ms(torch, library, 20),
                   bound_ms=bound_ms, bound_by=bound_by,
                   call_ms=_time_ms(torch, kernel, 20),
                   plain_call_ms=_time_ms(torch, plain, 3, warmup=1),
                   library_call_ms=_time_ms(torch, library, 20))
        print("flash_fwd " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


@contextlib.contextmanager
def _plain_attention(torch, flash, transformer):
    """Swap the blocks' attention for the flash kernels' plain versions
    on the same card tensors, forward and backward, with the blocks the
    wrapper would use (the comparisons of phases 3 and 4 only)."""
    saved = transformer.dispatch_attention

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal):
            tq, tk = q.shape[1], k.shape[1]
            bq = flash._pick_block(tq, 1024 if causal else 512)
            bk = flash._pick_block(tk, 1024)
            o, lse = flash.flash_attention_fwd_plain(q, k, v, causal, bq, bk)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.causal = causal
            ctx.blocks = (flash._bwd_block(tq, bq), flash._bwd_block(tk, bk))
            return o

        @staticmethod
        def backward(ctx, grad):
            q, k, v, o, lse = ctx.saved_tensors
            return (*flash.flash_attention_bwd_plain(
                q, k, v, o, lse, grad, ctx.causal, *ctx.blocks), None)

    def plain(q, k, v, causal, mask=None):
        b, t, h, d = q.shape
        fold = lambda z: z.transpose(1, 2).reshape(b * h, t, d)  # noqa: E731
        o = PlainFlash.apply(fold(q), fold(k), fold(v), causal)
        return o.reshape(b, h, t, d).transpose(1, 2)

    transformer.dispatch_attention = plain
    try:
        yield
    finally:
        transformer.dispatch_attention = saved


def _random_params(net, seed: int):
    """Weights for ``net`` from a numpy seed, in the port's layout."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tree = {}
    for layer, params in net.params.items():
        tree[layer] = {}
        for name, t in params.items():
            shape = tuple(t.shape)
            if name.endswith("_g"):
                a = np.ones(shape)
            elif len(shape) == 1:
                a = 0.02 * rng.standard_normal(shape)
            else:
                a = rng.standard_normal(shape) * (2.0 / sum(shape)) ** 0.5
            tree[layer][name] = a.astype(np.float32)
    return tree


def phase_gpt(torch, np, kernels, flash):
    """Phase 3: the slice at full width; returns (launches, metrics)."""
    from deeplearning4j_tpu_torch.models.zoo.transformer import gpt
    from deeplearning4j_tpu_torch.nn import generate as gen_mod
    from deeplearning4j_tpu_torch.nn.layers import transformer
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    net = gpt(**GPT).init()
    params_from_numpy(net, _random_params(net, seed=7))
    prompts = np.random.default_rng(8).integers(0, GPT["vocab_size"],
                                                (BATCH, PROMPT))

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = net.generate(prompts, NEW)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    _check(launches.get(flash.KERNEL, 0) > 0,
           f"the flash kernel never launched on the generate path: {launches}")

    _check(out.shape == (BATCH, PROMPT + NEW), f"output shape {out.shape}")
    _check(bool((out[:, :PROMPT] == prompts).all()), "prompt echoed")
    _check(bool(((out >= 0) & (out < GPT["vocab_size"])).all()), "token range")
    eager = gen_mod.generate_eager(net, prompts, NEW)
    _check(bool((out == eager).all()), "generate == generate_eager")

    g = gen_mod.build_generator(net)
    ids = torch.as_tensor(prompts, device="cuda")
    lengths = torch.full((BATCH,), PROMPT, device="cuda")

    def prefill():
        return g.prefill(net.cast_params(net.params), ids, lengths,
                         PROMPT + NEW)

    caches, logits = prefill()
    with _plain_attention(torch, flash, transformer):
        caches_p, logits_p = prefill()
    _check(bool(torch.isfinite(logits).all()), "finite prefill logits")
    _check(all(bool(torch.isfinite(c[n].float()).all())
               for c in caches for n in ("k", "v")), "finite caches")
    logit_err = (logits - logits_p).abs().max().item()
    _check(logit_err <= LOGIT_TOL,
           f"prefill logits kernel vs plain attention: {logit_err} > {LOGIT_TOL}")
    _check(bool((logits.argmax(-1).cpu().numpy() == out[:, PROMPT]).all()),
           "first token is the prefill argmax")

    prefill_ms = _time_ms(torch, prefill, 10)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.generate(prompts, NEW)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    gen_s = statistics.median(times)
    per_gen = _device_times(torch, lambda: net.generate(prompts, NEW), 1)
    gen_device_ms = _sum_ms(per_gen)
    metrics = dict(generate_device_ms=gen_device_ms,
                   device_busy_share=gen_device_ms / (gen_s * 1e3),
                   profile_kept_share=per_gen.kept_share,
                   first_generate_s=first_s, generate_s=gen_s,
                   tokens_per_s=BATCH * NEW / gen_s, prefill_ms=prefill_ms,
                   decode_ms_per_token=(gen_s * 1e3 - prefill_ms) / (NEW - 1),
                   prefill_logit_max_abs_diff_vs_plain=logit_err,
                   max_abs_logit=logits.abs().max().item())
    print("gpt " + json.dumps(metrics), flush=True)
    return launches, metrics


def phase_train(torch, np, kernels, flash):
    """Phase 4: training at full width; returns (launches, metrics)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.zoo.transformer import (
        gpt,
        gpt_train_flops_per_token,
    )
    from deeplearning4j_tpu_torch.nn.layers import transformer
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    t = TRAIN["max_len"]
    net = gpt(**TRAIN).init()
    params_from_numpy(net, _random_params(net, seed=11))
    ids = np.random.default_rng(12).integers(0, TRAIN["vocab_size"],
                                             (TRAIN_BATCH, t))
    ds = DataSet(ids.astype(np.float32),
                 np.roll(ids, -1, axis=1).astype(np.float32))

    # one step's loss and gradients, kernels vs plain versions (eval
    # mode: dropout is 0 in this configuration anyway)
    grads, loss = net.gradient_and_score(ds)
    with _plain_attention(torch, flash, transformer):
        grads_p, loss_p = net.gradient_and_score(ds)
    _check(abs(loss - loss_p) <= TRAIN_LOSS_TOL,
           f"train loss kernels {loss} vs plain {loss_p}")
    worst = 0.0
    for layer, gl in grads.items():
        for name, g in gl.items():
            gp = grads_p[layer][name]
            _check(bool(torch.isfinite(g).all()), f"finite grad {layer}/{name}")
            rel = ((g - gp).norm() / gp.norm().clamp_min(1e-30)).item()
            _check(rel <= TRAIN_GRAD_REL,
                   f"grad {layer}/{name} kernels vs plain: rel L2 {rel}")
            worst = max(worst, rel)
    del grads, grads_p

    torch.cuda.synchronize()
    kernels.reset_launches()
    net.fit(ds)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for name in (flash.KERNEL, flash.DQ_KERNEL, flash.DKV_KERNEL):
        _check(launches.get(name, 0) == TRAIN["n_layers"],
               f"{name} launched {launches.get(name, 0)} times in one train "
               f"step, expected {TRAIN['n_layers']}: {launches}")

    losses, times = [net.score()], []
    for _ in range(TRAIN_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(net.score())
    _check(all(np.isfinite(losses)), f"finite losses {losses}")
    _check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    step_s = statistics.median(times[1:])  # steps 3..20
    per_step = _device_times(torch, lambda: net.fit(ds), 3)
    dev = {m: _sum_ms(per_step, m) for m in
           ("", "flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")}
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:12]
    tokens = TRAIN_BATCH * t
    flops = gpt_train_flops_per_token(TRAIN["vocab_size"], TRAIN["d_model"],
                                      TRAIN["n_layers"], t)
    torch.cuda.reset_peak_memory_stats()
    net.fit(ds)
    torch.cuda.synchronize()
    metrics = dict(step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
                   mfu=tokens / step_s * flops / PEAK_FLOPS["bfloat16"],
                   step_device_ms=dev[""],
                   device_busy_share=dev[""] / (step_s * 1e3),
                   profile_kept_share=per_step.kept_share,
                   flash_fwd_ms_per_step=dev["flash_fwd_kernel"],
                   flash_dq_ms_per_step=dev["flash_dq_kernel"],
                   flash_dkv_ms_per_step=dev["flash_dkv_kernel"],
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   loss_first=losses[0], loss_last=losses[-1],
                   loss_vs_plain=abs(loss - loss_p),
                   grad_rel_l2_vs_plain_max=worst, losses=losses,
                   top_kernels_ms_per_step=[[k[:90], ms] for k, ms in top])
    print("train " + json.dumps(metrics), flush=True)
    return launches, metrics


def _lstm_bounds(dtype, b, t, n):
    """{kernel: (bound_ms, bound_by)}: the recurrent product's flops
    (2 t b n 4n, the dh recurrence and dWr alike) over the peak rate of
    the type, or each kernel's own bytes (every input read once, every
    output written once) over the memory rate, whichever is larger."""
    s = 2 if dtype == "bfloat16" else 4
    seq = t * b * n * s            # one [t, b, n] stream
    w, carry, peep = 4 * n * n * s, b * n * (s + 4), 3 * n * 4
    nbytes = {
        "lstm_fwd_only": 4 * seq + w + carry + peep + seq + carry,
        "lstm_fwd": 4 * seq + w + carry + peep + 6 * seq,
        # five residuals, gout, h0, c0, dc_T in; dg, h_prev, dh0, dc0 out
        "lstm_bwd": 6 * seq + w + peep + carry + 4 * b * n + 5 * seq + 8 * b * n,
        "lstm_dw": 5 * seq + 16 * n * n + peep,
    }
    flops = 2.0 * t * b * n * 4 * n
    out = {}
    for name, nb in nbytes.items():
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nb / PEAK_BYTES * 1e3
        out[name] = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return out


def _lstm_check(what, dtype, got, want, forward):
    """max |got - want| within the stated tolerance; returns it."""
    _check(bool(got.float().isfinite().all()), f"finite {what}")
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    if dtype == "float32":
        tol = LSTM_TOL_F32 if forward else LSTM_BWD_REL_F32 * max(1.0, ref)
    else:
        tol = LSTM_REL_BF16 * max(1.0, ref)
    _check(err <= tol, f"{what}: err {err} > tol {tol}")
    return err


# the phases between the four stamps of a timed LSTM sweep per block and
# step, named for what they hold. lstm_fwd stamps after the barrier,
# after the last h chunk landed, after the product, after the cell and
# its stores: the copies and waits of every h chunk interleave with the
# products of the chunks before it, so "chunks_but_last" is the copies,
# waits and products of all chunks but the last, ending when the last
# one has landed, and "last_chunk" the last chunk's product (with the
# wait for the step's xg rows); the barrier wait runs from the previous
# step's last stamp to this step's first. lstm_bwd stamps at the same
# points of its step (dg chunks, then the gate chain and its stores;
# its barrier wait also holds what a block does between its arrival and
# its wait)
PHASE_NAMES = ("barrier_wait", "chunks_but_last", "last_chunk", "cell_stores")
BWD_PHASE_NAMES = ("barrier_wait", "chunks_but_last", "last_chunk", "chain_stores")


def _phase_breakdown(stamps, names):
    """Mean µs per step, over blocks and steps 1 .. t-1 (each has a
    barrier before it), of each of the four phases ``names`` (the first
    the barrier wait, from the previous step's last stamp) and of the
    whole step (the sum of the four), from stamps [blocks, t, 4] in ns
    (numpy)."""
    import numpy as np

    st = stamps.astype("float64") / 1e3
    _check(st.ndim == 3 and st.shape[1] > 1 and st.shape[2] == 4
           and len(names) == 4,
           f"the timer needs t > 1, 4 stamps per step and 4 names: "
           f"{st.shape}, {names}")
    spans = {names[0]: st[:, 1:, 0] - st[:, :-1, 3]}
    for k, name in enumerate(names[1:]):
        spans[name] = st[:, 1:, k + 1] - st[:, 1:, k]
    spans["step"] = st[:, 1:, 3] - st[:, :-1, 3]
    _check(all(v.min() >= 0 for v in spans.values()),
           "the stamps of a step are not in order")
    out = {f"{k}_us": float(v.mean()) for k, v in spans.items()}
    ticks = np.diff(np.unique(stamps))
    out.update(blocks=int(st.shape[0]), steps=int(st.shape[1]),
               kernel_us=float(st[:, :, 3].max() - st[:, :, 0].min()),
               # the least step of the card's globaltimer seen in the stamps
               timer_tick_ns=int(ticks.min()) if ticks.size else None)
    return out


def phase_lstm_timer(torch, lk):
    """The per-step breakdowns of lstm_fwd's and lstm_bwd's bf16 sweeps at
    the training shape, from their timed instantiations (one call each
    after a warm-up); each timed call's outputs against the untimed
    kernel's."""
    dtype, b, t, n = LSTM_CASES[0]
    _check(dtype == "bfloat16", "LSTM_CASES[0] is the bf16 training shape")
    g = torch.Generator(device="cuda").manual_seed(2025)
    dt = torch.bfloat16
    xg = torch.randn(t, b, 4 * n, generator=g, device="cuda").to(dt)
    wr = (torch.randn(n, 4 * n, generator=g, device="cuda") * n ** -0.5).to(dt)
    pe = tuple(torch.randn(n, generator=g, device="cuda") * 0.1 for _ in range(3))
    h0 = (torch.randn(b, n, generator=g, device="cuda") * 0.5).to(dt)
    c0 = torch.randn(b, n, generator=g, device="cuda") * 0.5
    lk.lstm_fwd_timed(xg, wr, *pe, h0, c0)
    hs, _, stamps = lk.lstm_fwd_timed(xg, wr, *pe, h0, c0)
    torch.cuda.synchronize()
    want, res = lk.lstm_fwd(xg, wr, *pe, h0, c0)
    _lstm_check(f"timed lstm_fwd h {dtype} b{b} t{t} n{n}", dtype, hs, want, True)
    out = dict(dtype=dtype, b=b, t=t, n=n,
               **_phase_breakdown(stamps.cpu().numpy(), PHASE_NAMES))
    print("lstm_fwd_phases " + json.dumps(out), flush=True)

    gout = torch.randn(t, b, n, generator=g, device="cuda").to(dt)
    gcl = torch.randn(b, n, generator=g, device="cuda")
    lk.lstm_bwd_timed(res, wr, *pe, h0, c0, gout, gcl)
    *got, stamps = lk.lstm_bwd_timed(res, wr, *pe, h0, c0, gout, gcl)
    want = lk.lstm_bwd(res, wr, *pe, h0, c0, gout, gcl)
    torch.cuda.synchronize()
    out = dict(dtype=dtype, b=b, t=t, n=n,
               **_phase_breakdown(stamps.cpu().numpy(), BWD_PHASE_NAMES))
    print("lstm_bwd_phases " + json.dumps(out), flush=True)
    for name, a, w in zip(("dg", "dWr", "dwci", "dwcf", "dwco", "dh0", "dc0"),
                          got, want):
        _check(torch.equal(a, w), f"timed lstm_bwd {name} differs from "
               f"lstm_bwd's: {(a.float() - w.float()).abs().max().item()}")


def phase_lstm_kernels(torch, lk):
    """Phase 2b: the LSTM kernels against their plain versions."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(2024)
    for dtype, b, t, n in LSTM_CASES:
        dt = getattr(torch, dtype)

        def r(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device="cuda") * scale
        xg, wr = r(t, b, 4 * n).to(dt), r(n, 4 * n, scale=n ** -0.5).to(dt)
        pe = tuple(r(n, scale=0.1) for _ in range(3))
        h0, c0 = r(b, n, scale=0.5).to(dt), r(b, n, scale=0.5)
        gout, gcl = r(t, b, n).to(dt), r(b, n)
        tag = f"{dtype} b{b} t{t} n{n}"

        fo = lk.lstm_fwd(xg, wr, *pe, h0, c0, with_residuals=False)
        hs, res = lk.lstm_fwd(xg, wr, *pe, h0, c0)
        bwd = lk.lstm_bwd(res, wr, *pe, h0, c0, gout, gcl)
        torch.cuda.synchronize()
        fo_p = lk.lstm_fwd_plain(xg, wr, *pe, h0, c0, with_residuals=False)
        hs_p, res_p = lk.lstm_fwd_plain(xg, wr, *pe, h0, c0)
        bwd_p = lk.lstm_bwd_plain(res, wr, *pe, h0, c0, gout, gcl)
        err_fo = max(_lstm_check(f"lstm_fwd_only {nm} {tag}", dtype, a, p, True)
                     for nm, a, p in zip(("h", "h_T", "c_T"),
                                         (fo[0], *fo[1]), (fo_p[0], *fo_p[1])))
        err_fwd = max(_lstm_check(f"lstm_fwd {nm} {tag}", dtype, a, p, True)
                      for nm, a, p in zip(("h", "i", "f", "o", "blk", "c"),
                                          (hs, *res), (hs_p, *res_p)))
        errs_bwd = {nm: _lstm_check(f"lstm_bwd {nm} {tag}", dtype, a, p, False)
                    for nm, a, p in zip(("dg", "dWr", "dwci", "dwcf", "dwco",
                                         "dh0", "dc0"), bwd, bwd_p)}

        run_fo = lambda: lk.lstm_fwd(xg, wr, *pe, h0, c0,  # noqa: E731
                                     with_residuals=False)
        run_fwd = lambda: lk.lstm_fwd(xg, wr, *pe, h0, c0)  # noqa: E731
        run_bwd = lambda: lk.lstm_bwd(res, wr, *pe, h0, c0, gout, gcl)  # noqa: E731
        plain_fo = lambda: lk.lstm_fwd_plain(  # noqa: E731
            xg, wr, *pe, h0, c0, with_residuals=False)
        plain_fwd = lambda: lk.lstm_fwd_plain(xg, wr, *pe, h0, c0)  # noqa: E731
        plain_bwd = lambda: lk.lstm_bwd_plain(  # noqa: E731
            res, wr, *pe, h0, c0, gout, gcl)
        # yardstick: nn.LSTM at the same b, n, t and dtype, input size 16
        # (its input product is left small), no peepholes
        ref_lstm = torch.nn.LSTM(16, n).to("cuda", dt)
        xs = r(t, b, 16).to(dt)
        hc = (h0[None].contiguous(), c0.to(dt)[None].contiguous())
        go = r(t, b, n).to(dt)

        def lib_fwd():
            with torch.no_grad():
                return ref_lstm(xs, hc)

        def lib_fb():
            out, _ = ref_lstm(xs, hc)
            return torch.autograd.grad(out, list(ref_lstm.parameters()), go)

        reps = 5 if t * b * n >= 1 << 24 else 20
        t_fo = _device_times(torch, run_fo, reps)
        t_fwd = _device_times(torch, run_fwd, reps)
        t_bwd = _device_times(torch, run_bwd, reps)
        lib_f = _device_ms(torch, lib_fwd, reps)
        bounds = _lstm_bounds(dtype, b, t, n)
        row = dict(
            dtype=dtype, b=b, t=t, n=n, err_fwd_only=err_fo, err_fwd=err_fwd,
            err_bwd=errs_bwd,
            fwd_only_ms=_sum_ms(t_fo, "lstm_fwd_kernel"),
            fwd_only_call_device_ms=_sum_ms(t_fo),
            fwd_ms=_sum_ms(t_fwd, "lstm_fwd_kernel"),
            fwd_call_device_ms=_sum_ms(t_fwd),
            bwd_ms=_sum_ms(t_bwd, "lstm_bwd_kernel"),
            dw_ms=_sum_ms(t_bwd, "lstm_dw_kernel"),
            backward_ms=_sum_ms(t_bwd),
            plain_fwd_only_ms=_device_ms(torch, plain_fo, 2),
            plain_fwd_ms=_device_ms(torch, plain_fwd, 2),
            plain_bwd_ms=_device_ms(torch, plain_bwd, 2),
            library_fwd_ms=lib_f,
            library_bwd_ms=_device_ms(torch, lib_fb, reps) - lib_f,
            bounds={k: list(v) for k, v in bounds.items()},
            fwd_only_call_ms=_time_ms(torch, run_fo, reps),
            fwd_call_ms=_time_ms(torch, run_fwd, reps),
            bwd_call_ms=_time_ms(torch, run_bwd, reps),
            plain_fwd_only_call_ms=_time_ms(torch, plain_fo, 2, warmup=1))
        print("lstm " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


@contextlib.contextmanager
def _plain_lstm(lk, fwd=True):
    """Run the fused LSTM scan through the kernels' plain versions on the
    same card tensors, forward (unless ``fwd`` is false) and backward
    (comparisons only)."""
    saved = lk.lstm_fwd, lk.lstm_bwd
    if fwd:
        lk.lstm_fwd = lambda *a, with_residuals=True: lk.lstm_fwd_plain(  # noqa: E731
            *a, with_residuals=with_residuals)
    lk.lstm_bwd = lk.lstm_bwd_plain
    try:
        yield
    finally:
        lk.lstm_fwd, lk.lstm_bwd = saved


def _char_rnn(compute_dtype):
    """The JAX package's char-RNN benchmark stack (``bench.py``
    ``bench_lstm``/``bench_lstm_decode``), built by the port's builder."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    builder = (NeuralNetConfiguration.builder().seed(1).learning_rate(0.01)
               .updater("adam").activation("tanh"))
    if compute_dtype:
        builder = builder.compute_dtype(compute_dtype)
    conf = (builder.list()
            .layer(L.GravesLSTM(n_in=CHAR_VOCAB, n_out=CHAR_HIDDEN))
            .layer(L.GravesLSTM(n_in=CHAR_HIDDEN, n_out=CHAR_HIDDEN))
            .layer(L.RnnOutputLayer(n_in=CHAR_HIDDEN, n_out=CHAR_VOCAB,
                                    activation="softmax",
                                    loss_function="mcxent"))
            .build())
    return MultiLayerNetwork(conf).init()


def char_rnn_flops_per_token(vocab, hidden):
    """``bench.py`` ``bench_lstm``'s count: 3 x 2 x the multiply-adds per
    token of both layers' input and recurrent products and the head."""
    macs = (vocab * 4 * hidden + hidden * 4 * hidden
            + hidden * 4 * hidden + hidden * 4 * hidden + hidden * vocab)
    return 6.0 * macs


def _lstm_launches(kernels, lk):
    return {k: kernels.LAUNCHES.get(k, 0) for k in (
        lk.FWD_ONLY_KERNEL, lk.FWD_KERNEL, lk.BWD_KERNEL, lk.DW_KERNEL)}


def phase_char_serve(torch, np, kernels, lk):
    """Phase 5: char-RNN generation at full width; returns (launches,
    metrics)."""
    from deeplearning4j_tpu_torch.nn import generate as gen_mod
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    net = _char_rnn(None)
    params_from_numpy(net, _random_params(net, seed=21))
    prompts = np.random.default_rng(22).integers(0, CHAR_VOCAB,
                                                 (SERVE_BATCH, SERVE_PROMPT))
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = net.generate(prompts, SERVE_NEW)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _lstm_launches(kernels, lk)
    bucket = gen_mod._pow2_bucket(SERVE_PROMPT)
    want = {lk.FWD_ONLY_KERNEL: 2 * (bucket + SERVE_NEW - 1), lk.FWD_KERNEL: 0,
            lk.BWD_KERNEL: 0, lk.DW_KERNEL: 0}
    _check(launches == want, f"char-RNN generate launches {launches}, "
           f"expected {want}")

    _check(out.shape == (SERVE_BATCH, SERVE_PROMPT + SERVE_NEW),
           f"output shape {out.shape}")
    _check(bool((out[:, :SERVE_PROMPT] == prompts).all()), "prompt echoed")
    _check(bool(((out >= 0) & (out < CHAR_VOCAB)).all()), "token range")
    eager = gen_mod.generate_eager(net, prompts, SERVE_NEW)
    _check(bool((out == eager).all()), "char-RNN generate == generate_eager")

    x = np.eye(CHAR_VOCAB, dtype=np.float32)[prompts]
    probs = net.output(x)
    with _plain_lstm(lk):
        probs_p = net.output(x)
    _check(bool(np.isfinite(probs).all()), "finite output")
    out_err = float(np.abs(probs - probs_p).max())
    _check(out_err <= SERVE_OUT_TOL,
           f"output kernels vs plain: {out_err} > {SERVE_OUT_TOL}")
    net.rnn_clear_previous_state()
    for s in range(SERVE_PROMPT):
        last = net.rnn_time_step(x[:, s])
    net.rnn_clear_previous_state()
    step_err = float(np.abs(last - probs[:, -1]).max())
    _check(step_err <= SERVE_OUT_TOL,
           f"rnn_time_step vs output's last step: {step_err}")

    g = gen_mod.build_generator(net)
    ids = torch.as_tensor(prompts, device="cuda")
    lengths = torch.full((SERVE_BATCH,), SERVE_PROMPT, device="cuda")
    prefill_ms = _time_ms(torch, lambda: g.prefill(net.params, ids, lengths), 5)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.generate(prompts, SERVE_NEW)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    gen_s = statistics.median(times)
    per_gen = _device_times(torch, lambda: net.generate(prompts, SERVE_NEW), 1)
    dev_ms = _sum_ms(per_gen)
    metrics = dict(first_generate_s=first_s, generate_s=gen_s,
                   tokens_per_s=SERVE_BATCH * SERVE_NEW / gen_s,
                   prefill_ms=prefill_ms,
                   decode_ms_per_token=(gen_s * 1e3 - prefill_ms) / (SERVE_NEW - 1),
                   generate_device_ms=dev_ms,
                   device_busy_share=dev_ms / (gen_s * 1e3),
                   profile_kept_share=per_gen.kept_share,
                   lstm_fwd_only_ms_per_generate=_sum_ms(per_gen, "lstm_fwd_kernel"),
                   output_max_abs_diff_vs_plain=out_err,
                   rnn_time_step_max_abs_diff=step_err)
    print("char_serve " + json.dumps(metrics), flush=True)
    return launches, metrics


def _markov_ids(np, rng, b, t):
    """[b, t] ids of a seeded first-order Markov chain over the vocab:
    each id is followed by one fixed successor with probability 0.9,
    else by a uniform draw. Unlike uniform ids (whose loss starts at its
    floor, log vocab, under small random weights) it leaves the net
    something to learn in 20 steps."""
    succ = rng.permutation(CHAR_VOCAB)
    ids = np.empty((b, t), np.int64)
    ids[:, 0] = rng.integers(0, CHAR_VOCAB, b)
    noise = rng.random((b, t)) < 0.1
    draws = rng.integers(0, CHAR_VOCAB, (b, t))
    for s in range(1, t):
        ids[:, s] = np.where(noise[:, s], draws[:, s], succ[ids[:, s - 1]])
    return ids


def _char_train_witness(torch, np, lk, seed, ds):
    """CHAR_STEPS ``fit`` steps through the plain scan on the card from
    the weights of ``seed``; before each, the loss and gradients on the
    same weights through the kernels, and through the forward kernel
    with the plain backward, against the plain scan's. A difference of
    the kernels that builds up over steps shows at the step where it
    does (two free-running trajectories at Adam 0.01 cannot tell it from
    the growth of rounding differences), and the second comparison tells
    the forward's share from the backward's. Read, not gated: the first
    step is gated in phase 6. Returns the plain trajectory's losses and,
    per step, the loss difference and the two worst gradient rel L2."""
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    net = _char_rnn("bfloat16")
    params_from_numpy(net, _random_params(net, seed=seed))
    out = collections.defaultdict(list)
    for s in range(CHAR_STEPS):
        grads, loss = net.gradient_and_score(ds)
        with _plain_lstm(lk, fwd=False):
            grads_f, _ = net.gradient_and_score(ds)
        with _plain_lstm(lk):
            grads_p, loss_p = net.gradient_and_score(ds)
            net.fit(ds)
        out["losses"].append(net.score())
        out["loss_vs_plain"].append(abs(loss - loss_p))
        out["grad_rel_l2_vs_plain"].append(_grad_rel(torch, grads, grads_p))
        out["grad_rel_l2_fwd_kernel_vs_plain"].append(_grad_rel(torch, grads_f, grads_p))
    _check(all(np.isfinite(out["losses"])), f"char-RNN seed {seed}: {dict(out)}")
    return dict(out)


def _grad_rel(torch, grads, grads_p):
    """The worst rel L2, over the layers' gradients, of ``grads`` against
    ``grads_p``, and where it is; inf for a non-finite gradient."""
    worst, at = 0.0, ""
    for layer, gl in grads.items():
        for name, gk in gl.items():
            gp = grads_p[layer][name]
            rel = ((gk - gp).norm() / gp.norm().clamp_min(1e-30)).item()
            if not bool(torch.isfinite(gk).all()):
                rel = float("inf")
            if rel >= worst:
                worst, at = rel, f"{layer}/{name}"
    return worst, at


def _grads_vs_plain(torch, what, grads, grads_p):
    """The worst rel L2 over the layers' gradients of ``grads`` (kernels)
    against ``grads_p`` (plain); fails past CHAR_GRAD_REL or on a
    non-finite gradient."""
    worst, at = _grad_rel(torch, grads, grads_p)
    _check(worst != float("inf"), f"{what}: finite grad {at}")
    _check(worst <= CHAR_GRAD_REL, f"{what}: grad {at} kernels vs plain: rel L2 {worst}")
    return worst


def phase_char_train(torch, np, kernels, lk):
    """Phase 6: char-RNN training at full width; returns (launches,
    metrics)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    net = _char_rnn("bfloat16")
    params_from_numpy(net, _random_params(net, seed=31))
    ids = _markov_ids(np, np.random.default_rng(32), CHAR_BATCH, CHAR_SEQ)
    eye = np.eye(CHAR_VOCAB, dtype=np.float32)
    ds = DataSet(eye[ids], eye[np.roll(ids, -1, axis=1)])

    grads, loss = net.gradient_and_score(ds)
    with _plain_lstm(lk):
        grads_p, loss_p = net.gradient_and_score(ds)
    _check(abs(loss - loss_p) <= CHAR_LOSS_TOL,
           f"char-RNN loss kernels {loss} vs plain {loss_p}")
    worst = _grads_vs_plain(torch, "char-RNN", grads, grads_p)
    del grads, grads_p

    torch.cuda.synchronize()
    kernels.reset_launches()
    net.fit(ds)
    torch.cuda.synchronize()
    launches = _lstm_launches(kernels, lk)
    want = {lk.FWD_ONLY_KERNEL: 0, lk.FWD_KERNEL: 2, lk.BWD_KERNEL: 2,
            lk.DW_KERNEL: 2}
    _check(launches == want, f"char-RNN train step launches {launches}, "
           f"expected {want}")

    losses, times = [net.score()], []
    for _ in range(CHAR_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(net.score())
    _check(all(np.isfinite(losses)), f"finite losses {losses}")
    _check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    step_s = statistics.median(times[1:])
    per_step = _device_times(torch, lambda: net.fit(ds), 3)
    dev = {m: _sum_ms(per_step, m) for m in
           ("", "lstm_fwd_kernel", "lstm_bwd_kernel", "lstm_dw_kernel")}
    # lstm_fwd alone on the step's own layer-0 gates (phase 2b times it on
    # N(0, 1) gates): the kernel's time in and out of the step's context
    p0 = net.cast_params(net.params)["layer0"]
    x0 = torch.as_tensor(ds.features, device="cuda").to(torch.bfloat16)
    xg0 = torch.matmul(x0.transpose(0, 1), p0["Wx"]) + p0["b"]
    zeros = torch.zeros(CHAR_BATCH, CHAR_HIDDEN, dtype=torch.bfloat16,
                        device="cuda")
    fwd_alone = _device_ms(torch, lambda: lk.lstm_fwd(
        xg0, p0["Wr"], p0["wci"], p0["wcf"], p0["wco"], zeros, zeros), 5,
        "lstm_fwd_kernel")
    del x0, xg0
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:12]
    tokens = CHAR_BATCH * CHAR_SEQ
    flops = char_rnn_flops_per_token(CHAR_VOCAB, CHAR_HIDDEN)
    torch.cuda.reset_peak_memory_stats()
    net.fit(ds)
    torch.cuda.synchronize()
    metrics = dict(step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
                   mfu=tokens / step_s * flops / PEAK_FLOPS["bfloat16"],
                   flops_per_token=flops,
                   step_device_ms=dev[""],
                   device_busy_share=dev[""] / (step_s * 1e3),
                   profile_kept_share=per_step.kept_share,
                   lstm_fwd_ms_per_step=dev["lstm_fwd_kernel"],
                   lstm_bwd_ms_per_step=dev["lstm_bwd_kernel"],
                   lstm_dw_ms_per_step=dev["lstm_dw_kernel"],
                   lstm_fwd_ms_alone_on_step_gates=fwd_alone,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   loss_first=losses[0], loss_last=losses[-1],
                   loss_vs_plain=abs(loss - loss_p),
                   grad_rel_l2_vs_plain_max=worst, losses=losses,
                   top_kernels_ms_per_step=[[k[:90], ms] for k, ms in top])
    # the kernels held against the plain scan along the plain scan's own
    # trajectory: these weights and ids, and a second seed of both
    ids2 = _markov_ids(np, np.random.default_rng(34), CHAR_BATCH, CHAR_SEQ)
    ds2 = DataSet(eye[ids2], eye[np.roll(ids2, -1, axis=1)])
    metrics.update(witness_seed31=_char_train_witness(torch, np, lk, 31, ds),
                   witness_seed33=_char_train_witness(torch, np, lk, 33, ds2))
    print("char_train " + json.dumps(metrics), flush=True)
    return launches, metrics


PHASES = ("2", "2b", "3", "4", "5", "6")
# source -> its bf16 kernels, each of whose instantiations must not spill:
# the mma.sync designs keep their tiles, sums and (LSTM) cell state in
# registers
BF16_KERNELS = {"flash_fwd": ("flash_fwd_kernel",),
                "flash_bwd": ("flash_dq_kernel", "flash_dkv_kernel"),
                "lstm_fwd": ("lstm_fwd_kernel",),
                "lstm_bwd": ("lstm_bwd_kernel", "lstm_dw_kernel")}


def _spill_gate(name, report):
    """Phase 1's reading of one source's ``-Xptxas -v`` report: prints
    its registers and spills, and for each of its ``BF16_KERNELS`` the
    registers and spill bytes of every bf16 instantiation; fails if one
    spills or there is none."""
    fns = _ptxas(report)
    regs = [r for _, r, _ in fns]
    spills = [(f[f.find("kernel"):][:60], sp) for f, _, sp in fns if sp]
    print(f"phase 1: {name}.cu ptxas: {len(fns)} kernels, "
          f"{min(regs)}-{max(regs)} registers, spills {spills}", flush=True)
    for kernel in BF16_KERNELS.get(name, ()):
        bf16_fns = [(f, r, sp) for f, r, sp in fns
                    if kernel + "I" in f and "bfloat16" in f]
        print(f"phase 1: bf16 {kernel} registers, spill bytes: "
              f"{[(r, sp) for _, r, sp in bf16_fns]}", flush=True)
        _check(bf16_fns and not any(sp for _, _, sp in bf16_fns),
               f"bf16 {kernel} spills: {bf16_fns}")


def _phases(argv):
    """The phases after 0 and 1 to run: all of them, or ``--only a,b``."""
    if not argv:
        return PHASES
    if len(argv) != 2 or argv[0] != "--only" or \
            not set(argv[1].split(",")) <= set(PHASES):
        raise SystemExit(f"usage: chip_smoke.py [--only {','.join(PHASES)}]")
    return tuple(p for p in PHASES if p in argv[1].split(","))


def main(argv) -> int:
    import numpy as np
    import torch

    phases = _phases(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.ops import flash_attention as flash
    from deeplearning4j_tpu_torch.ops import lstm_kernel as lk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 0: device
    card = _card()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 0: {kind} ({card}), torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)

    # phase 1: build every source, in parallel, from an empty build directory
    shutil.rmtree(kernels.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    reports = kernels.build()
    for name, report in reports.items():
        _spill_gate(name, report)
    print(f"phase 1: built {sorted(reports)} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    done = {}
    if "2" in phases:  # kernels against their plain versions
        done["2"] = phase_kernels(torch, F, flash)
        print(f"phase 2: {len(done['2'])} flash_fwd cases within tolerance",
              flush=True)
        done["2bwd"] = phase_bwd_kernels(torch, F, kernels, flash)
        print(f"phase 2: {len(done['2bwd'])} flash_dq/flash_dkv cases within "
              "tolerance", flush=True)
    if "2b" in phases:
        print(f"clocks: {_clocks()}", flush=True)
        phase_lstm_timer(torch, lk)
        done["2b"] = phase_lstm_kernels(torch, lk)
        print(f"phase 2b: {len(done['2b'])} LSTM cases (lstm_fwd_only, lstm_fwd, "
              "lstm_bwd + lstm_dw) within tolerance", flush=True)
    if "3" in phases:  # serving at full width
        done["3"] = phase_gpt(torch, np, kernels, flash)
        m = done["3"][1]
        print(f"phase 3: gpt generate {m['tokens_per_s']:.1f} tokens/s, "
              f"prefill {m['prefill_ms']:.3f} ms on {card}", flush=True)
    if "4" in phases:  # training at full width
        print(f"clocks: {_clocks()}", flush=True)
        done["4"] = phase_train(torch, np, kernels, flash)
        m = done["4"][1]
        print(f"phase 4: gpt train step {m['step_ms']:.2f} ms, "
              f"{m['tokens_per_s']:.0f} tokens/s, MFU {m['mfu']:.4f}, "
              f"loss {m['loss_first']:.4f} -> {m['loss_last']:.4f} on {card}",
              flush=True)
    if "5" in phases:  # char-RNN serving at full width
        print(f"clocks: {_clocks()}", flush=True)
        done["5"] = phase_char_serve(torch, np, kernels, lk)
        m = done["5"][1]
        print(f"phase 5: char-RNN generate {m['tokens_per_s']:.1f} tokens/s, "
              f"prefill {m['prefill_ms']:.3f} ms on {card}", flush=True)
    if "6" in phases:  # char-RNN training at full width
        print(f"clocks: {_clocks()}", flush=True)
        done["6"] = phase_char_train(torch, np, kernels, lk)
        m = done["6"][1]
        print(f"phase 6: char-RNN train step {m['step_ms']:.2f} ms, "
              f"{m['tokens_per_s']:.0f} tokens/s, MFU {m['mfu']:.4f}, "
              f"loss {m['loss_first']:.4f} -> {m['loss_last']:.4f} on {card}",
              flush=True)
    if phases != PHASES:
        print(f"chip_smoke: ran phases 0, 1, {', '.join(phases)} only; "
              "no result", flush=True)
        return 0

    summary = {"kernels": _flash_summary(done) + _lstm_summary(done, lk)}
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


SRC = "deeplearning4j_tpu_torch/kernels/"


def _flash_summary(done):
    """The flash kernels' entries of the kernels line (phases 2-4)."""
    from deeplearning4j_tpu_torch.ops import flash_attention as flash

    rows, bwd_rows = done["2"], done["2bwd"]
    launches, train_launches = done["3"][0], done["4"][0]
    main_row = next(r for r in rows if r["dtype"] == "bfloat16" and r["d"] == 64
                    and r["tq"] == PROMPT and r["tk"] == PROMPT and r["causal"]
                    and r["bh"] == BATCH * GPT["num_heads"])
    train_bh = TRAIN_BATCH * TRAIN["num_heads"]
    d_head = TRAIN["d_model"] // TRAIN["num_heads"]

    def train_row(rs):
        return next(r for r in rs if r["dtype"] == "bfloat16"
                    and r["d"] == d_head and r["tq"] == TRAIN["max_len"]
                    and r["tk"] == TRAIN["max_len"] and r["causal"]
                    and r["bh"] == train_bh)

    fwd_train, bwd_row = train_row(rows), train_row(bwd_rows)

    def wide_row(rs):
        d, bh, t = WIDE_HEAD
        return next(r for r in rs if r["dtype"] == "bfloat16" and r["d"] == d
                    and r["bh"] == bh and r["tq"] == t and r["causal"])

    def wide(r, key, err):
        """a wide head's numbers ([32, 1024, 256] bf16 causal, the SIMT
        design): this kernel's time beside the plain version and the
        library call (SDPA; its whole backward for the two backward
        kernels)"""
        return {"ms": r[f"{key}kernel_only_ms"], "plain_ms": r["plain_ms"],
                "library_ms": r["library_ms"], "max_abs_err": err,
                "bound_ms": r[f"{key}bound_ms"], "bound_by": r[f"{key}bound_by"],
                "shape": [r["bh"], r["tq"], r["d"]]}

    fwd_wide, bwd_wide = wide_row(rows), wide_row(bwd_rows)
    return [{
        "name": flash.KERNEL, "route": "cuda",
        "source": SRC + "flash_fwd.cu",
        "replaces": "deeplearning4j_tpu/ops/flash_attention.py:150",
        "launches": launches.get(flash.KERNEL, 0),
        "max_abs_err": main_row["err_o"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "kernel_only_ms": main_row["kernel_only_ms"],
        "bound_share": main_row["bound_ms"] / main_row["kernel_only_ms"],
        "shape": [main_row["bh"], main_row["tq"], main_row["d"]],
        "max_abs_err_all_cases": max(r["err_o"] for r in rows),
        "train_launches": train_launches.get(flash.KERNEL, 0),
        # the same numbers at the training path's shape
        "train": {k: fwd_train[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "kernel_only_ms", "kernel_only_ms_by_block_q")}
        | {"max_abs_err": fwd_train["err_o"],
           "bound_share": fwd_train["bound_ms"] / fwd_train["kernel_only_ms"],
           "shape": [train_bh, TRAIN["max_len"], d_head]},
        "wide_head": wide(fwd_wide, "", fwd_wide["err_o"]),
    }] + [{
        "name": name, "route": "cuda", "source": SRC + "flash_bwd.cu",
        "replaces": f"deeplearning4j_tpu/ops/flash_attention.py:{line}",
        "launches": train_launches.get(name, 0),
        "max_abs_err": max(bwd_row[f"err_{g}"] for g in grads),
        "ms": bwd_row[f"{key}_kernel_only_ms"],
        "kernel_only_ms": bwd_row[f"{key}_kernel_only_ms"],
        "bound_share": bwd_row[f"{key}_bound_ms"]
        / bwd_row[f"{key}_kernel_only_ms"],
        # the plain backward and SDPA's backward compute dq, dk and dv
        # together: plain_ms and library_ms are the whole backward's time,
        # to be read beside backward_ms (this port's whole backward call)
        "plain_ms": bwd_row["plain_ms"],
        "backward_ms": bwd_row["ms"],
        "bound_ms": bwd_row[f"{key}_bound_ms"],
        "bound_by": bwd_row[f"{key}_bound_by"],
        "library_ms": bwd_row["library_ms"],
        "shape": [train_bh, TRAIN["max_len"], d_head],
        "max_abs_err_all_cases": max(r[f"err_{g}"] for r in bwd_rows
                                     for g in grads),
        "wide_head": wide(bwd_wide, f"{key}_",
                          max(bwd_wide[f"err_{g}"] for g in grads))
        | {"backward_ms": bwd_wide["ms"]},
    } for name, line, key, grads in (
        (flash.DQ_KERNEL, 220, "dq", ("dq",)),
        (flash.DKV_KERNEL, 252, "dkv", ("dk", "dv")))]


def _lstm_summary(done, lk):
    """The LSTM kernels' entries of the kernels line (phases 2b, 5, 6):
    ``lstm_fwd_only`` at the serving shape, the training kernels at the
    training shape. The plain backward and the yardstick's backward
    compute every gradient together: read their plain_ms and library_ms
    beside backward_ms (the whole lstm_bwd call: sweep and weights)."""
    rows = done["2b"]
    serve_launches, train_launches = done["5"][0], done["6"][0]

    def row(dtype, b, t, n):
        return next(r for r in rows if (r["dtype"], r["b"], r["t"], r["n"])
                    == (dtype, b, t, n))

    serve = row("float32", SERVE_BATCH, 1, CHAR_HIDDEN)
    train = row("bfloat16", CHAR_BATCH, CHAR_SEQ, CHAR_HIDDEN)
    replaces = "deeplearning4j_tpu/ops/lstm_kernel.py:"
    entries = []
    for name, r, line, key, err, plain, lib, src in (
            (lk.FWD_ONLY_KERNEL, serve, 101, "fwd_only", "err_fwd_only",
             "plain_fwd_only_ms", "library_fwd_ms", "lstm_fwd.cu"),
            (lk.FWD_KERNEL, train, 86, "fwd", "err_fwd", "plain_fwd_ms",
             "library_fwd_ms", "lstm_fwd.cu"),
            (lk.BWD_KERNEL, train, 181, "bwd", None, "plain_bwd_ms",
             "library_bwd_ms", "lstm_bwd.cu"),
            (lk.DW_KERNEL, train, 181, "dw", None, "plain_bwd_ms",
             "library_bwd_ms", "lstm_bwd.cu")):
        bound_ms, bound_by = r["bounds"][name]
        errs = (lambda x: x[err]) if err else (lambda x: max(x["err_bwd"].values()))
        entry = {
            "name": name, "route": "cuda", "source": SRC + src,
            "replaces": replaces + str(line),
            "launches": serve_launches[name] if name == lk.FWD_ONLY_KERNEL
            else train_launches[name],
            "max_abs_err": errs(r), "ms": r[f"{key}_ms"], "plain_ms": r[plain],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": r[lib],
            "shape": [r["b"], r["t"], r["n"], r["dtype"]],
            "max_abs_err_all_cases": max(errs(x) for x in rows),
            "serve_launches": serve_launches[name],
            "train_launches": train_launches[name],
        }
        if key in ("bwd", "dw"):
            entry["backward_ms"] = r["backward_ms"]
        entries.append(entry)
    return entries


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
