#!/usr/bin/env python3
"""Smoke test of the PyTorch port (deeplearning4j_tpu_torch) on one
NVIDIA GPU; the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result):

0. device: the card's name and power limit (nvidia-smi); fails without
   CUDA.
1. build: every kernel source in this checkout, one ``nvcc`` each, all
   started together, from an empty build directory, timed.
2. kernels: each kernel's wrapper on card tensors against its plain
   PyTorch version on the same inputs, at the main paths' shapes and at
   larger ones, with stated tolerances; median times beside the plain
   version, the one PyTorch call that computes the same function (a
   yardstick only, never used by the port) and the least time the card
   could take (the bound). ``ms`` columns are device time (torch.profiler:
   the card's work per call); ``call_ms`` columns are CUDA-event time per
   single call, which includes the host's launch work. The forward
   (``flash_fwd``) first, then the backward (``flash_dq``, ``flash_dkv``).
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
   that fall; step time, tokens/s, MFU, the device busy share and the
   attention kernels' device time per step are printed.

The last lines are the card's name and power limit, one JSON object
with every kernel's numbers, and ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
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
# one step's loss and gradients with the kernels vs with the plain
# versions on the card: bf16 attention outputs and gradients that differ
# by bf16 roundings pass through 8 bf16 layers
TRAIN_LOSS_TOL, TRAIN_GRAD_REL = 1e-2, 2e-2


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


def _device_times(torch, fn, reps: int) -> dict:
    """Device ms per call of ``fn`` for each kernel, copy and fill name
    that torch.profiler saw in ``reps`` calls (after one warm-up call).
    Unlike the event time it leaves out the host's share. A profile that
    recorded no device time at all is taken again, up to three times,
    then fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per_name = {e.key: e.self_device_time_total / 1e3 / reps
                    for e in prof.key_averages()
                    if e.self_device_time_total > 0}
        if per_name:
            return per_name
    raise RuntimeError("chip_smoke: check failed: torch.profiler recorded "
                       "no device time")


def _sum_ms(per_name: dict, match: str = "") -> float:
    """The device ms of the names in ``per_name`` that contain ``match``
    (all of them by default); fails where there are none."""
    ms = sum(t for name, t in per_name.items() if match in name)
    _check(ms > 0, f"torch.profiler recorded no device time for {match!r}")
    return ms


def _device_ms(torch, fn, reps: int, match: str = "") -> float:
    """Device ms per call of ``fn``, of the names containing ``match``."""
    return _sum_ms(_device_times(torch, fn, reps), match)


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
    or its bytes (qs, k, v, dO read once, lse and delta once, ``n_out``
    [.., d] outputs written once) over the memory rate."""
    flops = float(flops_per_pair) * bh * _live_pairs(tq, tk, causal)
    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * bh * d * (2 * tq + 2 * tk) + 8 * bh * tq \
        + size * bh * d * (tq if n_out == 1 else 2 * tk)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_bwd_kernels(torch, F, flash):
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
    for dtype, d, bh, tq, tk, causal in cases:
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.randn(bh, t, d, generator=g, device="cuda").to(dt)
                       for t in (tq, tk, tk, tq))
        o, lse = flash.flash_attention_fwd(q, k, v, causal)
        blocks = (flash._bwd_block(tq, 1024 if causal else 512),
                  flash._bwd_block(tk, 1024))
        got = flash.flash_attention_bwd(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        want = flash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                               *blocks)
        errs = {}
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            _check(bool(torch.isfinite(a.float()).all()), f"finite {name}")
            err = (a.float() - b.float()).abs().max().item()
            ref = b.float().abs().max().item()
            tol = BWD_TOL_F32 if dtype == "float32" else BWD_REL_BF16 * ref
            _check(err <= tol, f"flash bwd {name} {dtype} d{d} bh{bh} tq{tq} "
                   f"tk{tk} causal={causal}: err {err} > tol {tol}")
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
                   ms=_sum_ms(times), dq_ms=_sum_ms(times, "flash_dq_kernel"),
                   dkv_ms=_sum_ms(times, "flash_dkv_kernel"),
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
    for dtype, d, bh, tq, tk, causal in cases:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(bh, t, d, generator=g, device="cuda").to(dt)
                   for t in (tq, tk, tk))
        o, lse = flash.flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        op, lp = flash.flash_attention_fwd_plain(q, k, v, causal)
        err_o = (o.float() - op.float()).abs().max().item()
        err_l = (lse - lp).abs().max().item()
        tol_o, tol_l = TOL[dtype]
        _check(bool(torch.isfinite(o.float()).all()), f"finite o {dtype} d{d}")
        _check(err_o <= tol_o and err_l <= tol_l,
               f"flash {dtype} d{d} bh{bh} tq{tq} tk{tk} causal={causal}: "
               f"o err {err_o} (tol {tol_o}), lse err {err_l} (tol {tol_l})")
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
        row = dict(dtype=dtype, bh=bh, tq=tq, tk=tk, d=d, causal=causal,
                   err_o=err_o, err_lse=err_l,
                   ms=_device_ms(torch, kernel, 20),
                   kernel_only_ms=_device_ms(torch, kernel, 20,
                                             match="flash_fwd_kernel"),
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
    gen_device_ms = _device_ms(torch, lambda: net.generate(prompts, NEW), 1)
    metrics = dict(generate_device_ms=gen_device_ms,
                   device_busy_share=gen_device_ms / (gen_s * 1e3),first_generate_s=first_s, generate_s=gen_s,
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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.ops import flash_attention as flash

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
        regs = sorted({ln.split("Used ")[1] for ln in report.splitlines()
                       if "Used " in ln})
        print(f"phase 1: {name}.cu ptxas: {regs}", flush=True)
    print(f"phase 1: built {sorted(reports)} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # phase 2: kernels against their plain versions
    rows = phase_kernels(torch, F, flash)
    print(f"phase 2: {len(rows)} flash_fwd cases within tolerance", flush=True)
    bwd_rows = phase_bwd_kernels(torch, F, flash)
    print(f"phase 2: {len(bwd_rows)} flash_dq/flash_dkv cases within tolerance",
          flush=True)

    # phase 3: serving at full width
    launches, metrics = phase_gpt(torch, np, kernels, flash)
    print(f"phase 3: gpt generate {metrics['tokens_per_s']:.1f} tokens/s, "
          f"prefill {metrics['prefill_ms']:.3f} ms on {card}", flush=True)

    # phase 4: training at full width
    train_launches, train = phase_train(torch, np, kernels, flash)
    print(f"phase 4: gpt train step {train['step_ms']:.2f} ms, "
          f"{train['tokens_per_s']:.0f} tokens/s, MFU {train['mfu']:.4f}, "
          f"loss {train['loss_first']:.4f} -> {train['loss_last']:.4f} on {card}",
          flush=True)

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
    src = "deeplearning4j_tpu_torch/kernels/"
    summary = {"kernels": [{
        "name": flash.KERNEL, "route": "cuda",
        "source": src + "flash_fwd.cu",
        "replaces": "deeplearning4j_tpu/ops/flash_attention.py:150",
        "launches": launches.get(flash.KERNEL, 0),
        "max_abs_err": main_row["err_o"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": [main_row["bh"], main_row["tq"], main_row["d"]],
        "max_abs_err_all_cases": max(r["err_o"] for r in rows),
        "train_launches": train_launches.get(flash.KERNEL, 0),
        # the same numbers at the training path's shape
        "train": {k: fwd_train[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        | {"max_abs_err": fwd_train["err_o"],
           "shape": [train_bh, TRAIN["max_len"], d_head]},
    }] + [{
        "name": name, "route": "cuda", "source": src + "flash_bwd.cu",
        "replaces": f"deeplearning4j_tpu/ops/flash_attention.py:{line}",
        "launches": train_launches.get(name, 0),
        "max_abs_err": max(bwd_row[f"err_{g}"] for g in grads),
        "ms": bwd_row[f"{key}_ms"],
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
    } for name, line, key, grads in (
        (flash.DQ_KERNEL, 220, "dq", ("dq",)),
        (flash.DKV_KERNEL, 252, "dkv", ("dk", "dv")))]}
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
