#!/usr/bin/env python3
"""Smoke test of the PyTorch port (deeplearning4j_tpu_torch) on one
NVIDIA GPU; the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result):

0. device: the card's name and power limit (nvidia-smi); fails without
   CUDA.
1. build: every kernel of the path from the sources in this checkout,
   from an empty build directory, timed.
2. kernels: each kernel's wrapper on card tensors against its plain
   PyTorch version on the same inputs, at the main path's shape and at
   larger ones, with stated tolerances; median times beside the plain
   version, the one PyTorch call that computes the same function (a
   yardstick only, never used by the port) and the least time the card
   could take (the bound). ``ms`` columns are device time (torch.profiler:
   the card's work per call); ``call_ms`` columns are CUDA-event time per
   single call, which includes the host's launch work.
3. the slice at full width: ``gpt`` (vocab 8192, d_model 512, 8 layers,
   8 heads, max_len 512, bf16) with random weights from a numpy seed,
   greedy ``generate`` of 128 tokens for 8 prompts of 64. Launch counts
   are zeroed right before this run and read right after it; every
   kernel of the path must have launched. ``generate`` must equal
   ``generate_eager``, the prefill logits must agree with the same net
   run with the plain attention, and everything must be finite.

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


def _device_ms(torch, fn, reps: int, match: str = "") -> float:
    """Device time per call: the summed durations of every kernel, copy
    and fill (whose name contains ``match``) that ``reps`` calls put on
    the card (torch.profiler), over ``reps``. Unlike the event time it
    leaves out the host's share."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if match in e.key)
    _check(us > 0, "torch.profiler recorded no device time")
    return us / 1e3 / reps


def _card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _flash_bound(bh, tq, tk, d, causal, dtype):
    """(bound_ms, bound_by): the work this input needs (the (q, k) pairs
    the causal mask leaves, at 4 d flops each) over the peak rate of its
    type, or its bytes (q, k, v read once, o and lse written once) over
    the memory rate, whichever is larger."""
    offset = tk - tq
    pairs = sum(min(tk, r + offset + 1) for r in range(tq)) if causal \
        else tq * tk
    flops = 4.0 * bh * d * pairs
    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * bh * d * (2 * tq + 2 * tk) + 4 * bh * tq
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels(torch, F, flash):
    """Phase 2: the flash kernel against its plain version."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(1234)
    cases = []
    for dtype in ("bfloat16", "float32"):
        for d in (64, 128):
            for t, bh in ((64, 64), (512, 16), (2048, 8)):
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
        mask = torch.ones(tq, tk, dtype=torch.bool,
                          device="cuda").tril(tk - tq) if causal else None
        kernel = lambda: flash.flash_attention_fwd(q, k, v, causal)  # noqa: E731
        plain = lambda: flash.flash_attention_fwd_plain(q, k, v, causal)  # noqa: E731
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask)
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
    """Swap the blocks' attention for the flash kernel's plain version on
    the same card tensors (the comparison of phase 3 only)."""
    saved = transformer.dispatch_attention

    def plain(q, k, v, causal, mask=None):
        b, t, h, d = q.shape
        fold = lambda z: z.transpose(1, 2).reshape(b * h, t, d)  # noqa: E731
        o, _ = flash.flash_attention_fwd_plain(fold(q), fold(k), fold(v), causal)
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

    # phase 1: build from an empty build directory
    shutil.rmtree(kernels.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    kernels.load(flash.KERNEL)
    print(f"phase 1: built {flash.KERNEL} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # phase 2: kernels against their plain versions
    rows = phase_kernels(torch, F, flash)
    print(f"phase 2: {len(rows)} flash_fwd cases within tolerance", flush=True)

    # phase 3: the slice at full width
    launches, metrics = phase_gpt(torch, np, kernels, flash)
    print(f"phase 3: gpt generate {metrics['tokens_per_s']:.1f} tokens/s, "
          f"prefill {metrics['prefill_ms']:.3f} ms on {card}", flush=True)

    main_row = next(r for r in rows if r["dtype"] == "bfloat16" and r["d"] == 64
                    and r["tq"] == PROMPT and r["tk"] == PROMPT and r["causal"]
                    and r["bh"] == BATCH * GPT["num_heads"])
    summary = {"kernels": [{
        "name": flash.KERNEL, "route": "cuda",
        "source": "deeplearning4j_tpu_torch/kernels/flash_fwd.cu",
        "replaces": "deeplearning4j_tpu/ops/flash_attention.py:150",
        "launches": launches.get(flash.KERNEL, 0),
        "max_abs_err": main_row["err_o"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": [main_row["bh"], main_row["tq"], main_row["d"]],
        "max_abs_err_all_cases": max(r["err_o"] for r in rows),
    }]}
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
