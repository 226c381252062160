#!/usr/bin/env python3
"""One of phase 4's f32 training steps (``chip_smoke.F32_STEPS``:
``train_f32``, the default, or ``train_wide_f32``) through the PyTorch
port of another checkout (the parent of a change, say): the same step,
weights and ids as ``chip_smoke.py``'s, its loss and gradients through
that checkout's flash kernels against its plain attention (the noise
floor of the comparison for that checkout's kernels), and the step's
device time with its flash kernels' share.

    python3 scripts/f32_train_step.py DIR [STEP]   # DIR: the other checkout's root

Prints one ``f32_train_step {...}`` line. Needs an NVIDIA GPU; imports
nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys


def _smoke():
    """This checkout's chip_smoke.py as a module."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv) -> int:
    if len(argv) not in (1, 2):
        raise SystemExit("usage: f32_train_step.py DIR [STEP]")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("f32_train_step: torch.cuda.is_available() is false: this "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smoke = _smoke()
    step = argv[1] if len(argv) == 2 else "train_f32"
    if step not in smoke.F32_STEPS:
        raise SystemExit(f"f32_train_step: STEP is one of {sorted(smoke.F32_STEPS)}")
    root = os.path.abspath(argv[0])
    sys.path.insert(0, root)
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.ops import flash_attention as flash

    if not flash.__file__.startswith(root + os.sep):
        raise SystemExit(f"f32_train_step: imported {flash.__file__}, not "
                         f"the port under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net, ds, launches, loss, loss_p, worst, at = smoke.f32_step(
        torch, np, kernels, flash, step)
    per_step = smoke._device_times(torch, lambda: net.gradient_and_score(ds), 3)
    step_ms = smoke._sum_ms(per_step)
    flash_ms = {m: smoke._sum_ms(per_step, m) for m in (
        "flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")}
    print("f32_train_step " + json.dumps(dict(
        root=root, step=step, launches=launches, loss=loss,
        loss_rel_vs_plain=abs(loss - loss_p) / abs(loss_p),
        grad_rel_l2_vs_plain_max=worst, grad_worst_at=at,
        step_device_ms=step_ms, profile_kept_share=per_step.kept_share,
        flash_ms_per_step=flash_ms,
        flash_kernels=sorted(n for n in per_step if "flash_" in n))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
