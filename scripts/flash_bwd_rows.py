#!/usr/bin/env python3
"""The PyTorch port's flash backward in another checkout (the parent of
a change, say), timed at ``chip_smoke.py``'s wide-head backward rows
(``WIDE_HEAD_CASES``' bf16 rows, ``WIDE_512_CASES``,
``WIDE_F32_512_CASES``, ``WIDE_F32_1024_CASES``, ``WIDE_1024_CASES``) by
phase 2's own measurement (``chip_smoke.bwd_row``), and its f32 forward's and
backward's errors at scores of ±60 (``chip_smoke.scale4_row``, not
gated): a same-card comparison of those rows alone, some of which the
other checkout's ``chip_smoke.py`` does not have.

    python3 scripts/flash_bwd_rows.py DIR    # DIR: the other checkout's root

Prints one ``flash_bwd {...}`` line per row, as phase 2 does, whose
``kernels`` names what that checkout's backward ran (its output is held
against the plain version of that checkout at phase 2's tolerances),
then phase 2's ``flash_bwd_scale4`` lines.
Needs an NVIDIA GPU; imports nothing of JAX.
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
    if len(argv) != 1:
        raise SystemExit("usage: flash_bwd_rows.py DIR")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_rows: torch.cuda.is_available() is false: this "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    smoke = _smoke()
    root = os.path.abspath(argv[0])
    sys.path.insert(0, root)
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.ops import flash_attention as flash

    if not flash.__file__.startswith(root + os.sep):
        raise SystemExit(f"flash_bwd_rows: imported {flash.__file__}, not "
                         f"the port under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(4321)
    for case in (smoke.WIDE_HEAD_CASES["bfloat16"] + smoke.WIDE_512_CASES
                 + smoke.WIDE_F32_512_CASES + smoke.WIDE_F32_1024_CASES
                 + smoke.WIDE_1024_CASES):
        row = smoke.bwd_row(torch, F, kernels, flash, g, case, None)
        print("flash_bwd " + json.dumps(row | {"root": root}), flush=True)
    for d in smoke.SCALE4_HEADS:
        row = smoke.scale4_row(torch, np, flash, d)
        print("flash_bwd_scale4 " + json.dumps(row | {"root": root}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
