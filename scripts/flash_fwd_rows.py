#!/usr/bin/env python3
"""The PyTorch port's flash forward in another checkout (the parent of a
change, say), timed at ``chip_smoke.py``'s bf16 rows at d 1024
(``WIDE_1024_CASES``) by phase 2's own measurement
(``chip_smoke.fwd_row``): a same-card comparison at rows that the
other checkout's ``chip_smoke.py`` does not have.

    python3 scripts/flash_fwd_rows.py DIR    # DIR: the other checkout's root

Prints one ``flash_fwd {...}`` line per row, as phase 2 does, whose
``kernels`` names what that checkout's forward ran; its output is held
against the plain version of that checkout at phase 2's tolerances.
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
        raise SystemExit("usage: flash_fwd_rows.py DIR")
    import torch

    if not torch.cuda.is_available():
        print("flash_fwd_rows: torch.cuda.is_available() is false: this "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    smoke = _smoke()
    root = os.path.abspath(argv[0])
    sys.path.insert(0, root)
    from deeplearning4j_tpu_torch.ops import flash_attention as flash

    if not flash.__file__.startswith(root + os.sep):
        raise SystemExit(f"flash_fwd_rows: imported {flash.__file__}, not "
                         f"the port under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1234)
    for case in smoke.WIDE_1024_CASES:
        row = smoke.fwd_row(torch, F, flash, g, case, None)
        print("flash_fwd " + json.dumps(row | {"root": root}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
