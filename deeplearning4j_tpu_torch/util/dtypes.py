"""Mixed-precision policy helpers.

Counterpart of ``deeplearning4j_tpu/util/dtypes.py``. Parameters stay
float32; layer compute runs in the configured compute dtype, the
parameters being cast per call; the output head produces float32 logits.
"""

from __future__ import annotations

from typing import Any, Optional

import torch


def resolve_compute_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """Config string -> cast target; None means "no casting" (float32
    parameters already are the compute dtype)."""
    if name in ("float32", "f32", None, ""):
        return None
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name in ("float16", "f16"):
        return torch.float16
    raise ValueError(f"unknown compute_dtype {name!r}")


def cast_floats(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating tensor of a (nested) dict to ``dtype``;
    integer and boolean tensors are left as they are."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def cast_like(new_tree: Any, old_tree: Any) -> Any:
    """Cast the floating tensors of ``new_tree`` back to the dtypes of
    the same entries of ``old_tree``: carried state keeps its stored
    dtype whatever the compute dtype."""
    if isinstance(new_tree, dict) and isinstance(old_tree, dict):
        return {k: cast_like(v, old_tree[k]) if k in old_tree else v
                for k, v in new_tree.items()}
    if (isinstance(new_tree, torch.Tensor) and isinstance(old_tree, torch.Tensor)
            and new_tree.is_floating_point() and old_tree.is_floating_point()
            and new_tree.dtype != old_tree.dtype):
        return new_tree.to(old_tree.dtype)
    return new_tree
