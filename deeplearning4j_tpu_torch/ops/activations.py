"""Activation functions.

Counterpart of ``deeplearning4j_tpu/ops/activations.py``. The config
accepts every name the reference knows; this slice implements the ones
the GPT serving path uses (identity, softmax, gelu) and raises
``NotImplementedError`` for the rest.
"""

from __future__ import annotations

import enum
from typing import Union

import torch
import torch.nn.functional as F


class Activation(str, enum.Enum):
    """String-keyed activation names (as the reference's)."""

    IDENTITY = "identity"
    SIGMOID = "sigmoid"
    TANH = "tanh"
    RELU = "relu"
    LEAKYRELU = "leakyrelu"
    SOFTMAX = "softmax"
    SOFTPLUS = "softplus"
    SOFTSIGN = "softsign"
    ELU = "elu"
    HARDTANH = "hardtanh"
    HARDSIGMOID = "hardsigmoid"
    CUBE = "cube"
    RATIONALTANH = "rationaltanh"
    RRELU = "rrelu"
    GELU = "gelu"
    SILU = "silu"


def activate(name: Union[str, Activation], x: torch.Tensor,
             axis: int = -1) -> torch.Tensor:
    """Apply activation ``name`` to ``x``; softmax normalizes over
    ``axis``. ``gelu`` is the exact (erf) form, as the reference's
    activation of that name."""
    act = Activation(name)
    if act is Activation.IDENTITY:
        return x
    if act is Activation.SOFTMAX:
        return torch.softmax(x, dim=axis)
    if act is Activation.GELU:
        return F.gelu(x, approximate="none")
    raise NotImplementedError(
        f"activation {act.value!r} is not ported yet (this slice has "
        "identity, softmax and gelu)")
