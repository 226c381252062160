"""Activation functions.

Counterpart of ``deeplearning4j_tpu/ops/activations.py``: every
string-keyed activation of the reference, elementwise in torch ops
(softmax over an axis). ``rrelu`` is the leaky ReLU of slope 0.01, as in
the reference, which uses that slope in training too.
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, Union

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


def _rationaltanh(x: torch.Tensor) -> torch.Tensor:
    """1.7159 * tanh_approx(2x/3), tanh_approx(y) = sign(y) * (1 - 1 /
    (1 + |y| + y^2 + 1.41645 y^4)) (ND4J's RationalTanh)."""
    y = 2.0 * x / 3.0
    a = torch.abs(y)
    approx = torch.sign(y) * (1.0 - 1.0 / (1.0 + a + y * y + 1.41645 * y ** 4))
    return 1.7159 * approx


_FUNCS: Dict[Activation, Callable[[torch.Tensor], torch.Tensor]] = {
    Activation.IDENTITY: lambda x: x,
    Activation.SIGMOID: torch.sigmoid,
    Activation.TANH: torch.tanh,
    Activation.RELU: torch.relu,
    Activation.LEAKYRELU: lambda x: F.leaky_relu(x, negative_slope=0.01),
    Activation.SOFTPLUS: lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    Activation.SOFTSIGN: lambda x: x / (1.0 + torch.abs(x)),
    Activation.ELU: F.elu,
    Activation.HARDTANH: lambda x: torch.clamp(x, -1.0, 1.0),
    Activation.HARDSIGMOID: F.hardsigmoid,
    Activation.CUBE: lambda x: x ** 3,
    Activation.RATIONALTANH: _rationaltanh,
    Activation.RRELU: lambda x: F.leaky_relu(x, negative_slope=0.01),
    Activation.GELU: lambda x: F.gelu(x, approximate="none"),
    Activation.SILU: F.silu,
}


def activate(name: Union[str, Activation], x: torch.Tensor,
             axis: int = -1) -> torch.Tensor:
    """Apply activation ``name`` to ``x``; softmax normalizes over
    ``axis``. ``gelu`` is the exact (erf) form, as the reference's
    activation of that name."""
    act = Activation(name)
    if act is Activation.SOFTMAX:
        return torch.softmax(x, dim=axis)
    return _FUNCS[act](x)
