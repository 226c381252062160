"""Weight initialization schemes.

Counterpart of ``deeplearning4j_tpu/nn/weights.py``: the same config
values (``WeightInit``, ``Distribution``), drawn from an explicit
``torch.Generator``. The draws cannot equal ``jax.random``'s, so parity
with the reference always starts from carried-over weights.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Sequence, Union

import torch


@dataclasses.dataclass(frozen=True)
class Distribution:
    """Weight-init distribution, selected with ``WeightInit.DISTRIBUTION``
    through a layer's ``dist`` field; serializes as a plain dict."""

    kind: str = "normal"  # normal | uniform | binomial
    mean: float = 0.0
    std: float = 1.0
    lower: float = -1.0
    upper: float = 1.0
    n: int = 1
    p: float = 0.5

    @staticmethod
    def normal(mean: float = 0.0, std: float = 1.0) -> "Distribution":
        return Distribution(kind="normal", mean=mean, std=std)

    @staticmethod
    def uniform(lower: float, upper: float) -> "Distribution":
        return Distribution(kind="uniform", lower=lower, upper=upper)

    @staticmethod
    def binomial(n: int, p: float) -> "Distribution":
        return Distribution(kind="binomial", n=n, p=p)

    @staticmethod
    def from_dict(d) -> "Distribution":
        names = {f.name for f in dataclasses.fields(Distribution)}
        return Distribution(**{k: v for k, v in d.items() if k in names})

    def sample(self, gen: torch.Generator, shape, device) -> torch.Tensor:
        if self.kind == "normal":
            return self.mean + self.std * _normal(gen, shape, device)
        if self.kind == "uniform":
            return _uniform(gen, shape, device, self.lower, self.upper)
        if self.kind == "binomial":
            probs = torch.full(tuple(shape), float(self.p), device=device)
            return torch.binomial(torch.full_like(probs, float(self.n)),
                                  probs, generator=gen)
        raise ValueError(f"unknown distribution kind {self.kind!r}")


class WeightInit(str, enum.Enum):
    ZERO = "zero"
    ONES = "ones"
    UNIFORM = "uniform"  # U(-1/sqrt(fanIn), 1/sqrt(fanIn))
    NORMALIZED = "normalized"  # U(-1,1) / fanIn
    XAVIER = "xavier"  # N(0, 2/(fanIn+fanOut))
    XAVIER_UNIFORM = "xavier_uniform"  # U(+-sqrt(6/(fanIn+fanOut)))
    XAVIER_FAN_IN = "xavier_fan_in"  # N(0, 1/fanIn)
    RELU = "relu"  # He: N(0, 2/fanIn)
    RELU_UNIFORM = "relu_uniform"  # U(+-sqrt(6/fanIn))
    SIGMOID_UNIFORM = "sigmoid_uniform"  # U(+-4*sqrt(6/(fanIn+fanOut)))
    LECUN_NORMAL = "lecun_normal"  # N(0, 1/fanIn)
    DISTRIBUTION = "distribution"  # explicit (mean, std) normal
    NORMAL = "normal"  # N(0, 1/sqrt(fanIn))


def _normal(gen, shape, device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=device)


def _uniform(gen, shape, device, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=gen, device=device)
    return lo + (hi - lo) * u


def init_weights(
    gen: torch.Generator,
    shape: Sequence[int],
    scheme: Union[str, WeightInit],
    fan_in: float,
    fan_out: float,
    dist_mean: float = 0.0,
    dist_std: float = 1.0,
    dist: Optional[Distribution] = None,
    device: Union[str, torch.device] = "cpu",
) -> torch.Tensor:
    """A float32 weight tensor of ``shape`` drawn from ``gen``."""
    s = WeightInit(scheme)
    shape = tuple(int(d) for d in shape)
    if s is WeightInit.ZERO:
        return torch.zeros(shape, device=device)
    if s is WeightInit.ONES:
        return torch.ones(shape, device=device)
    if s is WeightInit.UNIFORM:
        a = 1.0 / math.sqrt(fan_in)
        return _uniform(gen, shape, device, -a, a)
    if s is WeightInit.NORMALIZED:
        return _uniform(gen, shape, device, -1.0, 1.0) / fan_in
    if s is WeightInit.XAVIER:
        return math.sqrt(2.0 / (fan_in + fan_out)) * _normal(gen, shape, device)
    if s is WeightInit.XAVIER_UNIFORM:
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, device, -a, a)
    if s in (WeightInit.XAVIER_FAN_IN, WeightInit.LECUN_NORMAL):
        return math.sqrt(1.0 / fan_in) * _normal(gen, shape, device)
    if s is WeightInit.RELU:
        return math.sqrt(2.0 / fan_in) * _normal(gen, shape, device)
    if s is WeightInit.RELU_UNIFORM:
        a = math.sqrt(6.0 / fan_in)
        return _uniform(gen, shape, device, -a, a)
    if s is WeightInit.SIGMOID_UNIFORM:
        a = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, device, -a, a)
    if s is WeightInit.DISTRIBUTION:
        if dist is not None:
            return dist.sample(gen, shape, device)
        return dist_mean + dist_std * _normal(gen, shape, device)
    if s is WeightInit.NORMAL:
        return (1.0 / math.sqrt(fan_in)) * _normal(gen, shape, device)
    raise ValueError(f"unknown weight init {scheme}")
