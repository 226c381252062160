"""Input preprocessors: shape adapters between layer families.

Counterpart of ``deeplearning4j_tpu/nn/conf/preprocessors.py``: the same
ten frozen dataclasses and registry, serialized with the same ``@type``
tags, applied as plain tensor reshapes (autograd derives the backward).
CNN activations are NHWC ([b, h, w, c]) and RNN activations
[b, t, f], so ``CnnToFeedForwardPreProcessor`` flattens in h, w, c
order and a following dense layer's ``W`` rows follow that order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Type

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

_PRE_REGISTRY: Dict[str, Type["InputPreProcessor"]] = {}


def register_preprocessor(cls):
    _PRE_REGISTRY[cls.__name__] = cls
    return cls


def preprocessor_from_dict(d: Dict[str, Any]) -> "InputPreProcessor":
    d = dict(d)
    name = d.pop("@type")
    if name == "ComposableInputPreProcessor":
        kids = tuple(preprocessor_from_dict(c) for c in d["children"])
        return _PRE_REGISTRY[name](children=kids)
    for k, v in d.items():
        if isinstance(v, list):
            d[k] = tuple(v)
    return _PRE_REGISTRY[name](**d)


@dataclasses.dataclass(frozen=True)
class InputPreProcessor:
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def output_type(self, in_type: InputType) -> InputType:
        raise NotImplementedError

    def to_dict(self) -> Dict[str, Any]:
        d = {"@type": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            d[f.name] = list(v) if isinstance(v, tuple) else v
        return d


@register_preprocessor
@dataclasses.dataclass(frozen=True)
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """[b, h, w, c] -> [b, h*w*c]."""

    def __call__(self, x):
        return x.reshape(x.shape[0], -1)

    def output_type(self, t):
        return InputType.feed_forward(t.flat_size())


@register_preprocessor
@dataclasses.dataclass(frozen=True)
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """[b, h*w*c] -> [b, h, w, c]."""

    height: int = 1
    width: int = 1
    channels: int = 1

    def __call__(self, x):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, t):
        return InputType.convolutional(self.height, self.width, self.channels)


@register_preprocessor
@dataclasses.dataclass(frozen=True)
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """[b, t, f] -> [b*t, f]: dense layers apply per timestep."""

    def __call__(self, x):
        return x.reshape(-1, x.shape[-1])

    def output_type(self, t):
        # the sequence length rides along, so a later ff -> rnn
        # transition can restore [b, t, f]
        return InputType(kind="ff", size=t.size, timesteps=t.timesteps)


@register_preprocessor
@dataclasses.dataclass(frozen=True)
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """[b*t, f] -> [b, t, f]."""

    timesteps: int = 1

    def __call__(self, x):
        return x.reshape(-1, self.timesteps, x.shape[-1])

    def output_type(self, t):
        return InputType.recurrent(t.size, self.timesteps)


@register_preprocessor
@dataclasses.dataclass(frozen=True)
class CnnToRnnPreProcessor(InputPreProcessor):
    """[b, h, w, c] -> [b, 1, h*w*c], a one-step sequence."""

    def __call__(self, x):
        return x.reshape(x.shape[0], 1, -1)

    def output_type(self, t):
        return InputType.recurrent(t.flat_size(), 1)


@register_preprocessor
@dataclasses.dataclass(frozen=True)
class RnnToCnnPreProcessor(InputPreProcessor):
    """[b, t, h*w*c] -> [b*t, h, w, c]."""

    height: int = 1
    width: int = 1
    channels: int = 1

    def __call__(self, x):
        return x.reshape(-1, self.height, self.width, self.channels)

    def output_type(self, t):
        return InputType.convolutional(self.height, self.width, self.channels)


@register_preprocessor
@dataclasses.dataclass(frozen=True)
class ReshapePreprocessor(InputPreProcessor):
    """Any reshape that keeps the batch."""

    shape: Tuple[int, ...] = ()

    def __call__(self, x):
        return x.reshape((x.shape[0],) + tuple(self.shape))

    def output_type(self, t):
        if len(self.shape) == 1:
            return InputType.feed_forward(self.shape[0])
        if len(self.shape) == 3:
            return InputType.convolutional(*self.shape)
        if len(self.shape) == 2:
            return InputType.recurrent(self.shape[1], self.shape[0])
        raise ValueError(self.shape)


@register_preprocessor
@dataclasses.dataclass(frozen=True)
class ZeroMeanPrePreProcessor(InputPreProcessor):
    """Subtract each example's mean."""

    def __call__(self, x):
        return x - torch.mean(x, dim=tuple(range(1, x.ndim)), keepdim=True)

    def output_type(self, t):
        return t


@register_preprocessor
@dataclasses.dataclass(frozen=True)
class UnitVarianceProcessor(InputPreProcessor):
    """Divide by each example's (population) standard deviation."""

    def __call__(self, x):
        std = torch.std(x, dim=tuple(range(1, x.ndim)), correction=0,
                        keepdim=True)
        return x / (std + 1e-8)

    def output_type(self, t):
        return t


@register_preprocessor
@dataclasses.dataclass(frozen=True)
class ComposableInputPreProcessor(InputPreProcessor):
    """A chain of preprocessors."""

    children: Tuple[InputPreProcessor, ...] = ()

    def __call__(self, x):
        for c in self.children:
            x = c(x)
        return x

    def output_type(self, t):
        for c in self.children:
            t = c.output_type(t)
        return t

    def to_dict(self):
        return {"@type": type(self).__name__,
                "children": [c.to_dict() for c in self.children]}
