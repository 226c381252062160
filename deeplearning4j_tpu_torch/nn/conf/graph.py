"""Graph vertex configurations and their forwards.

Counterpart of ``deeplearning4j_tpu/nn/conf/graph.py``: the
ComputationGraph's parameterless vertices, each a frozen dataclass whose
``forward(inputs, masks)`` is a plain function of torch tensors
(autograd takes the backward), so a vertex's configuration is its
implementation. ``to_dict``/``vertex_from_dict`` give the reference's
JSON (``"@type"`` and the fields, tuples as lists).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Type

import torch

_VERTEX_REGISTRY: Dict[str, Type["GraphVertex"]] = {}


def register_vertex(cls):
    _VERTEX_REGISTRY[cls.__name__] = cls
    return cls


def vertex_from_dict(d: Dict[str, Any]) -> "GraphVertex":
    d = dict(d)
    name = d.pop("@type")
    if name == "PreprocessorVertex":
        from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
            preprocessor_from_dict,
        )
        return _VERTEX_REGISTRY[name](
            preprocessor=preprocessor_from_dict(d["preprocessor"]))
    for k, v in d.items():
        if isinstance(v, list):
            d[k] = tuple(v)
    return _VERTEX_REGISTRY[name](**d)


@dataclasses.dataclass(frozen=True)
class GraphVertex:
    """A parameterless DAG op: forward(inputs, masks) -> output."""

    def forward(self, inputs: List[torch.Tensor],
                masks: Optional[List[Optional[torch.Tensor]]] = None
                ) -> torch.Tensor:
        raise NotImplementedError

    def to_dict(self) -> Dict[str, Any]:
        d = {"@type": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            d[f.name] = list(v) if isinstance(v, tuple) else v
        return d


@register_vertex
@dataclasses.dataclass(frozen=True)
class MergeVertex(GraphVertex):
    """Concatenate along the feature axis (the last: NHWC, [b, t, f])."""

    def forward(self, inputs, masks=None):
        return torch.cat(inputs, dim=-1)


@register_vertex
@dataclasses.dataclass(frozen=True)
class ElementWiseVertex(GraphVertex):
    """Add / Subtract / Product / Max, folded left over the inputs."""

    op: str = "add"

    def forward(self, inputs, masks=None):
        out = inputs[0]
        for x in inputs[1:]:
            if self.op == "add":
                out = out + x
            elif self.op == "subtract":
                out = out - x
            elif self.op == "product":
                out = out * x
            elif self.op == "max":
                out = torch.maximum(out, x)
            else:
                raise ValueError(self.op)
        return out


@register_vertex
@dataclasses.dataclass(frozen=True)
class SubsetVertex(GraphVertex):
    """The feature range [from_index, to_index], both inclusive."""

    from_index: int = 0
    to_index: int = 0

    def forward(self, inputs, masks=None):
        return inputs[0][..., self.from_index:self.to_index + 1]


@register_vertex
@dataclasses.dataclass(frozen=True)
class StackVertex(GraphVertex):
    """Stack along the batch axis (examples appended)."""

    def forward(self, inputs, masks=None):
        return torch.cat(inputs, dim=0)


@register_vertex
@dataclasses.dataclass(frozen=True)
class UnstackVertex(GraphVertex):
    """The ``from_index``-th of ``stack_size`` equal batch-axis chunks."""

    from_index: int = 0
    stack_size: int = 1

    def forward(self, inputs, masks=None):
        x = inputs[0]
        step = x.shape[0] // self.stack_size
        return x[self.from_index * step:(self.from_index + 1) * step]


@register_vertex
@dataclasses.dataclass(frozen=True)
class L2NormalizeVertex(GraphVertex):
    """x / sqrt(sum x^2 + eps) per example."""

    eps: float = 1e-8

    def forward(self, inputs, masks=None):
        x = inputs[0]
        axes = tuple(range(1, x.ndim))
        return x / torch.sqrt(torch.sum(x * x, dim=axes, keepdim=True) + self.eps)


@register_vertex
@dataclasses.dataclass(frozen=True)
class L2Vertex(GraphVertex):
    """The L2 distance between two inputs per example -> [b, 1]."""

    eps: float = 1e-8

    def forward(self, inputs, masks=None):
        a, b = inputs
        axes = tuple(range(1, a.ndim))
        return torch.sqrt(torch.sum((a - b) ** 2, dim=axes) + self.eps)[:, None]


@register_vertex
@dataclasses.dataclass(frozen=True)
class ScaleVertex(GraphVertex):
    """Multiply by a fixed scalar."""

    scale: float = 1.0

    def forward(self, inputs, masks=None):
        return inputs[0] * self.scale


@register_vertex
@dataclasses.dataclass(frozen=True)
class ShiftVertex(GraphVertex):
    """Add a fixed scalar."""

    shift: float = 0.0

    def forward(self, inputs, masks=None):
        return inputs[0] + self.shift


@register_vertex
@dataclasses.dataclass(frozen=True)
class PreprocessorVertex(GraphVertex):
    """An input preprocessor as a vertex."""

    preprocessor: Any = None

    def forward(self, inputs, masks=None):
        return self.preprocessor(inputs[0])

    def to_dict(self):
        return {"@type": "PreprocessorVertex",
                "preprocessor": self.preprocessor.to_dict()}


@register_vertex
@dataclasses.dataclass(frozen=True)
class LastTimeStepVertex(GraphVertex):
    """[b, t, f] -> [b, f] at each example's last unmasked step (by the
    mask of the vertex's input), or at the last step without a mask."""

    mask_input: Optional[str] = None

    def forward(self, inputs, masks=None):
        x = inputs[0]
        mask = masks[0] if masks else None
        if mask is None:
            return x[:, -1, :]
        idx = torch.clamp(torch.sum(mask, dim=1).to(torch.int32) - 1, min=0)
        return torch.take_along_dim(x, idx.long()[:, None, None], dim=1)[:, 0, :]


@register_vertex
@dataclasses.dataclass(frozen=True)
class DuplicateToTimeSeriesVertex(GraphVertex):
    """[b, f] -> [b, t, f], t from the second input's time axis."""

    ref_input: Optional[str] = None

    def forward(self, inputs, masks=None):
        x, ref = inputs
        return x[:, None, :].expand(x.shape[0], ref.shape[1], x.shape[-1])
