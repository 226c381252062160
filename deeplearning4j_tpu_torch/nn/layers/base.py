"""Layer implementation protocol + registry.

Counterpart of ``deeplearning4j_tpu/nn/layers/base.py``. A layer is an
``init_params`` that draws float32 tensors from a ``torch.Generator``
on a device, and a ``forward`` that is a plain function of those
tensors; the container keeps the parameters as a dict per layer, in the
reference's layout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Type

import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.configuration import NeuralNetConfiguration

_IMPL_REGISTRY: Dict[Type[L.Layer], Type["LayerImpl"]] = {}


def register_impl(conf_cls: Type[L.Layer]):
    def deco(impl_cls):
        _IMPL_REGISTRY[conf_cls] = impl_cls
        impl_cls.conf_cls = conf_cls
        return impl_cls

    return deco


def build_layer(global_conf: NeuralNetConfiguration, layer_conf: L.Layer,
                name: str) -> "LayerImpl":
    """Instantiate the impl for a layer config."""
    for cls in type(layer_conf).__mro__:
        if cls in _IMPL_REGISTRY:
            return _IMPL_REGISTRY[cls](global_conf, layer_conf, name)
    raise NotImplementedError(
        f"{type(layer_conf).__name__} has no implementation in the port yet "
        "(this slice builds SequenceEmbeddingLayer, TransformerBlock and "
        "the output layers)")


class LayerImpl:
    """``init_params(gen, device)`` + ``forward(params, x, state, train)``."""

    conf_cls: Type[L.Layer] = L.Layer

    # False for layers whose input is integer ids (embeddings): the
    # compute-dtype cast must not touch them (bf16 rounds ids >= 256)
    cast_input = True

    def __init__(self, global_conf: NeuralNetConfiguration, conf: L.Layer,
                 name: str):
        self.gc = global_conf
        self.conf = conf
        self.name = name
        if not getattr(conf, "has_bias", True):
            raise NotImplementedError(
                f"{type(conf).__name__} ({name}): has_bias=False is not "
                "ported yet")

    @property
    def activation(self) -> str:
        return self.conf.activation or self.gc.activation

    @property
    def weight_init(self) -> str:
        return self.conf.weight_init or self.gc.weight_init

    @property
    def bias_init(self) -> float:
        return (self.conf.bias_init if self.conf.bias_init is not None
                else self.gc.bias_init)

    def init_params(self, gen: torch.Generator,
                    device: torch.device) -> Dict[str, torch.Tensor]:
        return {}

    def init_state(self) -> Dict[str, Any]:
        return {}

    def forward(self, params: Dict[str, torch.Tensor], x: torch.Tensor,
                state: Dict[str, Any], train: bool,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        raise NotImplementedError

    def has_loss(self) -> bool:
        return False
