"""Layer implementation protocol + registry + shared helpers.

Counterpart of ``deeplearning4j_tpu/nn/layers/base.py``. A layer is an
``init_params`` that draws float32 tensors from a ``torch.Generator``
on a device, and a ``forward`` that is a plain function of those
tensors; the container keeps the parameters as a dict per layer, in the
reference's layout. A train-mode forward gets ``rng``, an integer stream
key (``util/rng.py``) from which its dropout draws.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Type

import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.configuration import NeuralNetConfiguration
from deeplearning4j_tpu_torch.util.rng import fold_in, generator

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
        "(it builds SequenceEmbeddingLayer, TransformerBlock, GravesLSTM, "
        "GravesBidirectionalLSTM and the output layers)")


def apply_dropout(x: torch.Tensor, rate: float,
                  gen: torch.Generator) -> torch.Tensor:
    """Inverted dropout: each unit dropped with probability ``rate``,
    survivors scaled by 1/(1-rate) so inference needs no rescale."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class LayerImpl:
    """``init_params(gen, device)`` + ``forward(params, x, state, train,
    rng)``."""

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

    @property
    def dropout_rate(self) -> float:
        return self.gc.resolve(self.conf, "dropout")

    @property
    def l1(self) -> float:
        return self.gc.resolve(self.conf, "l1")

    @property
    def l2(self) -> float:
        return self.gc.resolve(self.conf, "l2")

    # True only for impls whose forward calls maybe_drop_connect (the
    # dense family): elsewhere use_drop_connect leaves input dropout on
    applies_drop_connect = False

    def init_params(self, gen: torch.Generator,
                    device: torch.device) -> Dict[str, torch.Tensor]:
        return {}

    def init_state(self) -> Dict[str, Any]:
        return {}

    def forward(self, params: Dict[str, torch.Tensor], x: torch.Tensor,
                state: Dict[str, Any], train: bool, rng: Optional[int] = None,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        raise NotImplementedError

    def maybe_dropout_input(self, x: torch.Tensor, train: bool,
                            rng: Optional[int]) -> torch.Tensor:
        """Dropout on the layer's input activations in training, unless
        DropConnect redirects the probability to this layer's weights."""
        rate = self.dropout_rate
        if (train and rate > 0.0 and rng is not None
                and not (self.applies_drop_connect and self.gc.use_drop_connect)):
            return apply_dropout(x, rate, generator(rng, x.device))
        return x

    def maybe_drop_connect(self, params: Dict[str, torch.Tensor], train: bool,
                           rng: Optional[int]) -> Dict[str, torch.Tensor]:
        """DropConnect: with ``use_drop_connect``, the dropout probability
        masks the weight matrix W (biases untouched), inverted-scaled, on
        a stream distinct from input dropout's."""
        rate = self.dropout_rate
        if not (train and rate > 0.0 and rng is not None and "W" in params
                and self.gc.use_drop_connect):
            return params
        W = params["W"]
        gen = generator(fold_in(rng, 0x0D20), W.device)
        return {**params, "W": apply_dropout(W, rate, gen)}

    def regularization_penalty(self, params: Dict[str, torch.Tensor]
                               ) -> torch.Tensor:
        """The L1/L2 score term over every parameter except biases (keys
        named ``"b"``), in f32, summed in sorted-name order (the
        reference's pytree order)."""
        dev = next(iter(params.values())).device if params else "cpu"
        pen = torch.zeros((), dtype=torch.float32, device=dev)
        weights = [params[k].float() for k in sorted(params) if k != "b"]
        if self.l2 > 0.0:
            for v in weights:
                pen = pen + 0.5 * self.l2 * torch.sum(v ** 2)
        if self.l1 > 0.0:
            for v in weights:
                # |v| with the reference's subgradient +1 at 0 (torch.abs
                # takes 0 there, which would leave zero-initialised
                # parameters without an L1 gradient)
                pen = pen + self.l1 * torch.sum(torch.where(v >= 0, v, -v))
        return pen

    def has_loss(self) -> bool:
        return False
