"""Declarative layer configurations.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers.py``: the same frozen
dataclasses, field for field and default for default, so a config JSON
written by the reference parses here and serializes back to the same
text. Every type parses; the layers of the GPT stack
(``SequenceEmbeddingLayer``, ``TransformerBlock``), of the char-RNN
(``GravesLSTM``, ``GravesBidirectionalLSTM``) and the output layers
(``RnnOutputLayer``, ``OutputLayer``) have implementations, and building
another raises ``NotImplementedError``.

Fields with value ``None`` inherit the global default from the enclosing
:class:`~deeplearning4j_tpu_torch.nn.conf.NeuralNetConfiguration`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Type

_LAYER_REGISTRY: Dict[str, Type["Layer"]] = {}


def register_layer(cls: Type["Layer"]) -> Type["Layer"]:
    """Register a layer config type for serialization."""
    _LAYER_REGISTRY[cls.__name__] = cls
    return cls


def layer_from_dict(d: Dict[str, Any]) -> "Layer":
    d = dict(d)
    type_name = d.pop("@type")
    cls = _LAYER_REGISTRY[type_name]
    field_names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: v for k, v in d.items() if k in field_names}
    # tuples arrive from JSON as lists
    for f in dataclasses.fields(cls):
        if f.name in kwargs and isinstance(kwargs[f.name], list):
            kwargs[f.name] = tuple(kwargs[f.name])
    if isinstance(kwargs.get("dist"), dict):
        from deeplearning4j_tpu_torch.nn.weights import Distribution
        kwargs["dist"] = Distribution.from_dict(kwargs["dist"])
    return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class Layer:
    """Base layer config."""

    name: Optional[str] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    bias_init: Optional[float] = None
    has_bias: bool = True
    dist_mean: float = 0.0
    dist_std: float = 1.0
    dist: Optional[object] = None  # a weights.Distribution
    dropout: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    learning_rate: Optional[float] = None
    momentum: Optional[float] = None
    updater: Optional[str] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        d = {"@type": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is not None and v != f.default:
                if dataclasses.is_dataclass(v) and not isinstance(v, type):
                    v = dataclasses.asdict(v)
                d[f.name] = list(v) if isinstance(v, tuple) else v
        return d


@dataclasses.dataclass(frozen=True)
class FeedForwardLayer(Layer):
    n_in: Optional[int] = None
    n_out: Optional[int] = None


@register_layer
@dataclasses.dataclass(frozen=True)
class DenseLayer(FeedForwardLayer):
    pass


@register_layer
@dataclasses.dataclass(frozen=True)
class OutputLayer(FeedForwardLayer):
    loss_function: str = "mcxent"


@register_layer
@dataclasses.dataclass(frozen=True)
class RnnOutputLayer(FeedForwardLayer):
    loss_function: str = "mcxent"


@register_layer
@dataclasses.dataclass(frozen=True)
class LossLayer(Layer):
    loss_function: str = "mse"


@register_layer
@dataclasses.dataclass(frozen=True)
class ConvolutionLayer(FeedForwardLayer):
    kernel_size: Tuple[int, int] = (5, 5)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"


class PoolingType:
    MAX = "max"
    AVG = "avg"
    SUM = "sum"
    PNORM = "pnorm"


@register_layer
@dataclasses.dataclass(frozen=True)
class SubsamplingLayer(Layer):
    pooling_type: str = PoolingType.MAX
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    pnorm: int = 2


@register_layer
@dataclasses.dataclass(frozen=True)
class BatchNormalization(FeedForwardLayer):
    decay: float = 0.9
    eps: float = 1e-5
    is_minibatch: bool = True
    lock_gamma_beta: bool = False
    gamma: float = 1.0
    beta: float = 0.0


@register_layer
@dataclasses.dataclass(frozen=True)
class LocalResponseNormalization(Layer):
    k: float = 2.0
    n: float = 5.0
    alpha: float = 1e-4
    beta: float = 0.75


@register_layer
@dataclasses.dataclass(frozen=True)
class GravesLSTM(FeedForwardLayer):
    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"


@register_layer
@dataclasses.dataclass(frozen=True)
class GravesBidirectionalLSTM(GravesLSTM):
    pass


@register_layer
@dataclasses.dataclass(frozen=True)
class AttentionLayer(FeedForwardLayer):
    num_heads: int = 4
    causal: bool = False
    residual: bool = True


@register_layer
@dataclasses.dataclass(frozen=True)
class EmbeddingLayer(FeedForwardLayer):
    pass


@register_layer
@dataclasses.dataclass(frozen=True)
class SequenceEmbeddingLayer(FeedForwardLayer):
    """Token + learned positional embedding: int ids [b, t] ->
    [b, t, n_out]."""

    max_len: int = 2048


@register_layer
@dataclasses.dataclass(frozen=True)
class TransformerBlock(FeedForwardLayer):
    """Pre-LN transformer block: LN -> multi-head attention (the flash
    kernel) -> residual -> LN -> GELU MLP -> residual; n_in == n_out ==
    d_model. ``num_experts > 0`` (routed experts) is not ported yet."""

    num_heads: int = 8
    ffn_mult: int = 4
    causal: bool = True
    num_experts: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@register_layer
@dataclasses.dataclass(frozen=True)
class MoELayer(FeedForwardLayer):
    num_experts: int = 8
    ffn_mult: int = 4
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    residual: bool = False


@register_layer
@dataclasses.dataclass(frozen=True)
class AutoEncoder(FeedForwardLayer):
    corruption_level: float = 0.3
    sparsity: float = 0.0
    loss_function: str = "mse"


class RBMHiddenUnit:
    BINARY = "binary"
    RECTIFIED = "rectified"
    GAUSSIAN = "gaussian"
    SOFTMAX = "softmax"


class RBMVisibleUnit:
    BINARY = "binary"
    GAUSSIAN = "gaussian"
    LINEAR = "linear"
    SOFTMAX = "softmax"


@register_layer
@dataclasses.dataclass(frozen=True)
class RBM(FeedForwardLayer):
    hidden_unit: str = RBMHiddenUnit.BINARY
    visible_unit: str = RBMVisibleUnit.BINARY
    k: int = 1
    loss_function: str = "reconstruction_crossentropy"


@register_layer
@dataclasses.dataclass(frozen=True)
class ActivationLayer(Layer):
    pass


@register_layer
@dataclasses.dataclass(frozen=True)
class DropoutLayer(FeedForwardLayer):
    pass


@register_layer
@dataclasses.dataclass(frozen=True)
class GlobalPoolingLayer(Layer):
    pooling_type: str = PoolingType.MAX
