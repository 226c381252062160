"""Network configuration: global hyperparameters + layer list.

Counterpart of ``deeplearning4j_tpu/nn/conf/configuration.py``: the
fluent builder, the JSON and YAML formats, and the wiring from an input
type: ``ListBuilder.set_input_type`` infers each layer's n_in and
inserts the shape preprocessors between layer families. A config
written by the reference parses here and ``to_json`` gives the same text
back.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor,
    CnnToRnnPreProcessor,
    FeedForwardToRnnPreProcessor,
    InputPreProcessor,
    RnnToFeedForwardPreProcessor,
    preprocessor_from_dict,
)
from deeplearning4j_tpu_torch.nn.updater import UpdaterConfig


class OptimizationAlgorithm:
    STOCHASTIC_GRADIENT_DESCENT = "stochastic_gradient_descent"
    LINE_GRADIENT_DESCENT = "line_gradient_descent"
    CONJUGATE_GRADIENT = "conjugate_gradient"
    LBFGS = "lbfgs"


class BackpropType:
    STANDARD = "standard"
    TRUNCATED_BPTT = "truncated_bptt"


@dataclasses.dataclass
class NeuralNetConfiguration:
    """Global (network-wide) defaults; layers override per field. The
    field order is the JSON's key order."""

    seed: int = 123
    iterations: int = 1
    activation: str = "sigmoid"
    weight_init: str = "xavier"
    bias_init: float = 0.0
    learning_rate: float = 1e-1
    momentum: float = 0.9
    updater: str = "sgd"
    optimization_algo: str = OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT
    l1: float = 0.0
    l2: float = 0.0
    dropout: float = 0.0
    use_drop_connect: bool = False
    gradient_normalization: str = "none"
    gradient_normalization_threshold: float = 1.0
    mini_batch: bool = True
    use_regularization: bool = False
    adam_mean_decay: float = 0.9
    adam_var_decay: float = 0.999
    rho: float = 0.95
    rms_decay: float = 0.95
    epsilon: float = 1e-8
    lr_policy: str = "none"
    lr_policy_decay_rate: float = 0.0
    lr_policy_power: float = 0.0
    lr_policy_steps: float = 1.0
    lr_schedule: Optional[Dict[int, float]] = None
    max_iterations: int = 1
    compute_dtype: str = "float32"

    def updater_config_for(self, layer: L.Layer) -> UpdaterConfig:
        """The layer's updater config: these global defaults with the
        layer's overrides (updater, learning rate, momentum) applied."""
        return UpdaterConfig(
            updater=layer.updater or self.updater,
            learning_rate=(layer.learning_rate if layer.learning_rate is not None
                           else self.learning_rate),
            momentum=layer.momentum if layer.momentum is not None else self.momentum,
            adam_mean_decay=self.adam_mean_decay,
            adam_var_decay=self.adam_var_decay,
            rho=self.rho,
            rms_decay=self.rms_decay,
            epsilon=self.epsilon,
            lr_policy=self.lr_policy,
            lr_policy_decay_rate=self.lr_policy_decay_rate,
            lr_policy_power=self.lr_policy_power,
            lr_policy_steps=self.lr_policy_steps,
            lr_schedule=self.lr_schedule,
            max_iterations=self.max_iterations,
        )

    def resolve(self, layer: L.Layer, field: str):
        """Layer-over-global field resolution."""
        v = getattr(layer, field, None)
        return v if v is not None else getattr(self, field)

    class Builder:
        def __init__(self):
            self._kwargs: Dict[str, Any] = {}

        def __getattr__(self, name):
            if name.startswith("_"):
                raise AttributeError(name)

            def setter(value):
                self._kwargs[name] = value
                return self

            return setter

        def list(self) -> "ListBuilder":
            return ListBuilder(NeuralNetConfiguration(**self._kwargs))

        def build(self) -> "NeuralNetConfiguration":
            return NeuralNetConfiguration(**self._kwargs)

    @staticmethod
    def builder() -> "NeuralNetConfiguration.Builder":
        return NeuralNetConfiguration.Builder()

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "NeuralNetConfiguration":
        names = {f.name for f in dataclasses.fields(NeuralNetConfiguration)}
        d = {k: v for k, v in d.items() if k in names}
        if d.get("lr_schedule"):
            d["lr_schedule"] = {int(k): float(v)
                                for k, v in d["lr_schedule"].items()}
        return NeuralNetConfiguration(**d)


@dataclasses.dataclass
class MultiLayerConfiguration:
    """Sequential-stack topology."""

    conf: NeuralNetConfiguration
    layers: List[L.Layer]
    input_preprocessors: Dict[int, InputPreProcessor] = dataclasses.field(
        default_factory=dict)
    pretrain: bool = False
    backprop: bool = True
    backprop_type: str = BackpropType.STANDARD
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    input_type: Optional[InputType] = None

    def to_json(self) -> str:
        d = {
            "conf": self.conf.to_dict(),
            "layers": [layer.to_dict() for layer in self.layers],
            "input_preprocessors": {str(k): v.to_dict() for k, v
                                    in self.input_preprocessors.items()},
            "pretrain": self.pretrain,
            "backprop": self.backprop,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "input_type": self.input_type.to_dict() if self.input_type else None,
        }
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        d = json.loads(s)
        return MultiLayerConfiguration(
            conf=NeuralNetConfiguration.from_dict(d["conf"]),
            layers=[L.layer_from_dict(ld) for ld in d["layers"]],
            input_preprocessors={int(k): preprocessor_from_dict(v) for k, v
                                 in d.get("input_preprocessors", {}).items()},
            pretrain=d.get("pretrain", False),
            backprop=d.get("backprop", True),
            backprop_type=d.get("backprop_type", BackpropType.STANDARD),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
            input_type=(InputType.from_dict(d["input_type"])
                        if d.get("input_type") else None),
        )

    def to_yaml(self) -> str:
        """Block-style YAML of the same dict as the JSON."""
        from deeplearning4j_tpu_torch.util.yaml_io import json_to_yaml
        return json_to_yaml(self.to_json())

    @staticmethod
    def from_yaml(s: str) -> "MultiLayerConfiguration":
        from deeplearning4j_tpu_torch.util.yaml_io import yaml_to_json
        return MultiLayerConfiguration.from_json(yaml_to_json(s))


class ListBuilder:
    """Collects the layer list of a :class:`MultiLayerConfiguration`, and
    wires n_in and preprocessors from an input type."""

    def __init__(self, conf: NeuralNetConfiguration):
        self._conf = conf
        self._layers: List[L.Layer] = []
        self._preprocessors: Dict[int, InputPreProcessor] = {}
        self._input_type: Optional[InputType] = None
        self._pretrain = False
        self._backprop = True
        self._backprop_type = BackpropType.STANDARD
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def layer(self, index_or_layer, maybe_layer: Optional[L.Layer] = None
              ) -> "ListBuilder":
        layer = maybe_layer if maybe_layer is not None else index_or_layer
        self._layers.append(layer)
        return self

    def input_preprocessor(self, index: int, pre: InputPreProcessor
                           ) -> "ListBuilder":
        self._preprocessors[index] = pre
        return self

    def set_input_type(self, t: InputType) -> "ListBuilder":
        self._input_type = t
        return self

    def pretrain(self, flag: bool) -> "ListBuilder":
        self._pretrain = flag
        return self

    def backprop(self, flag: bool) -> "ListBuilder":
        self._backprop = flag
        return self

    def backprop_type(self, t: str) -> "ListBuilder":
        self._backprop_type = t
        return self

    def t_bptt_forward_length(self, n: int) -> "ListBuilder":
        self._tbptt_fwd = n
        return self

    def t_bptt_backward_length(self, n: int) -> "ListBuilder":
        self._tbptt_back = n
        return self

    def build(self) -> MultiLayerConfiguration:
        # deep copy: _auto_wire writes n_in into the (frozen) layer
        # configs, and a config the caller holds must not change
        mlc = MultiLayerConfiguration(
            conf=self._conf,
            layers=copy.deepcopy(list(self._layers)),
            input_preprocessors=dict(self._preprocessors),
            pretrain=self._pretrain,
            backprop=self._backprop,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            input_type=self._input_type,
        )
        if self._input_type is not None:
            _auto_wire(mlc)
        return mlc


def _auto_wire(mlc: MultiLayerConfiguration) -> None:
    """Walk the stack tracking the current input type: set each layer's
    missing n_in and insert a preprocessor where the family changes
    (cnn <-> ff <-> rnn), unless one was given for that index."""
    t = mlc.input_type
    for i, layer in enumerate(mlc.layers):
        pre = mlc.input_preprocessors.get(i)
        if pre is None:
            pre = _transition(t, layer)
            if pre is not None:
                mlc.input_preprocessors[i] = pre
        if pre is not None:
            t = pre.output_type(t)
        t = _wire_layer(layer, t)


def _family(layer: L.Layer) -> str:
    if isinstance(layer, (L.ConvolutionLayer, L.SubsamplingLayer,
                          L.LocalResponseNormalization)):
        return "cnn"
    if isinstance(layer, (L.GravesLSTM, L.GravesBidirectionalLSTM,
                          L.RnnOutputLayer, L.AttentionLayer)):
        return "rnn"
    if isinstance(layer, (L.BatchNormalization, L.ActivationLayer, L.LossLayer,
                          L.DropoutLayer, L.GlobalPoolingLayer)):
        return "any"
    return "ff"


def _transition(t: InputType, layer: L.Layer) -> Optional[InputPreProcessor]:
    fam = _family(layer)
    if fam == "any" or fam == t.kind:
        return None
    if t.kind == "cnn" and fam == "ff":
        return CnnToFeedForwardPreProcessor()
    if t.kind == "ff" and fam == "cnn":
        raise ValueError("ff->cnn transition needs an explicit "
                         "FeedForwardToCnnPreProcessor (target h/w/c is "
                         "ambiguous)")
    if t.kind == "rnn" and fam == "ff":
        return RnnToFeedForwardPreProcessor()
    if t.kind == "ff" and fam == "rnn":
        if t.timesteps is None:
            raise ValueError("ff->rnn transition needs a known sequence length; "
                             "set an explicit FeedForwardToRnnPreProcessor("
                             "timesteps=...)")
        return FeedForwardToRnnPreProcessor(timesteps=t.timesteps)
    if t.kind == "cnn" and fam == "rnn":
        return CnnToRnnPreProcessor()
    raise ValueError(f"no automatic preprocessor for {t.kind} -> {fam}")


def _conv_out(size: int, k: int, s: int, p: int, mode: str) -> int:
    if mode == "same":
        return -(-size // s)
    return (size + 2 * p - k) // s + 1


def _wire_layer(layer: L.Layer, t: InputType) -> InputType:
    """Set the layer's n_in from the current input type; return the
    layer's output type."""

    def set_nin(v: int):
        if getattr(layer, "n_in", None) is None and hasattr(layer, "n_in"):
            object.__setattr__(layer, "n_in", int(v))

    def set_nout_to_nin():
        if getattr(layer, "n_out", None) is None:
            object.__setattr__(layer, "n_out", layer.n_in)

    if isinstance(layer, L.ConvolutionLayer):
        set_nin(t.channels)
        h = _conv_out(t.height, layer.kernel_size[0], layer.stride[0],
                      layer.padding[0], layer.convolution_mode)
        w = _conv_out(t.width, layer.kernel_size[1], layer.stride[1],
                      layer.padding[1], layer.convolution_mode)
        return InputType.convolutional(h, w, layer.n_out)
    if isinstance(layer, L.SubsamplingLayer):
        h = _conv_out(t.height, layer.kernel_size[0], layer.stride[0],
                      layer.padding[0], "truncate")
        w = _conv_out(t.width, layer.kernel_size[1], layer.stride[1],
                      layer.padding[1], "truncate")
        return InputType.convolutional(h, w, t.channels)
    if isinstance(layer, L.BatchNormalization):
        set_nin(t.channels if t.kind == "cnn" else t.flat_size())
        set_nout_to_nin()
        return t
    if isinstance(layer, (L.GravesLSTM, L.RnnOutputLayer)):
        set_nin(t.size)
        return InputType.recurrent(layer.n_out, t.timesteps)
    if isinstance(layer, L.AttentionLayer):
        set_nin(t.size)
        set_nout_to_nin()
        return InputType.recurrent(layer.n_out, t.timesteps)
    if isinstance(layer, L.GlobalPoolingLayer):
        if t.kind == "rnn":
            return InputType.feed_forward(t.size)
        if t.kind == "cnn":
            return InputType.feed_forward(t.channels)
        return t
    if isinstance(layer, L.FeedForwardLayer) and not isinstance(layer, L.DropoutLayer):
        set_nin(t.flat_size())
        return InputType.feed_forward(layer.n_out)
    return t
