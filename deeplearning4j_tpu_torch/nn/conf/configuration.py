"""Network configuration: global hyperparameters + layer list.

Counterpart of ``deeplearning4j_tpu/nn/conf/configuration.py``: the
fluent builder and the JSON format. A config written by the reference
parses here and ``to_json`` gives the same text back. Input
preprocessors and the input type are carried as the JSON objects they
were read from; the slice builds no net that has preprocessors, and
``ListBuilder`` does not wire n_in from an input type yet.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf import layers as L
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
    input_preprocessors: Dict[int, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    pretrain: bool = False
    backprop: bool = True
    backprop_type: str = BackpropType.STANDARD
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    input_type: Optional[Dict[str, Any]] = None

    def to_json(self) -> str:
        d = {
            "conf": self.conf.to_dict(),
            "layers": [layer.to_dict() for layer in self.layers],
            "input_preprocessors": {str(k): v for k, v
                                    in self.input_preprocessors.items()},
            "pretrain": self.pretrain,
            "backprop": self.backprop,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "input_type": self.input_type,
        }
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        d = json.loads(s)
        return MultiLayerConfiguration(
            conf=NeuralNetConfiguration.from_dict(d["conf"]),
            layers=[L.layer_from_dict(ld) for ld in d["layers"]],
            input_preprocessors={int(k): v for k, v
                                 in d.get("input_preprocessors", {}).items()},
            pretrain=d.get("pretrain", False),
            backprop=d.get("backprop", True),
            backprop_type=d.get("backprop_type", BackpropType.STANDARD),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
            input_type=d.get("input_type") or None,
        )


class ListBuilder:
    """Collects the layer list of a :class:`MultiLayerConfiguration`."""

    def __init__(self, conf: NeuralNetConfiguration):
        self._conf = conf
        self._layers: List[L.Layer] = []

    def layer(self, index_or_layer, maybe_layer: Optional[L.Layer] = None
              ) -> "ListBuilder":
        layer = maybe_layer if maybe_layer is not None else index_or_layer
        self._layers.append(layer)
        return self

    def build(self) -> MultiLayerConfiguration:
        return MultiLayerConfiguration(conf=self._conf,
                                       layers=list(self._layers))
