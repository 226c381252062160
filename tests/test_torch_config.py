"""The port's configuration layer against the JAX package: the builder
(with ``set_input_type``'s n_in wiring and preprocessor insertion), the
JSON and the YAML forms.

Each recipe is a configuration that the JAX package's own tests,
benchmarks or entry point build, written once against a namespace and
built by both packages' builders. Both must write the same JSON; the
JAX package's JSON must parse in the port and come back byte for byte;
the YAML must be the same text and parse in either package.
"""

import json
import os
import types
import zipfile

import pytest

import deeplearning4j_tpu.nn.conf.preprocessors as JP
import deeplearning4j_tpu_torch.nn.conf.preprocessors as TP
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.configuration import (
    MultiLayerConfiguration as JaxMLC,
)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.weights import Distribution as JaxDistribution
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.weights import Distribution

JAX = types.SimpleNamespace(NNC=JaxNNC, L=JL, IT=JaxInputType, P=JP,
                            D=JaxDistribution)
PORT = types.SimpleNamespace(NNC=NeuralNetConfiguration, L=L, IT=InputType, P=TP,
                             D=Distribution)
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _stack(ns, layers, input_type=None, pre=None, **conf_kw):
    b = ns.NNC.builder().seed(42)
    for k, v in conf_kw.items():
        b = getattr(b, k)(v)
    lb = b.list()
    for layer in layers:
        lb = lb.layer(layer)
    for i, p in (pre or {}).items():
        lb = lb.input_preprocessor(i, p)
    if input_type is not None:
        lb = lb.set_input_type(input_type)
    return lb.build()


def _out(ns, n_in=None, n_out=3, **kw):
    return ns.L.OutputLayer(n_in=n_in, n_out=n_out, activation="softmax",
                            loss_function="mcxent", **kw)


RECIPES = {
    # tests/test_mln.py _mlp_conf(l2=0.01, updater="adam")
    "mln_mlp": lambda ns: _stack(ns, [ns.L.DenseLayer(n_in=4, n_out=5), _out(ns, 5)],
                                 learning_rate=0.1, updater="adam", activation="sigmoid",
                                 weight_init="xavier", l1=0.0, l2=0.01),
    # tests/test_mln.py TestIrisTraining
    "mln_iris_input_type": lambda ns: _stack(
        ns, [ns.L.DenseLayer(n_out=16), _out(ns)], ns.IT.feed_forward(4),
        seed=12345, learning_rate=0.5, updater="nesterovs", momentum=0.9,
        activation="relu", weight_init="relu"),
    # tests/test_dropconnect.py _net
    "dropconnect": lambda ns: _stack(ns, [ns.L.DenseLayer(n_in=5, n_out=16), _out(ns, 16)],
                                     seed=9, learning_rate=0.1, activation="tanh",
                                     dropout=0.5, use_drop_connect=True),
    # tests/test_layers.py test_dist_json_roundtrip
    "distribution": lambda ns: _stack(
        ns, [ns.L.DenseLayer(n_in=3, n_out=4, weight_init="distribution",
                             dist=ns.D.uniform(-0.1, 0.1)), _out(ns, 4, 2)], seed=1),
    # tests/test_layers.py gradient checks
    "conv_subsampling": lambda ns: _stack(
        ns, [ns.L.ConvolutionLayer(n_out=2, kernel_size=(2, 2), stride=(1, 1)),
             ns.L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)), _out(ns)],
        ns.IT.convolutional(6, 6, 1), activation="tanh", weight_init="xavier"),
    "conv_same_avg": lambda ns: _stack(
        ns, [ns.L.ConvolutionLayer(n_out=2, kernel_size=(3, 3), convolution_mode="same"),
             ns.L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2), pooling_type="avg"),
             _out(ns, n_out=2)],
        ns.IT.convolutional(4, 4, 2), activation="relu"),
    "lenet_28": lambda ns: _stack(
        ns, [ns.L.ConvolutionLayer(n_out=4, kernel_size=(5, 5)), ns.L.SubsamplingLayer(),
             ns.L.ConvolutionLayer(n_out=6, kernel_size=(5, 5)), ns.L.SubsamplingLayer(),
             ns.L.DenseLayer(n_out=10), _out(ns, n_out=10)],
        ns.IT.convolutional(28, 28, 1), activation="relu", weight_init="relu"),
    "dense_bn": lambda ns: _stack(
        ns, [ns.L.DenseLayer(n_in=4, n_out=5), ns.L.BatchNormalization(n_in=5, n_out=5),
             _out(ns, 5)], activation="tanh"),
    "conv_lrn": lambda ns: _stack(
        ns, [ns.L.ConvolutionLayer(n_out=6, kernel_size=(2, 2)),
             ns.L.LocalResponseNormalization(), _out(ns, n_out=2)],
        ns.IT.convolutional(4, 4, 1), activation="tanh"),
    "lstm_global_pooling": lambda ns: _stack(
        ns, [ns.L.GravesLSTM(n_in=2, n_out=3), ns.L.GlobalPoolingLayer(pooling_type="avg"),
             _out(ns, 3, 2)]),
    "embedding": lambda ns: _stack(
        ns, [ns.L.EmbeddingLayer(n_in=7, n_out=4, activation="identity"), _out(ns, 4)]),
    # tests/test_ui_server.py
    "ui_cnn": lambda ns: _stack(
        ns, [ns.L.ConvolutionLayer(n_out=4, kernel_size=(3, 3)),
             ns.L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)),
             ns.L.DenseLayer(n_out=16), _out(ns)],
        ns.IT.convolutional(10, 10, 1), seed=1, learning_rate=0.01, updater="adam",
        activation="relu"),
    # tests/test_distributed_eval.py: an explicit preprocessor
    "explicit_preprocessor": lambda ns: _stack(
        ns, [ns.L.DenseLayer(n_in=6, n_out=8), _out(ns, 8)],
        pre={0: ns.P.CnnToFeedForwardPreProcessor()}, seed=9, activation="tanh"),
    # __graft_entry__._flagship(compute_dtype="bfloat16"), bench.py bench_lenet
    "lenet_flagship": lambda ns: _stack(
        ns, [ns.L.ConvolutionLayer(n_out=20, kernel_size=(5, 5)),
             ns.L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)),
             ns.L.ConvolutionLayer(n_out=50, kernel_size=(5, 5)),
             ns.L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)),
             ns.L.DenseLayer(n_out=500), _out(ns, n_out=10)],
        ns.IT.convolutional(28, 28, 1), seed=12345, learning_rate=0.01,
        updater="adam", activation="relu", weight_init="relu",
        compute_dtype="bfloat16"),
    # bench.py bench_mlp_iris
    "mlp_iris_bench": lambda ns: _stack(
        ns, [ns.L.DenseLayer(n_in=4, n_out=64), ns.L.DenseLayer(n_in=64, n_out=64),
             _out(ns, 64)], seed=3, learning_rate=0.1, updater="adam",
        activation="relu", compute_dtype="bfloat16"),
    # auto-wired family changes: rnn -> ff -> rnn (the way back given:
    # see test_wiring_matches_reference_decisions), cnn -> rnn, BN on cnn
    "rnn_dense_rnn": lambda ns: _stack(
        ns, [ns.L.GravesLSTM(n_out=6), ns.L.DenseLayer(n_out=5),
             ns.L.RnnOutputLayer(n_out=3, activation="softmax")],
        ns.IT.recurrent(4, 7), pre={2: ns.P.FeedForwardToRnnPreProcessor(timesteps=7)},
        activation="tanh"),
    "cnn_bn_rnn": lambda ns: _stack(
        ns, [ns.L.ConvolutionLayer(n_out=3, kernel_size=(3, 3), stride=(2, 2),
                                   convolution_mode="same", has_bias=False),
             ns.L.BatchNormalization(), ns.L.ActivationLayer(activation="relu"),
             ns.L.DropoutLayer(dropout=0.2), ns.L.GravesLSTM(n_out=4),
             ns.L.RnnOutputLayer(n_out=2, activation="softmax")],
        ns.IT.convolutional(9, 7, 2)),
    "every_preprocessor": lambda ns: _stack(
        ns, [ns.L.DenseLayer(n_in=24, n_out=24), ns.L.ActivationLayer(),
             ns.L.DenseLayer(n_in=24, n_out=24), ns.L.ActivationLayer(),
             ns.L.DenseLayer(n_in=24, n_out=24), ns.L.ActivationLayer(),
             ns.L.LossLayer()],
        pre={0: ns.P.ComposableInputPreProcessor(children=(
                 ns.P.ZeroMeanPrePreProcessor(), ns.P.UnitVarianceProcessor())),
             1: ns.P.FeedForwardToCnnPreProcessor(height=2, width=3, channels=4),
             2: ns.P.CnnToRnnPreProcessor(), 3: ns.P.RnnToFeedForwardPreProcessor(),
             4: ns.P.FeedForwardToRnnPreProcessor(timesteps=1),
             5: ns.P.RnnToCnnPreProcessor(height=2, width=3, channels=4),
             6: ns.P.ReshapePreprocessor(shape=(24,))}),
    # tests/test_torch_serializer.py: truncated BPTT
    "tbptt": lambda ns: (ns.NNC.builder().activation("tanh").list()
                         .layer(ns.L.GravesLSTM(n_in=5, n_out=7))
                         .layer(ns.L.RnnOutputLayer(n_in=7, n_out=5, activation="softmax"))
                         .backprop_type("truncated_bptt").t_bptt_forward_length(9)
                         .t_bptt_backward_length(9).build()),
}


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_builder_writes_the_reference_json(name):
    assert RECIPES[name](PORT).to_json() == RECIPES[name](JAX).to_json()


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_reference_json_round_trips_byte_for_byte(name):
    text = RECIPES[name](JAX).to_json()
    conf = MultiLayerConfiguration.from_json(text)
    assert conf.to_json() == text
    assert JaxMLC.from_json(conf.to_json()).to_json() == text


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_yaml_round_trips_in_both_packages(name):
    jconf, tconf = RECIPES[name](JAX), RECIPES[name](PORT)
    y = tconf.to_yaml()
    assert y == jconf.to_yaml()
    assert not y.lstrip().startswith("{") and "layers:" in y
    assert MultiLayerConfiguration.from_yaml(jconf.to_yaml()).to_json() == jconf.to_json()
    assert JaxMLC.from_yaml(y).to_json() == tconf.to_json()


def test_frozen_fixture_config_round_trips():
    """An older config (it predates ``use_drop_connect``) reads as the
    JAX package reads it."""
    with zipfile.ZipFile(os.path.join(FIXTURES, "mln_r2.zip")) as z:
        text = json.dumps(json.loads(z.read("configuration.json"))["conf"], indent=2)
    assert MultiLayerConfiguration.from_json(text).to_json() == \
        JaxMLC.from_json(text).to_json()


def test_wiring_matches_reference_decisions():
    """What set_input_type decides: n_in per layer, the preprocessors it
    inserts, that it leaves an explicit one alone, that the caller's
    layer objects are not changed, and the ff -> cnn refusal."""
    conf = RECIPES["cnn_bn_rnn"](PORT)
    assert [getattr(c, "n_in", None) for c in conf.layers] == [2, 3, None, None, 5 * 4 * 3, 4]
    assert conf.layers[1].n_out == 3
    assert conf.input_preprocessors == {4: TP.CnnToRnnPreProcessor()}
    conf = RECIPES["rnn_dense_rnn"](PORT)
    assert conf.input_preprocessors == {1: TP.RnnToFeedForwardPreProcessor(),
                                        2: TP.FeedForwardToRnnPreProcessor(timesteps=7)}
    # without the explicit way back both refuse: the dense layer's output
    # type drops the sequence length RnnToFeedForward carried
    for ns in (PORT, JAX):
        with pytest.raises(ValueError, match="known sequence length"):
            _stack(ns, [ns.L.GravesLSTM(n_out=6), ns.L.DenseLayer(n_out=5),
                        ns.L.RnnOutputLayer(n_out=3)], ns.IT.recurrent(4, 7))
    dense = L.DenseLayer(n_out=3)
    lb = (NeuralNetConfiguration.builder().list().layer(dense).layer(_out(PORT))
          .input_preprocessor(0, TP.ZeroMeanPrePreProcessor())
          .set_input_type(InputType.convolutional(2, 2, 2)))
    conf = lb.build()
    assert dense.n_in is None and conf.layers[0].n_in == 8
    assert conf.input_preprocessors == {0: TP.ZeroMeanPrePreProcessor()}
    for ns in (PORT, JAX):
        with pytest.raises(ValueError, match="FeedForwardToCnnPreProcessor"):
            _stack(ns, [ns.L.ConvolutionLayer(n_out=2, kernel_size=(2, 2)), _out(ns)],
                   ns.IT.feed_forward(8))
