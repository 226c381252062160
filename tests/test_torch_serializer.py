"""Model zips and config JSON across the JAX package and the port.

A zip written by either package restores in the other with identical
parameters and outputs, and a config's JSON round-trips through the port
byte for byte.
"""

import zipfile

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.models.zoo.transformer import gpt as jax_gpt
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.inputs import InputType
from deeplearning4j_tpu.nn.weights import Distribution as JaxDistribution
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.models.zoo.transformer import gpt
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.util import model_serializer as tser

SIZE = dict(vocab_size=64, d_model=32, n_layers=2, num_heads=4, max_len=64)


def _ids(b=2, t=12):
    return np.random.default_rng(0).integers(0, SIZE["vocab_size"], (b, t))


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_jax_zip_loads_in_port(tmp_path, cd):
    jn = jax_gpt(compute_dtype=cd, seed=1, **SIZE).init()
    path = str(tmp_path / "jax.zip")
    jser.write_model(jn, path)
    tn = tser.restore_multi_layer_network(path, device="cpu")
    assert tn.conf.to_json() == jn.conf.to_json()
    for layer, p in jn.params.items():
        for name, v in p.items():
            np.testing.assert_array_equal(tn.params[layer][name].numpy(),
                                          np.asarray(v))
    tol = 1e-4 if cd == "float32" else 3e-2
    np.testing.assert_allclose(tn.output(_ids()), np.asarray(jn.output(_ids())),
                               rtol=tol, atol=tol)
    if cd == "float32":  # bf16 rounds at other places: greedy ties may flip
        np.testing.assert_array_equal(tn.generate(_ids(2, 16), 8),
                                      np.asarray(jn.generate(_ids(2, 16), 8)))


def test_port_zip_loads_in_jax(tmp_path):
    jn = jax_gpt(compute_dtype="float32", seed=2, **SIZE).init()
    tn = gpt(compute_dtype="float32", seed=2, device="cpu", **SIZE).init()
    path = str(tmp_path / "port.zip")
    tser.write_model(tn, path)
    assert jser.verify_model_file(path) == []
    back = jser.restore_multi_layer_network(path)
    for layer, p in tn.params.items():
        for name, v in p.items():
            np.testing.assert_array_equal(np.asarray(back.params[layer][name]),
                                          v.numpy())
    # the same weights give the same outputs in both packages
    np.testing.assert_allclose(tn.output(_ids()), np.asarray(back.output(_ids())),
                               rtol=1e-4, atol=1e-4)
    assert back.conf.to_json() == jn.conf.to_json()
    # and the port reads its own zip back bit for bit
    again = tser.restore_multi_layer_network(path, device="cpu")
    np.testing.assert_array_equal(again.output(_ids()), tn.output(_ids()))


def test_corrupt_zip_raises(tmp_path):
    tn = gpt(compute_dtype="float32", device="cpu", **SIZE).init()
    path = str(tmp_path / "m.zip")
    tser.write_model(tn, path)
    with zipfile.ZipFile(path) as z:
        members = {n: z.read(n) for n in z.namelist()}
    members["coefficients.npz"] = members["coefficients.npz"][:-7] + b"garbage"
    with zipfile.ZipFile(path, "w") as z:
        for n, data in members.items():
            z.writestr(n, data)
    with pytest.raises(tser.CheckpointCorruptError, match="coefficients"):
        tser.restore_multi_layer_network(path, device="cpu")


def test_params_from_numpy_rejects_mismatches():
    tn = gpt(compute_dtype="float32", device="cpu", **SIZE)
    tree = jax.tree.map(np.asarray,
                        jax_gpt(compute_dtype="float32", **SIZE).init().params)
    bad = {k: dict(v) for k, v in tree.items()}
    bad["layer1"]["Wo"] = bad["layer1"]["Wo"][:, :5]
    with pytest.raises(ValueError, match="shape"):
        tser.params_from_numpy(tn, bad)
    bad = {k: dict(v) for k, v in tree.items()}
    # a scale beside a float weight: not a quantized weight
    bad["layer1"]["Wqkv_qscale"] = np.ones(96, np.float32)
    with pytest.raises(TypeError, match="not a quantized weight"):
        tser.params_from_numpy(tn, bad)


def _jax_confs():
    yield jax_gpt(compute_dtype="bfloat16", **SIZE).conf
    # every field kind: tuples, a Distribution, per-layer overrides, an
    # input type with auto-wired preprocessors, an lr schedule
    yield (JaxNNC.builder().seed(7).learning_rate(0.05)
           .lr_schedule({0: 0.1, 100: 0.01}).list()
           .layer(JL.ConvolutionLayer(n_out=6, kernel_size=(3, 3),
                                      stride=(1, 1), activation="relu"))
           .layer(JL.SubsamplingLayer(kernel_size=(2, 2)))
           .layer(JL.DenseLayer(n_out=20, weight_init="distribution",
                                dist=JaxDistribution.uniform(-0.2, 0.2),
                                l2=1e-4, dropout=0.5))
           .layer(JL.OutputLayer(n_out=4, activation="softmax"))
           .set_input_type(InputType.convolutional(12, 12, 1))
           .build())
    yield (JaxNNC.builder().activation("tanh").list()
           .layer(JL.GravesLSTM(n_in=5, n_out=7))
           .layer(JL.RnnOutputLayer(n_in=7, n_out=5, activation="softmax"))
           .backprop_type("truncated_bptt").t_bptt_forward_length(9)
           .build())


@pytest.mark.parametrize("i", [0, 1, 2])
def test_config_json_round_trips_byte_for_byte(i):
    jconf = list(_jax_confs())[i]
    text = jconf.to_json()
    assert MultiLayerConfiguration.from_json(text).to_json() == text


def test_port_builder_writes_the_reference_json():
    assert gpt(device="cpu", **SIZE).conf.to_json() == \
        jax_gpt(**SIZE).conf.to_json()


#: a small instance of every layer config the JAX package registers
#: (and the routed-experts TransformerBlock), by registry name
_EVERY_LAYER = {
    "DenseLayer": dict(n_in=4, n_out=3), "OutputLayer": dict(n_in=4, n_out=3),
    "RnnOutputLayer": dict(n_in=4, n_out=3), "LossLayer": {},
    "ConvolutionLayer": dict(n_in=2, n_out=3, kernel_size=(3, 3)),
    "SubsamplingLayer": {}, "BatchNormalization": dict(n_in=3, n_out=3),
    "LocalResponseNormalization": {}, "GravesLSTM": dict(n_in=4, n_out=3),
    "GravesBidirectionalLSTM": dict(n_in=4, n_out=3),
    "AttentionLayer": dict(n_in=4, n_out=4, num_heads=2),
    "EmbeddingLayer": dict(n_in=5, n_out=3),
    "SequenceEmbeddingLayer": dict(n_in=5, n_out=4, max_len=8),
    "TransformerBlock": dict(n_in=8, n_out=8, num_heads=2),
    "MoELayer": dict(n_in=4, n_out=4, num_experts=2),
    "AutoEncoder": dict(n_in=4, n_out=3), "RBM": dict(n_in=4, n_out=3),
    "ActivationLayer": {}, "DropoutLayer": {}, "GlobalPoolingLayer": {},
}
_MOE_BLOCK = ("TransformerBlock", dict(n_in=8, n_out=8, num_heads=2,
                                       num_experts=3))


def test_every_layer_config_of_the_reference_is_covered():
    # the package's own configs (a test may register a custom one)
    assert set(_EVERY_LAYER) == {name for name, cls in JL._LAYER_REGISTRY.items()
                                 if cls.__module__ == JL.__name__}


@pytest.mark.parametrize("case", sorted(_EVERY_LAYER.items()) + [_MOE_BLOCK, None],
                         ids=lambda c: "no_impl" if c is None else (
                             c[0] + ("_experts" if "num_experts" in c[1]
                                     and c[0] == "TransformerBlock" else "")))
def test_unported_layers_parse_but_do_not_build(case):
    """No layer of the JAX package is left unported: each config parses
    from the reference's JSON, builds in the port and draws the
    reference's parameters (the same names and shapes). A config class
    that no impl is registered for still raises, naming it."""
    import dataclasses

    from deeplearning4j_tpu.nn.layers.base import build_layer as jax_build
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as TL
    from deeplearning4j_tpu_torch.nn.layers.base import build_layer

    gc = NeuralNetConfiguration(seed=0, weight_init="xavier", activation="tanh")
    if case is None:
        @dataclasses.dataclass(frozen=True)
        class NoImplLayer(TL.FeedForwardLayer):
            pass

        with pytest.raises(NotImplementedError, match="NoImplLayer"):
            build_layer(gc, NoImplLayer(n_in=2, n_out=2), "x")
        return
    name, kw = case
    jconf = JL._LAYER_REGISTRY[name](**kw)
    tconf = TL.layer_from_dict(jconf.to_dict())
    assert type(tconf).__name__ == name
    want = jax_build(JaxNNC(seed=0, weight_init="xavier", activation="tanh"),
                     jconf, "l").init_params(jax.random.PRNGKey(0))
    got = build_layer(gc, tconf, "l").init_params(
        __import__("torch").Generator().manual_seed(0), "cpu")
    assert list(got) == list(want)
    for pname, v in want.items():
        assert tuple(got[pname].shape) == np.asarray(v).shape, pname
