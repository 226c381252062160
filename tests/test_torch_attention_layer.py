"""The port's ``AttentionLayer`` against the JAX package.

A stack of ``AttentionLayer``s under an ``RnnOutputLayer``, built from
the reference's JSON with its parameters carried across, on float
features from a numpy seed (f32): outputs within 1e-5 and the score
within 1e-5, gradients within 1e-4 (relative to the largest magnitude),
causal and not, with a features mask (keys masked: the flash wrapper's
own rule sends the call to the plain formulation, as the reference's
dispatch gate does) and without, at t = 16 (the flash branch) and
t = 12 (no dividing block: the plain formulation), with and without
the residual. One SGD step within 1e-5. The layer's errors are the
reference's.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.configuration import (
    MultiLayerConfiguration as JaxMLC,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

F32, GRAD = 1e-5, 1e-4
B, F, C = 3, 8, 5


def _close(got, want, tol):
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max error {err:.3g} of max |want| {scale:.3g} > {tol}"


def _text(causal, residual=True, n_out=F, updater="sgd"):
    return (JaxNNC.builder().seed(11).learning_rate(0.1).updater(updater)
            .activation("identity").weight_init("xavier").list()
            .layer(JL.AttentionLayer(n_in=F, n_out=F, num_heads=2,
                                     causal=causal, residual=residual))
            .layer(JL.AttentionLayer(n_in=F, n_out=n_out, num_heads=2,
                                     causal=causal,
                                     residual=residual and n_out == F))
            .layer(JL.RnnOutputLayer(n_in=n_out, n_out=C, activation="softmax",
                                     loss_function="mcxent"))
            .build().to_json())


def _pair(text):
    jn = JaxMLN(JaxMLC.from_json(text)).init()
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(text), device="cpu")
    params_from_numpy(tn, jax.tree.map(lambda a: np.asarray(a, np.float32),
                                       jn.params))
    return jn, tn


def _data(t, masked, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, t, F)).astype(np.float32)
    y = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, t))]
    if not masked:
        return x, y, None, None
    m = np.ones((B, t), np.float32)
    m[0, t - 5:] = 0.0
    m[2, t - 2:] = 0.0
    return x, y, m, m


@pytest.mark.parametrize("t", [16, 12])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_and_backward_match(causal, masked, t):
    jn, tn = _pair(_text(causal))
    x, y, fm, lm = _data(t, masked)
    _close(tn.output(x, features_mask=fm),
           np.asarray(jn.output(x, features_mask=fm)), F32)
    jds, tds = JaxDataSet(x, y, fm, lm), DataSet(x, y, fm, lm)
    jg, js = jn.gradient_and_score(jds)
    tg, ts = tn.gradient_and_score(tds)
    _close(ts, js, F32)
    for layer, p in jg.items():
        assert set(tg[layer]) == set(p)
        for name, g in p.items():
            _close(tg[layer][name], g, GRAD)


@pytest.mark.parametrize("residual", [True, False])
def test_residual_and_an_sgd_step(residual):
    jn, tn = _pair(_text(True, residual=residual, n_out=12))
    assert set(tn.params["layer0"]) == {"Wq", "Wk", "Wv", "Wo", "bo"}
    x, y, _, _ = _data(16, False, seed=1)
    jn.fit(JaxDataSet(x, y))
    tn.fit(DataSet(x, y))
    _close(tn.score(), float(jn.score()), F32)
    for layer, p in jn.params.items():
        for name, w in p.items():
            _close(tn.params[layer][name], w, F32)


def test_layer_errors_are_the_references():
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as TL
    from deeplearning4j_tpu_torch.nn.layers.base import build_layer

    gc = NeuralNetConfiguration(seed=1, weight_init="xavier")
    impl = build_layer(gc, TL.AttentionLayer(n_in=4, n_out=4, num_heads=2), "a")
    p = impl.init_params(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match=r"\[batch, time, features\]"):
        impl.forward(p, torch.zeros(2, 4), {}, False)
    bad = build_layer(gc, TL.AttentionLayer(n_in=4, n_out=6, num_heads=2,
                                            residual=True), "b")
    pb = bad.init_params(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="residual attention needs n_in == n_out"):
        bad.forward(pb, torch.zeros(2, 3, 4), {}, False)
    odd = build_layer(gc, TL.AttentionLayer(n_in=4, n_out=6, num_heads=4), "c")
    with pytest.raises(ValueError, match="not divisible by num_heads"):
        odd.init_params(torch.Generator().manual_seed(0), "cpu")
