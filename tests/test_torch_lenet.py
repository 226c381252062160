"""The port's feed-forward + CNN slice against the JAX package on a small
LeNet: conv 4@5x5, max 2x2/2, conv 8@5x5, max 2x2/2, dense 24, softmax
10, on 20x20x1 images, built through ``set_input_type`` (n_in wired and
the NHWC flatten inserted), plus a variant with BatchNormalization and
LRN whose moving statistics ride in the zip's ``modelState.npz``.

The JAX net's parameters are carried into the port's net; images and
one-hot labels come from a numpy seed. Tolerances, relative to the
largest magnitude of the reference's array: f32 outputs and scores
1e-5, gradients 1e-4, one Adam step 1e-5 (see ``_assert_adam_step``);
bf16 3e-2. ``check_gradients`` runs in f64 on both packages with the
reference's defaults.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.gradientcheck import check_gradients as jax_check
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.preprocessors import CnnToFeedForwardPreProcessor
from deeplearning4j_tpu_torch.nn.gradientcheck import check_gradients
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import model_serializer as tser
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

F32, GRAD, BF16 = 1e-5, 1e-4, 3e-2
HW, B = 20, 16


def assert_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max error {err:.3g} of max |want| {scale:.3g} > {tol}"


def _lenet(NNC, Lmod, IT, compute_dtype="float32", bn=False):
    lb = (NNC.builder().seed(12345).learning_rate(0.01).updater("adam")
          .activation("relu").weight_init("relu").compute_dtype(compute_dtype)
          .list())
    if bn:
        lb = (lb.layer(Lmod.ConvolutionLayer(n_out=4, kernel_size=(5, 5),
                                             activation="identity", has_bias=False))
              .layer(Lmod.BatchNormalization(decay=0.8))
              .layer(Lmod.ActivationLayer(activation="relu"))
              .layer(Lmod.LocalResponseNormalization(n=4.0)))
    else:
        lb = lb.layer(Lmod.ConvolutionLayer(n_out=4, kernel_size=(5, 5)))
    return (lb.layer(Lmod.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(Lmod.ConvolutionLayer(n_out=8, kernel_size=(5, 5)))
            .layer(Lmod.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(Lmod.DenseLayer(n_out=24))
            .layer(Lmod.OutputLayer(n_out=10, activation="softmax",
                                    loss_function="mcxent"))
            .set_input_type(IT.convolutional(HW, HW, 1))
            .build())


def _pair(compute_dtype="float32", bn=False):
    jconf = _lenet(JaxNNC, JL, JaxInputType, compute_dtype, bn)
    tconf = _lenet(NeuralNetConfiguration, L, InputType, compute_dtype, bn)
    jn = JaxMLN(jconf).init()
    tn = MultiLayerNetwork(tconf, device="cpu").init()
    params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
    return jn, tn


def _data(n=B, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, HW, HW, 1)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return x, y


def _assert_params(tn, jn, tol):
    assert set(tn.params) == set(jn.params)
    for layer, p in jn.params.items():
        assert set(tn.params[layer]) == set(p)
        for name, v in p.items():
            assert_close(tn.params[layer][name].cpu().numpy(), np.asarray(v), tol)


def _assert_adam_step(tn, jn):
    """Parameters after Adam steps. Adam's first step is lr *
    m / (sqrt(v) + eps), about lr * sign(g) wherever |g| >> eps, and
    steep in g where |g| is near eps: there the gradients' last-bit
    differences move the step. So 99.9 % of the parameters are held to
    1e-5 and every one to 2 lr per step (as the GPT slice's test)."""
    lr, steps = tn.gc.learning_rate, tn.opt_state["step"]
    assert steps == int(jn.opt_state["step"])
    off = 0
    for layer, p in jn.params.items():
        for name, v in p.items():
            got, want = tn.params[layer][name].cpu().numpy(), np.asarray(v)
            np.testing.assert_allclose(got, want, rtol=0, atol=2 * lr * steps)
            off += int((np.abs(got - want) > F32 * np.abs(want).max()).sum())
    assert off <= 1e-3 * tn.num_params(), off


def _assert_states(tn, jn, tol):
    for layer, st in jn.states.items():
        for name, v in st.items():
            assert_close(tn.states[layer][name].cpu().numpy(), np.asarray(v), tol)


def test_builder_wires_the_reference_config():
    """n_in of every layer and the NHWC flatten before the dense layer,
    the same JSON as the JAX builder."""
    for bn in (False, True):
        jconf = _lenet(JaxNNC, JL, JaxInputType, bn=bn)
        tconf = _lenet(NeuralNetConfiguration, L, InputType, bn=bn)
        assert tconf.to_json() == jconf.to_json()
    tconf = _lenet(NeuralNetConfiguration, L, InputType)
    assert tconf.input_preprocessors == {4: CnnToFeedForwardPreProcessor()}
    assert [getattr(lc, "n_in", None) for lc in tconf.layers] == \
        [1, None, 4, None, 2 * 2 * 8, 24]


@pytest.mark.parametrize("bn", [False, True], ids=["lenet", "lenet_bn_lrn"])
def test_forward_score_and_gradients_match_reference(bn):
    jn, tn = _pair(bn=bn)
    x, y = _data()
    assert_close(tn.output(x), np.asarray(jn.output(x)), F32)
    np.testing.assert_array_equal(tn.predict(x), np.asarray(jn.predict(x)))
    for ta, ja in zip(tn.feed_forward(x), jn.feed_forward(x)):
        assert_close(ta, np.asarray(ja), F32)
    assert_close(tn.score(DataSet(x, y)), jn.score(JaxDataSet(x, y)), F32)
    tg, ts = tn.gradient_and_score(DataSet(x, y))
    jg, js = jn.gradient_and_score(JaxDataSet(x, y))
    assert_close(ts, js, F32)
    for layer, p in jg.items():
        for name, v in p.items():
            assert_close(tg[layer][name].numpy(), np.asarray(v), GRAD)


@pytest.mark.parametrize("bn", [False, True], ids=["lenet", "lenet_bn_lrn"])
def test_one_adam_step_matches_reference(bn):
    """One fit step: parameters, Adam moments, the step's score and (BN)
    the moving statistics."""
    jn, tn = _pair(bn=bn)
    x, y = _data()
    jn.fit(JaxDataSet(x, y))
    tn.fit(DataSet(x, y))
    assert_close(tn.score(), jn.score(), F32)
    _assert_adam_step(tn, jn)
    _assert_states(tn, jn, F32)
    for layer, p in jn.opt_state["updater"].items():
        for name, st in p.items():
            for k, v in st.items():
                assert_close(tn.opt_state["updater"][layer][name][k].numpy(),
                             np.asarray(v), GRAD)
    # and inference then reads the moving statistics, as the reference
    assert_close(tn.output(x), np.asarray(jn.output(x)), F32)


def test_bf16_output_and_score_match_reference():
    jn, tn = _pair(compute_dtype="bfloat16")
    x, y = _data()
    assert_close(tn.output(x), np.asarray(jn.output(x)), BF16)
    assert_close(tn.score(DataSet(x, y)), jn.score(JaxDataSet(x, y)), BF16)


def test_evaluate_matches_reference():
    """The same confusion matrix, in batches with a short tail."""
    jn, tn = _pair()
    x, y = _data(n=37, seed=3)
    tev = tn.evaluate(DataSet(x, y), batch_size=16)
    jev = jn.evaluate(JaxDataSet(x, y), batch_size=16)
    np.testing.assert_array_equal(tev.confusion.counts, jev.confusion.counts)
    assert tev.accuracy() == jev.accuracy() and tev.stats() == jev.stats()


@pytest.mark.parametrize("bn", [False, True], ids=["lenet", "lenet_bn_lrn"])
def test_jax_zip_loads_in_port(tmp_path, bn):
    jn, _ = _pair(bn=bn)
    x, y = _data()
    jn.fit(JaxDataSet(x, y))  # moves BN's statistics off their init
    path = str(tmp_path / "jax.zip")
    jser.write_model(jn, path)
    tn = tser.restore_multi_layer_network(path, device="cpu")
    assert tn.conf.to_json() == jn.conf.to_json()
    _assert_params(tn, jn, 0.0)
    _assert_states(tn, jn, 0.0)
    assert_close(tn.output(x), np.asarray(jn.output(x)), F32)
    # training resumes where it stopped: one more step on each side
    jn.fit(JaxDataSet(x, y))
    tn.fit(DataSet(x, y))
    _assert_adam_step(tn, jn)


@pytest.mark.parametrize("bn", [False, True], ids=["lenet", "lenet_bn_lrn"])
def test_port_zip_loads_in_jax(tmp_path, bn):
    jn, tn = _pair(bn=bn)
    x, y = _data()
    tn.fit(DataSet(x, y))
    path = str(tmp_path / "port.zip")
    tser.write_model(tn, path)
    assert jser.verify_model_file(path) == []
    back = jser.restore_multi_layer_network(path)
    assert back.conf.to_json() == jn.conf.to_json()
    _assert_params(tn, back, 0.0)
    _assert_states(tn, back, 0.0)
    assert_close(tn.output(x), np.asarray(back.output(x)), F32)


def test_weight_carry_takes_bn_state_and_adam_state():
    """``params_from_numpy``, ``states_from_numpy`` and
    ``opt_state_from_numpy`` carry a trained JAX net (BN's moving
    statistics and the Adam moments included) into the port: the same
    inference output, and the next step as the reference's."""
    jn, _ = _pair(bn=True)
    x, y = _data()
    jn.fit(JaxDataSet(x, y))
    tn = MultiLayerNetwork(_lenet(NeuralNetConfiguration, L, InputType, bn=True),
                           device="cpu").init()
    host = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    params_from_numpy(tn, host(jn.params))
    tser.states_from_numpy(tn, host(jn.states))
    tser.opt_state_from_numpy(tn, host(jn.opt_state))
    _assert_states(tn, jn, 0.0)
    assert_close(tn.output(x), np.asarray(jn.output(x)), F32)
    jn.fit(JaxDataSet(x, y))
    tn.fit(DataSet(x, y))
    _assert_adam_step(tn, jn)
    _assert_states(tn, jn, F32)
    with pytest.raises(ValueError, match="shape"):
        tser.states_from_numpy(tn, {"layer1": {"mean": np.zeros(5, np.float32)}})


def test_check_gradients_f64_passes_on_both():
    """The finite-difference oracle in f64 with the reference's defaults,
    on the same parameters, passes in both packages; the BN variant is
    checked in training mode (batch statistics)."""
    for bn in (False, True):
        jn, tn = _pair(bn=bn)
        jn64 = JaxMLN(jn.conf).init(dtype=jax.numpy.float64)
        jn64.params = jax.tree.map(lambda v: v.astype(jax.numpy.float64), jn.params)
        tn.init(dtype=torch.float64)
        params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
        assert tn.params["layer0"]["W"].dtype == torch.float64
        x, y = _data(n=6, seed=5)
        t = check_gradients(tn, DataSet(x.astype(np.float64), y.astype(np.float64)),
                            train=bn)
        j = jax_check(jn64, JaxDataSet(x.astype(np.float64), y.astype(np.float64)),
                      train=bn)
        assert t.ok, t.failures
        assert j.ok, j.failures
        assert t.n_checked == j.n_checked == tn.num_params()


def test_check_gradients_catches_a_wrong_gradient():
    """The oracle fails when the analytic gradient is wrong: a layer
    whose backward is scaled by 2."""
    _, tn = _pair()
    tn.init(dtype=torch.float64)
    impl = tn.impls[4]
    forward = impl.forward

    class Twice(torch.autograd.Function):
        @staticmethod
        def forward(ctx, v):
            return v.clone()

        @staticmethod
        def backward(ctx, g):
            return 2 * g

    impl.forward = lambda p, x, *a, **k: forward(p, Twice.apply(x), *a, **k)
    x, y = _data(n=4, seed=6)
    res = check_gradients(tn, DataSet(x.astype(np.float64), y.astype(np.float64)),
                          subset=200)
    assert not res.ok and res.n_failed > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [False, True], ids=["lenet", "lenet_bn_lrn"])
def test_lenet_on_card_matches_cpu(cuda_device, bn):
    """The same f32 net on the card and on the CPU: output within 1e-4
    relative, one step's gradients within 1e-3 over the examples away
    from a kink (cuDNN sums in another order; the convolutions compute in
    f32, not TF32)."""
    _, cpu = _pair(bn=bn)
    card = MultiLayerNetwork(cpu.conf, device=cuda_device).init()
    params_from_numpy(card, {l: {n: v.numpy() for n, v in p.items()}
                             for l, p in cpu.params.items()})
    x, y = _data(n=64, seed=7)
    assert_close(card.output(x), cpu.output(x), 1e-4)
    # the gradients over the examples away from a kink (see
    # chip_smoke.kink_free): at a ReLU input within f32 rounding of 0 the
    # two sides may round to either side and their gradients jump apart
    cpu64 = MultiLayerNetwork(cpu.conf, device="cpu").init(torch.float64)
    params_from_numpy(cpu64, {l: {n: v.numpy() for n, v in p.items()}
                              for l, p in cpu.params.items()})
    kept = chip_smoke.kink_free(cpu64, x, y)
    assert kept.sum() >= chip_smoke.LENET_MIN_KEPT
    x, y = x[kept], y[kept]
    gc, sc = card.gradient_and_score(DataSet(x, y))
    gp, sp = cpu.gradient_and_score(DataSet(x, y))
    assert_close(sc, sp, 1e-4)
    for layer, p in gp.items():
        for name, v in p.items():
            assert_close(gc[layer][name].cpu().numpy(), v.numpy(), 1e-3)
