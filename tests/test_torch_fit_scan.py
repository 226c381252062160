"""The port's ``stage_scan``/``fit_scan`` on MultiLayerNetwork against
the JAX package's on the same staged data.

Four small f32, dropout-free nets, each built by the JAX builder and
carried into the port through its JSON and its parameters: MLP-Iris
(4-8-3, nesterovs), LeNet with BatchNormalization (plain SGD, 12x12x1
images), a GravesLSTM char-RNN (vocab 6, 16 units, Adam) and a small
``gpt`` (Adam). Data come from a numpy seed. After ``fit_scan`` the
per-step scores, the parameters, the updater state and BN's moving
statistics equal the reference's: scores, SGD and nesterovs parameters
and every state to 1e-5 relative to the largest magnitude; Adam
parameters to ``2 lr steps`` absolute (Adam's step is about lr sign(g)
where |g| >> eps and steep in g near eps, the rule of
``tests/test_torch_lenet.py``). The same quantities equal N per-step
``fit`` calls of the port; masked data raises, a tail is dropped with
the reference's warning, ``score()`` is the last score and ``staged``
is reused across calls.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models.zoo.transformer import gpt as jax_gpt
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

REL = 1e-5


def _mlp():
    return (JaxNNC.builder().seed(3).learning_rate(0.1).updater("nesterovs")
            .activation("relu").list()
            .layer(JL.DenseLayer(n_in=4, n_out=8))
            .layer(JL.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                  loss_function="mcxent"))
            .build())


def _lenet_bn():
    return (JaxNNC.builder().seed(12345).learning_rate(0.05).updater("sgd")
            .activation("relu").weight_init("relu").list()
            .layer(JL.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                       activation="identity", has_bias=False))
            .layer(JL.BatchNormalization(decay=0.8))
            .layer(JL.ActivationLayer(activation="relu"))
            .layer(JL.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(JL.DenseLayer(n_out=12))
            .layer(JL.OutputLayer(n_out=5, activation="softmax",
                                  loss_function="mcxent"))
            .set_input_type(JaxInputType.convolutional(12, 12, 1))
            .build())


def _lstm():
    return (JaxNNC.builder().seed(3).learning_rate(0.01).updater("adam")
            .activation("tanh").list()
            .layer(JL.GravesLSTM(n_in=6, n_out=16))
            .layer(JL.RnnOutputLayer(n_in=16, n_out=6, activation="softmax",
                                     loss_function="mcxent"))
            .build())


GPT = dict(vocab_size=16, d_model=16, n_layers=2, num_heads=2, max_len=8,
           compute_dtype="float32")


def _data(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "mlp":
        return (rng.standard_normal((n, 4)).astype(np.float32),
                np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])
    if kind == "lenet_bn":
        return (rng.random((n, 12, 12, 1)).astype(np.float32),
                np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)])
    if kind == "lstm":
        ids = rng.integers(0, 6, (n, 5))
        eye = np.eye(6, dtype=np.float32)
        return eye[ids], eye[np.roll(ids, -1, axis=1)]
    ids = rng.integers(0, GPT["vocab_size"], (n, GPT["max_len"]))
    return ids.astype(np.float32), np.roll(ids, -1, axis=1).astype(np.float32)


KINDS = {"mlp": _mlp, "lenet_bn": _lenet_bn, "lstm": _lstm, "gpt": None}


def _pair(kind):
    jn = jax_gpt(**GPT) if kind == "gpt" else JaxMLN(KINDS[kind]())
    jn.init()
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(jn.conf.to_json()),
                           device="cpu")
    params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
    return jn, tn


def _close(got, want, tol=REL, err=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (err, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    rel = float(np.abs(got - want).max()) / scale
    assert rel <= tol, f"{err} max error {rel:.3g} of max |want| {scale:.3g} > {tol}"


def _leaves(tree, prefix=""):
    """{path: numpy array} of a nested dict of arrays or tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                               else np.asarray(v))
    return out


def _assert_params(tn, jn):
    got, want = _leaves(tn.params), _leaves(jn.params)
    assert set(got) == set(want)
    adam = tn.gc.updater == "adam"
    steps = int(tn.opt_state["step"])
    for k, w in want.items():
        if adam:
            np.testing.assert_allclose(got[k], w, rtol=0,
                                       atol=2 * tn.gc.learning_rate * steps,
                                       err_msg=k)
        else:
            _close(got[k], w, err=k)


def _assert_states(tn, jn):
    """The updater state and the layers' states (BN's moving statistics)."""
    assert int(tn.opt_state["step"]) == int(jn.opt_state["step"])
    for got, want in ((tn.opt_state["updater"], jn.opt_state["updater"]),
                      (tn.states, jn.states)):
        got, want = _leaves(got), _leaves(want)
        assert set(got) == set(want)
        for k, w in want.items():
            _close(got[k], w, err=k)


@pytest.mark.parametrize("kind", list(KINDS))
def test_fit_scan_matches_reference(kind):
    jn, tn = _pair(kind)
    x, y = _data(kind, 12)
    batch, epochs = 4, 2
    want = np.asarray(jn.fit_scan(JaxDataSet(x, y), batch, epochs=epochs))
    got = tn.fit_scan(DataSet(x, y), batch, epochs=epochs)
    assert got.shape == want.shape == (epochs * 3,)
    _close(got, want)
    assert tn.score() == float(got[-1])
    _assert_params(tn, jn)
    _assert_states(tn, jn)


@pytest.mark.parametrize("kind", list(KINDS))
def test_fit_scan_equals_per_step_fit(kind):
    """fit_scan is the per-step ``fit`` over the staged minibatches:
    the same scores, parameters and states."""
    _, a = _pair(kind)
    _, b = _pair(kind)
    x, y = _data(kind, 12)
    scores = a.fit_scan(DataSet(x, y), 4, epochs=2)
    steps = []
    for _ in range(2):
        for i in range(0, 12, 4):
            b.fit(DataSet(x[i:i + 4], y[i:i + 4]))
            steps.append(b.score())
    np.testing.assert_allclose(scores, steps, rtol=1e-6, atol=0)
    for ta, tb in ((a.params, b.params), (a.opt_state["updater"], b.opt_state["updater"]),
                   (a.states, b.states)):
        la, lb = _leaves(ta), _leaves(tb)
        for k in lb:
            np.testing.assert_allclose(la[k], lb[k], rtol=1e-6, atol=1e-7, err_msg=k)
    assert a.opt_state["step"] == b.opt_state["step"] == 6


def test_fit_scan_reuses_staged_data_and_runs_conf_iterations():
    """``staged`` is reused across calls, and each minibatch takes
    ``conf.iterations`` steps (its last score kept), as the reference's."""
    conf = (JaxNNC.builder().seed(3).learning_rate(0.1).updater("sgd")
            .iterations(2).activation("relu").list()
            .layer(JL.DenseLayer(n_in=4, n_out=8))
            .layer(JL.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                  loss_function="mcxent"))
            .build())
    jn = JaxMLN(conf).init()
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf.to_json()),
                           device="cpu")
    params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
    x, y = _data("mlp", 8)
    jstaged = jn.stage_scan(JaxDataSet(x, y), 4)
    staged = tn.stage_scan(DataSet(x, y), 4)
    assert staged[0].shape == (2, 4, 4) and staged[1].shape == (2, 4, 3)
    assert staged[0].dtype == torch.float32 and staged[0].device.type == "cpu"
    for _ in range(2):
        want = np.asarray(jn.fit_scan(None, 4, staged=jstaged))
        got = tn.fit_scan(None, 4, staged=staged)
        _close(got, want)
    assert tn.opt_state["step"] == 8
    _assert_params(tn, jn)


def test_fit_scan_refuses_masks_and_drops_the_tail(caplog):
    _, tn = _pair("mlp")
    x, y = _data("mlp", 14)
    with pytest.raises(ValueError, match="masked"):
        tn.fit_scan(DataSet(x, y, labels_mask=np.ones(14, np.float32)), 4)
    with pytest.raises(ValueError, match="masked"):
        tn.stage_scan(DataSet(x, y, features_mask=np.ones(14, np.float32)), 4)
    with pytest.raises(ValueError, match="batch_size larger than dataset"):
        tn.fit_scan(DataSet(x, y), 16)
    with caplog.at_level(logging.WARNING, logger="deeplearning4j_tpu_torch"):
        scores = tn.fit_scan(DataSet(x, y), 4)
    assert scores.shape == (3,)
    assert ("fit_scan: dropping 2 tail examples (dataset 14 % batch 4)"
            in caplog.messages)
    assert tn.score() == float(scores[-1])


def test_fit_scan_does_not_call_listeners():
    _, tn = _pair("mlp")
    seen = []
    tn.set_listeners(lambda net, it, score: seen.append(it))
    x, y = _data("mlp", 8)
    tn.fit_scan(DataSet(x, y), 4)
    assert seen == []
    tn.fit(DataSet(x[:4], y[:4]))
    assert seen == [3]


def test_pretrain_names_queue_a3():
    # layer-wise pretraining (ROADMAP Queue A3) is ported: a stack with
    # no RBM or AutoEncoder layer pretrains nothing, as the reference's
    jn, tn = _pair("mlp")
    assert tn.pretrain(None) == jn.pretrain(None) == {}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _lstm128():
    return (JaxNNC.builder().seed(3).learning_rate(0.01).updater("adam")
            .activation("tanh").list()
            .layer(JL.GravesLSTM(n_in=6, n_out=128))
            .layer(JL.RnnOutputLayer(n_in=128, n_out=6, activation="softmax",
                                     loss_function="mcxent"))
            .build())


def _card_pair(kind, device):
    """Two port nets on the card with the reference's parameters (the
    LSTM at 128 units, a width the kernels take)."""
    if kind == "lstm128":
        conf = MultiLayerConfiguration.from_json(_lstm128().to_json())
        tree = jax.tree.map(np.asarray, JaxMLN(_lstm128()).init().params)
    else:
        jn, tn = _pair(kind)
        conf, tree = tn.conf, jax.tree.map(np.asarray, jn.params)
    return [params_from_numpy(MultiLayerNetwork(conf, device=device).init(), tree)
            for _ in range(2)]


# the port kernels one training step launches (once per layer)
CARD_KERNELS = {"mlp": {}, "lenet_bn": {},
                "lstm128": {"lstm_fwd": 1, "lstm_bwd": 1, "lstm_dw": 1},
                "gpt": {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2}}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(CARD_KERNELS))
def test_fit_scan_on_card_equals_per_step_fit_on_card(cuda_device, kind):
    """On the card, fit_scan over staged data is the per-step ``fit``
    over the same minibatches (scores, parameters and updater state
    within 1e-6), and each step launches the path's port kernels."""
    from deeplearning4j_tpu_torch import kernels

    a, b = _card_pair(kind, cuda_device)
    x, y = _data("lstm" if kind == "lstm128" else kind, 12)
    staged = a.stage_scan(DataSet(x, y), 4)
    assert staged[0].device.type == "cuda"
    kernels.reset_launches()
    scores = a.fit_scan(None, 4, epochs=2, staged=staged)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    assert launches == {k: 6 * v for k, v in CARD_KERNELS[kind].items()}
    steps = []
    for _ in range(2):
        for i in range(0, 12, 4):
            b.fit(DataSet(x[i:i + 4], y[i:i + 4]))
            steps.append(b.score())
    np.testing.assert_allclose(scores, steps, rtol=1e-6, atol=0)
    for ta, tb in ((a.params, b.params),
                   (a.opt_state["updater"], b.opt_state["updater"])):
        la, lb = _leaves(ta), _leaves(tb)
        for k in lb:
            np.testing.assert_allclose(la[k], lb[k], rtol=1e-6, atol=1e-7, err_msg=k)
