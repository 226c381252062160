"""The port's GravesLSTM char-RNN slice against the JAX package.

Small sizes (vocab 8, two LSTM layers of 32, t 7, b 8): a JAX
``MultiLayerNetwork`` with random parameters from a numpy seed (the
peepholes nonzero) and the port's net built from its JSON with the same
parameters; one-hot ids from a numpy seed, labels the ids rolled by one.
In f32 the JAX side runs its XLA scan (its kernels are TPU-only) and the
port its fused scan's plain versions, or the plain masked scan where a
mask is given; the two agree to ~1e-6, so outputs are held to 1e-5 and
losses and gradients to 1e-4 (the JAX LSTM test's own tolerances). In
bf16 the JAX side runs its Pallas kernels interpreted (``_on_tpu``
patched to True, as ``tests/test_lstm_kernel.py`` does; hidden 128, the
reference kernel's tile) at the same rounding points as the port; the
stated bf16 tolerances cover the head's bf16 operands and sums in
another order.
"""

import json

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.ops.lstm_kernel as jlk
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn import generate as tgen
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import model_serializer as tser
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

V, H, T, B = 8, 32, 7, 8
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = 1e-4


def _conf(hidden=H, compute_dtype="float32", second="GravesLSTM",
          tbptt=None, updater="adam"):
    lst = (JaxNNC.builder().seed(3).learning_rate(0.01).updater(updater)
           .activation("tanh").compute_dtype(compute_dtype).list()
           .layer(JL.GravesLSTM(n_in=V, n_out=hidden))
           .layer(getattr(JL, second)(n_in=hidden, n_out=hidden))
           .layer(JL.RnnOutputLayer(n_in=hidden, n_out=V, activation="softmax",
                                    loss_function="mcxent")))
    if tbptt:
        lst = lst.backprop_type("truncated_bptt").t_bptt_forward_length(tbptt)
    return lst.build()


def _random_tree(params, seed):
    """numpy parameters of the same shapes: matrices ~ N(0, 1/fan_in),
    vectors (biases, peepholes) ~ N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    return {l: {n: (rng.standard_normal(np.shape(v))
                    * (np.shape(v)[0] ** -0.5 if np.ndim(v) == 2 else 0.1)
                    ).astype(np.float32) for n, v in p.items()}
            for l, p in params.items()}


def _pair(seed=0, **conf):
    jc = _conf(**conf)
    jn = JaxMLN(jc).init()
    tree = _random_tree(jn.params, seed)
    jn.params = jax.tree.map(jax.numpy.asarray, tree)
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(jc.to_json()),
                           device="cpu")
    params_from_numpy(tn, tree)
    return jn, tn


def _data(b=B, t=T, seed=1):
    ids = np.random.default_rng(seed).integers(0, V, (b, t))
    eye = np.eye(V, dtype=np.float32)
    return eye[ids], eye[np.roll(ids, -1, axis=1)]


def _both(x, y, fm=None, lm=None):
    return JaxDataSet(x, y, fm, lm), DataSet(x, y, fm, lm)


def _assert_tree_close(got, want, rtol, atol):
    for layer, p in want.items():
        for name, w in p.items():
            np.testing.assert_allclose(
                got[layer][name].detach().float().numpy(),
                np.asarray(w, np.float32), rtol=rtol, atol=atol,
                err_msg=f"{layer}/{name}")


def _mask(b=B, t=T, seed=2):
    """[b, t] masks with each row's own length (at least 2)."""
    lengths = np.random.default_rng(seed).integers(2, t + 1, b)
    return (np.arange(t)[None] < lengths[:, None]).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_output_matches_jax(masked):
    jn, tn = _pair()
    x, _ = _data()
    fm = _mask() if masked else None
    np.testing.assert_allclose(tn.output(x, features_mask=fm),
                               jn.output(x, features_mask=fm), **OUT_TOL)


@pytest.mark.parametrize("masks", ["none", "labels", "both"])
def test_score_and_gradients_match_jax(masks):
    jn, tn = _pair()
    x, y = _data()
    lm = _mask(seed=3) if masks != "none" else None
    fm = _mask(seed=3) if masks == "both" else None
    jds, tds = _both(x, y, fm, lm)
    js, ts = jn.score(jds), tn.score(tds)
    assert abs(ts - js) <= TOL * abs(js)
    jg, jgs = jn.gradient_and_score(jds)
    tg, tgs = tn.gradient_and_score(tds)
    assert abs(tgs - jgs) <= TOL * abs(jgs)
    assert set(tg["layer0"]) == {"Wx", "Wr", "b", "wci", "wcf", "wco"}
    _assert_tree_close(tg, jg, TOL, TOL)


def _adam_close(tn, jn, lr):
    """Params, m and v after Adam steps. Adam's normalised step
    m / (sqrt(v) + eps) is about sign(g) wherever |g| >> eps, so where a
    gradient is at rounding-noise level its sign, and a step of about
    lr, can flip: params are held to 2 lr per step, and nearly all of
    them (99.9 %) to 1e-5; m and v, which carry no such division, to
    1e-4 relative."""
    steps = tn.opt_state["step"]
    assert steps == int(jn.opt_state["step"])
    _assert_tree_close(tn.params, jn.params, 1e-4, 2 * lr * steps)
    off = sum(int((np.abs(tn.params[l][n].numpy() - np.asarray(w)) > 1e-5).sum())
              for l, p in jn.params.items() for n, w in p.items())
    assert off <= 1e-3 * tn.num_params()
    for l, p in jn.opt_state["updater"].items():
        for n, st in p.items():
            for k, w in st.items():
                np.testing.assert_allclose(
                    tn.opt_state["updater"][l][n][k].numpy(), np.asarray(w),
                    rtol=1e-4, atol=1e-9, err_msg=f"{l}/{n}/{k}")


def test_adam_step_matches_jax():
    jn, tn = _pair()
    jds, tds = _both(*_data())
    jn.fit(jds)
    tn.fit(tds)
    assert abs(tn.score() - jn.score()) <= TOL * abs(jn.score())
    _adam_close(tn, jn, 0.01)


def test_tbptt_fit_matches_jax():
    """Truncated BPTT over two chunks (t 7, length 4): one step per
    chunk, the LSTM carries crossing the boundary as state, the stored
    states back after the fit."""
    jn, tn = _pair(tbptt=4, updater="sgd")
    jds, tds = _both(*_data())
    jn.fit(jds)
    tn.fit(tds)
    assert tn.opt_state["step"] == int(jn.opt_state["step"]) == 2
    assert abs(tn.score() - jn.score()) <= TOL * abs(jn.score())
    _assert_tree_close(tn.params, jn.params, 1e-5, 1e-6)
    assert tn.states == {"layer0": {}, "layer1": {}, "layer2": {}}


def test_tbptt_rejects_what_the_reference_rejects():
    _, tn = _pair(tbptt=4)
    x, _ = _data()
    with pytest.raises(ValueError, match="per-timestep labels"):
        tn.fit(DataSet(x, np.zeros((B, V), np.float32)))


def test_rnn_time_step_matches_jax():
    """Single steps, then a burst that continues from the carries; the
    cleared state starts over."""
    jn, tn = _pair()
    x, _ = _data()
    for s in range(3):
        np.testing.assert_allclose(tn.rnn_time_step(x[:, s]),
                                   jn.rnn_time_step(x[:, s]), **OUT_TOL)
    np.testing.assert_allclose(tn.rnn_time_step(x[:, 3:]),
                               jn.rnn_time_step(x[:, 3:]), **OUT_TOL)
    tn.rnn_clear_previous_state()
    jn.rnn_clear_previous_state()
    np.testing.assert_allclose(tn.rnn_time_step(x), jn.rnn_time_step(x),
                               **OUT_TOL)


def test_rnn_time_step_ends_on_output():
    _, tn = _pair()
    x, _ = _data()
    full = tn.output(x)
    steps = [tn.rnn_time_step(x[:, s]) for s in range(T)]
    np.testing.assert_allclose(np.stack(steps, axis=1), full, **OUT_TOL)


@pytest.mark.parametrize("t_in", [5, 4])  # 5 pads to the bucket of 8
def test_greedy_generate_matches_jax_token_for_token(t_in):
    jn, tn = _pair(seed=4)
    prompts = np.random.default_rng(5).integers(0, V, (B, t_in))
    want = jn.generate(prompts, 9)
    got = tn.generate(prompts, 9)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tgen.generate_eager(tn, prompts, 9), got)
    assert isinstance(tgen.build_generator(tn), tgen.RecurrentGenerator)
    assert tgen._pow2_bucket(t_in) == (8 if t_in == 5 else 4)


def test_sampled_generate_is_seeded_and_eos_fills():
    _, tn = _pair(seed=4)
    prompts = np.random.default_rng(6).integers(0, V, (B, 3))
    a = tn.generate(prompts, 8, temperature=1.0, top_k=4, seed=3)
    b = tgen.generate_eager(tn, prompts, 8, temperature=1.0, top_k=4, seed=3)
    np.testing.assert_array_equal(a, b)
    e = int(a[0, 4])
    eos = tn.generate(prompts, 8, temperature=1.0, top_k=4, seed=3, eos_token=e)
    for got, free in zip(eos[:, 3:], a[:, 3:]):
        hit = np.argmax(free == e) if (free == e).any() else len(free)
        np.testing.assert_array_equal(got[:hit + 1], free[:hit + 1])
        assert (got[hit:] == e).all()


def test_bidirectional_output_and_gradients_match_jax():
    jn, tn = _pair(second="GravesBidirectionalLSTM")
    x, y = _data()
    assert set(tn.params["layer1"]) == {f"{d}_{k}" for d in "fb" for k in (
        "Wx", "Wr", "b", "wci", "wcf", "wco")}
    np.testing.assert_allclose(tn.output(x), jn.output(x), **OUT_TOL)
    jds, tds = _both(x, y)
    jg, js = jn.gradient_and_score(jds)
    tg, ts = tn.gradient_and_score(tds)
    assert abs(ts - js) <= TOL * abs(js)
    _assert_tree_close(tg, jg, TOL, TOL)


def test_zip_round_trips_both_ways_with_updater_state(tmp_path):
    """A JAX zip (after an Adam step) resumes in the port, and the
    port's zip restores in the JAX package: parameters, m and v of the
    six LSTM parameters of each layer, the step; the bidirectional
    ``f_*``/``b_*`` keys through the zip too."""
    jn, _ = _pair(second="GravesBidirectionalLSTM")
    jds, tds = _both(*_data())
    jn.fit(jds)
    path = str(tmp_path / "jax.zip")
    jser.write_model(jn, path)
    tn = tser.restore_multi_layer_network(path, device="cpu")
    assert tn.opt_state["step"] == 1
    _assert_tree_close(tn.params, jn.params, 0, 0)
    for l, p in jn.opt_state["updater"].items():
        for n, st in p.items():
            for k, w in st.items():
                np.testing.assert_array_equal(
                    tn.opt_state["updater"][l][n][k].numpy(), np.asarray(w))
    jn.fit(jds)
    tn.fit(tds)
    _adam_close(tn, jn, 0.01)

    path = str(tmp_path / "port.zip")
    tser.write_model(tn, path)
    assert jser.verify_model_file(path) == []
    back = jser.restore_multi_layer_network(path)
    assert int(back.opt_state["step"]) == 2
    _assert_tree_close(tn.params, back.params, 0, 0)
    assert set(back.opt_state["updater"]["layer1"]) == set(tn.params["layer1"])
    for l, p in back.opt_state["updater"].items():
        for n, st in p.items():
            for k, w in st.items():
                np.testing.assert_array_equal(
                    tn.opt_state["updater"][l][n][k].numpy(), np.asarray(w))
    np.testing.assert_allclose(tn.output(_data()[0]), back.output(_data()[0]),
                               **OUT_TOL)


def test_bf16_output_and_step_loss_match_jax_kernels(monkeypatch):
    """bf16 compute, hidden 128 (the reference kernel's tile), the JAX
    side through its Pallas kernels interpreted. Outputs (softmax
    probabilities) to 2e-2: bf16 h from the same rounding points, summed
    in another order, through the bf16 head; the first step's loss to
    1e-2 relative and the loss after one Adam step likewise."""
    monkeypatch.setattr(jlk, "_on_tpu", lambda: True)
    jn, tn = _pair(hidden=128, compute_dtype="bfloat16")
    x, y = _data()
    assert jlk.fused_lstm_applicable(B, 128, "sigmoid", "tanh", None)
    np.testing.assert_allclose(tn.output(x), jn.output(x), rtol=2e-2, atol=2e-2)
    jds, tds = _both(x, y)
    jn.fit(jds)
    tn.fit(tds)
    assert abs(tn.score() - jn.score()) <= 1e-2 * abs(jn.score())
    assert abs(tn.score(tds) - jn.score(jds)) <= 1e-2 * abs(jn.score(jds))
    assert all(v.dtype == torch.float32 for p in tn.params.values()
               for v in p.values())


def test_cpu_slice_launches_no_kernel():
    _, tn = _pair()
    x, y = _data()
    kernels.reset_launches()
    tn.fit(DataSet(x, y))
    tn.generate(np.zeros((B, 2), np.int64), 3)
    assert sum(kernels.LAUNCHES.values()) == 0


def test_cpu_generate_packs_no_weights():
    """On the CPU the generator runs on the parameters as they are: the
    plain scan reads Wr itself."""
    _, tn = _pair()
    gen = tgen.build_generator(tn)
    sp = gen.serving_params(tn.params, B)
    assert sp.keys() == tn.params.keys()
    assert all(sp[k] is tn.params[k] for k in sp)


def test_config_json_round_trips():
    jc = _conf(second="GravesBidirectionalLSTM", tbptt=5)
    text = jc.to_json()
    assert MultiLayerConfiguration.from_json(text).to_json() == text
    assert json.loads(text)["backprop_type"] == "truncated_bptt"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
def test_slice_runs_the_kernels_on_card(cuda_device):
    """At a shape the kernels take (hidden 128): output and generate
    launch ``lstm_fwd_only`` only, a fit step the training kernels once
    per layer; outputs agree with the CPU run of the same net."""
    jc = _conf(hidden=128)
    tree = _random_tree(JaxMLN(jc).init().params, 7)
    nets = {}
    for dev in ("cpu", "cuda"):
        nets[dev] = MultiLayerNetwork(
            MultiLayerConfiguration.from_json(jc.to_json()), device=dev)
        params_from_numpy(nets[dev], tree)
    x, y = _data()
    kernels.reset_launches()
    out = nets["cuda"].output(x)
    nets["cuda"].generate(np.zeros((B, 3), np.int64), 4)
    assert dict(kernels.LAUNCHES) == {"lstm_fwd_only": 2 + 2 * (4 + 3)}
    np.testing.assert_allclose(out, nets["cpu"].output(x), rtol=1e-4, atol=1e-5)
    kernels.reset_launches()
    nets["cuda"].fit(DataSet(x, y))
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"lstm_fwd": 2, "lstm_bwd": 2, "lstm_dw": 2}


@pytest.mark.cuda
def test_generate_reads_packed_f32_weights_on_card(cuda_device, monkeypatch):
    """On the card each f32 GravesLSTM's Wr is packed once per generate
    call (``serving_params``), and the tokens are those of a run that
    reads Wr itself."""
    jc = _conf(hidden=128)
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(jc.to_json()),
                            device="cuda")
    params_from_numpy(net, _random_tree(JaxMLN(jc).init().params, 8))
    gen = tgen.build_generator(net)
    sp = gen.serving_params(net.params, B)
    lstm_layers = [i.name for i in net.impls[:-1]]
    assert all("Wr_packed" in sp[name] for name in lstm_layers)
    prompts = np.random.default_rng(9).integers(0, V, (B, 5))
    packed = net.generate(prompts, 6)
    monkeypatch.setattr(tgen, "pack_wr", lambda wr, b: None)
    assert "Wr_packed" not in gen.serving_params(net.params, B)[lstm_layers[0]]
    np.testing.assert_array_equal(net.generate(prompts, 6), packed)
