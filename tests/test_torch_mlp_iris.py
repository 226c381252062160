"""The port's MLP-Iris path and its data, evaluation, listener and
gradient-check modules against the JAX package.

The net is the Iris benchmark's (4-64-64-3, relu, softmax + mcxent,
Adam at 0.1, seed 3) with the JAX net's parameters carried into the
port's. Tolerances, relative to the largest magnitude of the
reference's array: f32 outputs and scores 1e-5, gradients 1e-4, one
Adam step 1e-5 (99.9 % of parameters, every one within 2 lr: Adam's
step is steep in g where |g| is near eps); bf16 3e-2. The port's Iris
rows must equal scikit-learn's, its synthetic MNIST the reference's
arrays, and its IDX reader the reference's on files written here.
"""

import gzip
import logging
import os
import struct

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.datasets.mnist as jmnist
import deeplearning4j_tpu_torch.datasets.mnist as tmnist
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iris import IrisDataSetIterator as JaxIrisIt
from deeplearning4j_tpu.datasets.iris import load_iris_dataset as jax_iris
from deeplearning4j_tpu.eval.evaluation import Evaluation as JaxEvaluation
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.gradientcheck import check_gradients as jax_check
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.optimize import listeners as jlst
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iris import (
    IrisDataSetIterator,
    iris_rows,
    load_iris_dataset,
)
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.gradientcheck import check_gradients
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import listeners as tlst
from deeplearning4j_tpu_torch.util import model_serializer as tser
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

F32, GRAD, BF16 = 1e-5, 1e-4, 3e-2
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def assert_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max error {err:.3g} of max |want| {scale:.3g} > {tol}"


def _mlp(NNC, Lmod, compute_dtype="float32"):
    return (NNC.builder().seed(3).learning_rate(0.1).updater("adam")
            .activation("relu").compute_dtype(compute_dtype)
            .list()
            .layer(Lmod.DenseLayer(n_in=4, n_out=64))
            .layer(Lmod.DenseLayer(n_in=64, n_out=64))
            .layer(Lmod.OutputLayer(n_in=64, n_out=3, activation="softmax",
                                    loss_function="mcxent"))
            .build())


def _pair(compute_dtype="float32"):
    jn = JaxMLN(_mlp(JaxNNC, JL, compute_dtype)).init()
    tn = MultiLayerNetwork(_mlp(NeuralNetConfiguration, L, compute_dtype),
                           device="cpu").init()
    assert tn.conf.to_json() == jn.conf.to_json()
    params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
    return jn, tn


def _iris(n=150):
    ds = load_iris_dataset(shuffle_seed=6)
    return ds.features[:n].astype(np.float32), ds.labels[:n].astype(np.float32)


def test_iris_copy_equals_scikit_learn():
    sklearn_datasets = pytest.importorskip("sklearn.datasets")
    ref = sklearn_datasets.load_iris()
    x, target = iris_rows()
    np.testing.assert_array_equal(x, ref.data)
    np.testing.assert_array_equal(target, ref.target)
    for kw in (dict(), dict(normalize=False), dict(shuffle_seed=6)):
        t, j = load_iris_dataset(**kw), jax_iris(**kw)
        np.testing.assert_array_equal(t.features, j.features)
        np.testing.assert_array_equal(t.labels, j.labels)
    batches = list(zip(IrisDataSetIterator(40, 100), JaxIrisIt(40, 100)))
    assert len(batches) == 3
    for t, j in batches:
        np.testing.assert_array_equal(t.features, j.features)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_mlp_output_score_gradients_match_reference(cd):
    jn, tn = _pair(cd)
    x, y = _iris()
    tol, gtol = (F32, GRAD) if cd == "float32" else (BF16, BF16)
    assert_close(tn.output(x), np.asarray(jn.output(x)), tol)
    assert_close(tn.score(DataSet(x, y)), jn.score(JaxDataSet(x, y)), tol)
    tg, ts = tn.gradient_and_score(DataSet(x, y))
    jg, js = jn.gradient_and_score(JaxDataSet(x, y))
    for layer, p in jg.items():
        for name, v in p.items():
            assert_close(tg[layer][name].numpy(), np.asarray(v), gtol)


def test_mlp_one_adam_step_matches_reference():
    jn, tn = _pair()
    x, y = _iris()
    jn.fit(JaxDataSet(x, y))
    tn.fit(DataSet(x, y))
    assert_close(tn.score(), jn.score(), F32)
    lr, off = 0.1, 0
    for layer, p in jn.params.items():
        for name, v in p.items():
            got, want = tn.params[layer][name].numpy(), np.asarray(v)
            np.testing.assert_allclose(got, want, rtol=0, atol=2 * lr)
            off += int((np.abs(got - want) > F32 * np.abs(want).max()).sum())
    assert off <= 1e-3 * tn.num_params(), off
    for layer, p in jn.opt_state["updater"].items():
        for name, st in p.items():
            for k, v in st.items():
                assert_close(tn.opt_state["updater"][layer][name][k].numpy(),
                             np.asarray(v), GRAD)


def _heads(NNC, Lmod, kind, compute_dtype):
    lb = (NNC.builder().seed(5).learning_rate(0.2).updater("sgd")
          .activation("tanh").compute_dtype(compute_dtype).list())
    if kind == "loss_layer":
        return (lb.layer(Lmod.DenseLayer(n_in=4, n_out=8))
                .layer(Lmod.DenseLayer(n_in=8, n_out=3, activation="identity"))
                .layer(Lmod.LossLayer(activation="softmax", loss_function="mcxent"))
                .build())
    return (lb.layer(Lmod.DenseLayer(n_in=4, n_out=8, has_bias=False))
            .layer(Lmod.OutputLayer(n_in=8, n_out=3, activation="sigmoid",
                                    loss_function="xent", has_bias=False))
            .build())


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["loss_layer", "no_bias"])
def test_loss_layer_and_bias_free_nets_match_reference(kind, cd):
    """A parameterless LossLayer head (its loss in f32 under bf16) and
    dense layers with ``has_bias=False``: output, score, gradients and
    three SGD steps."""
    jn = JaxMLN(_heads(JaxNNC, JL, kind, cd)).init()
    tn = MultiLayerNetwork(_heads(NeuralNetConfiguration, L, kind, cd),
                           device="cpu").init()
    assert tn.conf.to_json() == jn.conf.to_json()
    params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
    assert ("b" in tn.params["layer0"]) == (kind == "loss_layer")
    x, y = _iris(64)
    tol, gtol = (F32, GRAD) if cd == "float32" else (BF16, BF16)
    assert_close(tn.output(x), np.asarray(jn.output(x)), tol)
    assert_close(tn.score(DataSet(x, y)), jn.score(JaxDataSet(x, y)), tol)
    tg, _ = tn.gradient_and_score(DataSet(x, y))
    jg, _ = jn.gradient_and_score(JaxDataSet(x, y))
    for layer, p in jg.items():
        for name, v in p.items():
            assert_close(tg[layer][name].numpy(), np.asarray(v), gtol)
    for _ in range(3):
        jn.fit(JaxDataSet(x, y))
        tn.fit(DataSet(x, y))
    for layer, p in jn.params.items():
        for name, v in p.items():
            assert_close(tn.params[layer][name].numpy(), np.asarray(v), gtol)


def test_mlp_evaluate_and_predict_match_reference():
    jn, tn = _pair()
    x, y = _iris()
    for _ in range(3):
        jn.fit(JaxDataSet(x, y))
        tn.fit(DataSet(x, y))
    tev, jev = tn.evaluate(DataSet(x, y), batch_size=64), \
        jn.evaluate(JaxDataSet(x, y), batch_size=64)
    np.testing.assert_array_equal(tev.confusion.counts, jev.confusion.counts)
    np.testing.assert_array_equal(tn.predict(x), np.asarray(jn.predict(x)))
    assert tev.confusion.counts.sum() == 150


def test_check_gradients_f64_passes_on_both():
    jn, tn = _pair()
    jn64 = JaxMLN(jn.conf).init(dtype=jax.numpy.float64)
    jn64.params = jax.tree.map(lambda v: v.astype(jax.numpy.float64), jn.params)
    tn.init(dtype=torch.float64)
    params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
    x, y = _iris(20)
    t = check_gradients(tn, DataSet(x.astype(np.float64), y.astype(np.float64)))
    j = jax_check(jn64, JaxDataSet(x.astype(np.float64), y.astype(np.float64)))
    assert t.ok, t.failures
    assert j.ok, j.failures
    assert t.n_checked == j.n_checked == tn.num_params() == 4 * 64 + 64 + 64 * 64 + 64 + 64 * 3 + 3
    assert tn.output(x).dtype == np.float64
    # a subset is drawn as the reference draws it
    assert check_gradients(tn, DataSet(x[:4].astype(np.float64),
                                       y[:4].astype(np.float64)), subset=50).n_checked == 50


def _eval_inputs():
    rng = np.random.default_rng(11)
    labels = np.eye(4)[rng.integers(0, 4, 60)]
    preds = rng.random((60, 4))
    ts_labels = np.eye(4)[rng.integers(0, 4, (5, 6))]
    ts_preds = rng.random((5, 6, 4))
    mask = (rng.random((5, 6)) > 0.3).astype(np.float64)
    sparse = rng.integers(-1, 4, 30)
    return labels, preds, ts_labels, ts_preds, mask, sparse, rng.random((30, 4))


def test_evaluation_stats_match_reference():
    labels, preds, ts_labels, ts_preds, mask, sparse, sp_preds = _eval_inputs()
    evs = []
    for E in (Evaluation, JaxEvaluation):
        ev = E(labels_list=["a", "b", "c", "d"])
        ev.eval(labels, preds, meta=list(range(60)))
        ev.eval(ts_labels, ts_preds, mask=mask)
        ev.eval(sparse, sp_preds)
        evs.append(ev)
    t, j = evs
    np.testing.assert_array_equal(t.confusion.counts, j.confusion.counts)
    for name in ("accuracy", "precision", "recall", "f1"):
        assert getattr(t, name)() == getattr(j, name)(), name
    for c in range(4):
        assert t.precision(c) == j.precision(c)
        assert t.recall(c) == j.recall(c)
        assert t.f1(c) == j.f1(c)
        assert t.false_positive_rate(c) == j.false_positive_rate(c)
    assert t.get_meta(1, 2) == j.get_meta(1, 2)
    assert t.stats() == j.stats()
    with pytest.raises(ValueError, match="out of range"):
        Evaluation().eval(np.array([5]), np.zeros((1, 3)))


def test_listeners_match_reference(tmp_path):
    """Scores and iteration numbers seen by the listeners; the
    parameter-norm report has the reference's columns and values."""
    jn, tn = _pair()
    x, y = _iris()
    jc, tc = jlst.CollectScoresIterationListener(), tlst.CollectScoresIterationListener()
    jp = jlst.ParamAndGradientIterationListener(path=str(tmp_path / "j.tsv"))
    tp = tlst.ParamAndGradientIterationListener(path=str(tmp_path / "t.tsv"))
    perf = tlst.PerformanceListener(frequency=1)
    jn.set_listeners(jc, jp)
    tn.set_listeners(tc, tp, perf, tlst.ScoreIterationListener(2))
    for _ in range(3):
        jn.fit(JaxDataSet(x, y))
        tn.fit(DataSet(x, y))
    assert [i for i, _ in tc.scores] == [i for i, _ in jc.scores] == [1, 2, 3]
    assert_close([s for _, s in tc.scores], [s for _, s in jc.scores], F32)
    jrows = [r.split("\t") for r in open(tmp_path / "j.tsv").read().splitlines()]
    trows = [r.split("\t") for r in open(tmp_path / "t.tsv").read().splitlines()]
    assert trows[0] == jrows[0] and len(trows) == len(jrows) == 4
    assert_close(np.array(trows[1:], float)[:, 2::2],
                 np.array(jrows[1:], float)[:, 2::2], F32)
    assert perf.last_iters_per_sec > 0


def test_frozen_reference_zip_loads_in_port():
    """The JAX package's frozen checkpoint fixture (a tanh MLP with Adam
    state) restores in the port with the recorded outputs."""
    net = tser.restore_multi_layer_network(os.path.join(FIXTURES, "mln_r2.zip"),
                                           device="cpu")
    exp = np.load(os.path.join(FIXTURES, "mln_r2_expected.npz"))
    np.testing.assert_allclose(net.output(exp["x"].astype(np.float32)), exp["out"],
                               rtol=1e-5, atol=1e-6)
    assert net.opt_state["updater"]["layer0"]["W"]["m"].shape == (5, 8)


@pytest.mark.parametrize("train", [True, False])
def test_synthetic_mnist_equals_reference(train):
    for n, seed in ((64, 123), (10, 7)):
        ti, tl = tmnist._synthetic_mnist(n, seed, train)
        ji, jl = jmnist._synthetic_mnist(n, seed, train)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


def test_load_mnist_fallback_and_iterator_equal_reference(tmp_path, monkeypatch,
                                                          caplog):
    empty = str(tmp_path / "none")
    monkeypatch.setattr(tmnist, "_MNIST_DIRS", [empty])
    monkeypatch.setattr(jmnist, "_MNIST_DIRS", [empty])
    with caplog.at_level(logging.WARNING):
        t = tmnist.load_mnist(train=False, num_examples=50, seed=5)
    assert "SYNTHETIC" in caplog.text
    j = jmnist.load_mnist(train=False, num_examples=50, seed=5)
    np.testing.assert_array_equal(t.features, j.features)
    np.testing.assert_array_equal(t.labels, j.labels)
    assert t.features.shape == (50, 784) and t.labels.shape == (50, 10)
    tb = list(tmnist.MnistDataSetIterator(16, 40, shuffle=True, seed=3))
    jb = list(jmnist.MnistDataSetIterator(16, 40, shuffle=True, seed=3))
    assert [b.num_examples() for b in tb] == [b.num_examples() for b in jb]
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.labels, b.labels)


def _write_idx(path, arr, code):
    header = struct.pack(">HBB", 0, code, arr.ndim) + struct.pack(
        f">{arr.ndim}I", *arr.shape)
    body = header + arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(body)


@pytest.mark.parametrize("code,dtype", [(0x08, np.uint8), (0x09, np.int8),
                                        (0x0B, np.int16), (0x0C, np.int32),
                                        (0x0D, np.float32), (0x0E, np.float64)])
@pytest.mark.parametrize("gz", [False, True])
def test_idx_reader_matches_reference(tmp_path, code, dtype, gz):
    rng = np.random.default_rng(code)
    arr = (rng.standard_normal((5, 4, 3)) * 100).astype(dtype)
    path = str(tmp_path / ("a.idx" + (".gz" if gz else "")))
    _write_idx(path, arr, code)
    got = tmnist.read_idx(path)
    np.testing.assert_array_equal(got, arr)
    assert got.dtype.isnative and got.shape == (5, 4, 3)
    np.testing.assert_array_equal(got, jmnist._read_idx(path))


def test_idx_files_load_as_the_reference(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (12, 28, 28)).astype(np.uint8)
    lbls = rng.integers(0, 10, 12).astype(np.uint8)
    _write_idx(str(tmp_path / "t10k-images-idx3-ubyte.gz"), imgs, 0x08)
    _write_idx(str(tmp_path / "t10k-labels-idx1-ubyte"), lbls, 0x08)
    monkeypatch.setattr(tmnist, "_MNIST_DIRS", [str(tmp_path)])
    monkeypatch.setattr(jmnist, "_MNIST_DIRS", [str(tmp_path)])
    t, j = tmnist.load_mnist(train=False), jmnist.load_mnist(train=False)
    np.testing.assert_array_equal(t.features, j.features)
    np.testing.assert_array_equal(t.labels, j.labels)
    np.testing.assert_array_equal(t.features[3], imgs[3].reshape(-1) / np.float32(255))
    bad = tmp_path / "bad"
    bad.write_bytes(b"\x01\x00\x08\x01" + b"\x00" * 8)
    with pytest.raises(ValueError, match="magic"):
        tmnist.read_idx(str(bad))
