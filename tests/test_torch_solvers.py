"""The port's classic solvers (``optimize/solvers.py``) against the JAX
package's on the same float64 nets and data.

``lbfgs``, ``conjugate_gradient`` and ``line_gradient_descent`` through
``Solver`` on MLP-Iris (4-8-3, tanh, the 150 rows) and on a small
GravesLSTM (n 8 over t 6, 3 classes), both in float64 from the
reference's parameters: the final loss and every parameter match the
reference's at 1e-8 relative (to the largest magnitude), which also
shows that both took the same line-search branches. The LSTM runs
twice: with an all-ones features mask, which takes both packages'
plain float64 scan (1e-8), and without, through the fused scan (the
reference's Pallas kernel, interpreted, and the port's plain version of
its kernel), which keeps its products and cell in float32 even on
float64 inputs (reference ``ops/lstm_kernel.py:66,70``), summed in
other orders: there the oracles agree to ~1e-9 in the loss and ~1e-7 in
the gradient, L-BFGS's curvature pairs carry that to ~1.5e-6 in the
parameters after 12 iterations, and the bound is ``FUSED_REL``. The
oracle's flat order is ``ravel_pytree``'s, and its loss and gradient
equal the reference's oracle at 1e-12 on the float64 paths.
``Solver`` with SGD is ``fit``; an unknown algorithm raises; the
termination tests and the line search's fallbacks are the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize import solvers as jsolvers
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iris import load_iris_dataset
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import solvers
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

REL = 1e-8
ORACLE_REL = 1e-12
# the fused scan's float32 inside both packages (see above)
FUSED_REL, FUSED_ORACLE_REL = 1e-5, 1e-6
TOL = {"mlp": (REL, ORACLE_REL), "lstm_masked": (REL, ORACLE_REL),
       "lstm": (FUSED_REL, FUSED_ORACLE_REL)}
ALGOS = ["lbfgs", "conjugate_gradient", "line_gradient_descent"]


def _conf(kind, algo):
    b = (JNNC.builder().seed(7).optimization_algo(algo).iterations(12)
         .activation("tanh").learning_rate(0.1).list())
    if kind == "mlp":
        b = (b.layer(JL.DenseLayer(n_in=4, n_out=8))
             .layer(JL.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                   loss_function="mcxent")))
    else:
        b = (b.layer(JL.GravesLSTM(n_in=3, n_out=8))
             .layer(JL.RnnOutputLayer(n_in=8, n_out=3, activation="softmax",
                                      loss_function="mcxent")))
    return b.build()


def _data(kind):
    """(features, labels, features mask)."""
    if kind == "mlp":
        ds = load_iris_dataset(shuffle_seed=4)
        return ds.features, ds.labels, None
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 3, (5, 7))
    eye = np.eye(3)
    mask = np.ones((5, 6)) if kind == "lstm_masked" else None
    return eye[ids[:, :6]], eye[ids[:, 1:]], mask


def _pair(kind, algo):
    jn = JMLN(_conf(kind, algo)).init(dtype=jnp.float64)
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(jn.conf.to_json()),
                           device="cpu").init(torch.float64)
    params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
    return jn, tn


def _close(got, want, tol, err=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    rel = float(np.abs(got - want).max()) / scale
    assert rel <= tol, f"{err}: max error {rel:.3g} of max |want| {scale:.3g} > {tol}"


@pytest.mark.parametrize("kind", list(TOL))
@pytest.mark.parametrize("algo", ALGOS)
def test_solver_matches_the_reference(kind, algo):
    jn, tn = _pair(kind, algo)
    x, y, m = _data(kind)
    s0 = tn.score(DataSet(x, y, m))
    want = jsolvers.Solver(jn).optimize(JDataSet(x, y, m), iterations=12)
    got = solvers.Solver(tn).optimize(DataSet(x, y, m), iterations=12)
    _close(got, want, TOL[kind][0], "final loss")
    assert got < s0 and tn.score() == got
    _close(tn.params_flat(), np.asarray(jax.flatten_util.ravel_pytree(
        jn.params)[0]), TOL[kind][0], "parameters")
    assert all(t.dtype == torch.float64 for p in tn.params.values()
               for t in p.values())


@pytest.mark.parametrize("kind", list(TOL))
def test_oracle_is_the_references(kind):
    jn, tn = _pair(kind, "lbfgs")
    x, y, m = _data(kind)
    jo = jsolvers._FlatOracle(jn, JDataSet(x, y, m))
    to = solvers._FlatOracle(tn, DataSet(x, y, m))
    assert to.flat0.dtype == np.float64
    np.testing.assert_array_equal(to.flat0, np.asarray(jo.flat0))
    v = to.flat0 + 0.01 * np.random.default_rng(0).standard_normal(to.flat0.shape)
    f, g = to.value_and_grad(v)
    jf, jg = jo.value_and_grad(jnp.asarray(v))
    _close(f, float(jf), TOL[kind][1], "loss")
    _close(g, np.asarray(jg), TOL[kind][1], "gradient")
    assert to.loss(v) == f
    to.set_back(tn, v)
    np.testing.assert_array_equal(tn.params_flat(), v)


def test_sgd_is_fit_and_unknown_algorithms_raise():
    jn, tn = _pair("mlp", "stochastic_gradient_descent")
    x, y, _ = _data("mlp")
    other = MultiLayerNetwork(tn.conf, device="cpu").init(torch.float64)
    params_from_numpy(other, {l: {n: t.numpy() for n, t in p.items()}
                              for l, p in tn.params.items()})
    f = solvers.Solver(tn).optimize(DataSet(x, y))
    other.fit(DataSet(x, y))
    assert f == other.score()
    np.testing.assert_array_equal(tn.params_flat(), other.params_flat())
    tn.gc.optimization_algo = "newton"
    with pytest.raises(ValueError, match="unknown optimization algorithm"):
        solvers.Solver(tn).optimize(DataSet(x, y))


def test_terminations_and_line_search_are_the_references():
    t, j = solvers.TerminationConditions(), jsolvers.TerminationConditions()
    for cost, old, d in ((1.0, 1.0 + 1e-7, np.ones(3)), (1.0, 2.0, np.ones(3)),
                         (0.0, 0.0, np.ones(2)), (1.0, 2.0, np.zeros(2)),
                         (1.0, 2.0, np.full(2, 1e-9))):
        assert t.terminate(cost, old, d) == j.terminate(cost, old, d)
        assert t.eps_terminate(cost, old) == j.eps_terminate(cost, old)
    quad = lambda v: float(np.sum((v - 1.0) ** 2))  # noqa: E731
    x = np.zeros(3)
    g = 2 * (x - 1.0)
    for d in (-g, 3 * g):  # a descent direction, and one that is not
        got = solvers.BackTrackLineSearch().optimize(quad, x, d, quad(x), g)
        want = jsolvers.BackTrackLineSearch().optimize(quad, x, d, quad(x), g)
        assert got[:2] == want[:2]
        np.testing.assert_array_equal(got[2], want[2])
    nan = lambda v: float("nan")  # noqa: E731
    step, f, _ = solvers.BackTrackLineSearch().optimize(nan, x, -g, 3.0, g)
    assert (step, f) == (0.0, 3.0)
