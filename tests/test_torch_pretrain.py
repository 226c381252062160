"""The port's AutoEncoder, RBM and layer-wise pretraining against the
JAX package.

Torch cannot replay ``jax.random``. In jax 0.9.0
``jax.random.bernoulli(key, p)`` is ``uniform(key, shape, dtype(p)) <
p``, so the port's Bernoulli draws are ``uniform_draw(...) < p`` and the
tests hand the port, through ``uniform_draw``, the uniforms the
reference drew: in the order the reference draws them, checked by
shape. With the same draws the AE's reconstruction loss and its
gradient, and the RBM's CD-k gradient and reconstruction error (binary,
softmax, gaussian and linear visible units; k 1 and 3), match the
reference's within 1e-5 (relative to the largest magnitude); the
deterministic paths (no corruption, rectified hidden units) match
without injected draws. ``pretrain`` on a MultiLayerNetwork and on a
ComputationGraph (the reference's DBN test stack: RBM -> AE -> output,
sigmoid, SGD 0.1) gives the reference's per-layer losses within 1e-5 and
parameters within 1e-4, and ``fit`` runs it once, then trains
supervised, as the reference does.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.graph as JG
import deeplearning4j_tpu_torch.nn.graph as TG
import deeplearning4j_tpu_torch.nn.layers.feedforward as tff
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
SEED = 1
#: the dtype of the AE's keep probability, a Python float, in jax
AE_DRAW = jnp.asarray(0.5).dtype


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(got, want, tol):
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max error {err:.3g} of max |want| {scale:.3g} > {tol}"


class Draws:
    """``uniform_draw`` replaced by the reference's uniforms, in order."""

    def __init__(self):
        self.queue = collections.deque()

    def add(self, key, shape, dtype=jnp.float32):
        """The reference's ``bernoulli(key, p, shape)`` draws uniforms in
        p's dtype: f32 for the RBM's hidden probabilities, a Python
        float's (f64 where x64 is on) for the AE's keep probability."""
        self.queue.append(np.asarray(jax.random.uniform(key, shape, dtype)))

    def __call__(self, key, shape, device):
        u = self.queue.popleft()
        assert u.shape == tuple(shape), (u.shape, tuple(shape))
        return torch.tensor(u, device=device)


@pytest.fixture
def draws(monkeypatch):
    d = Draws()
    monkeypatch.setattr(tff, "uniform_draw", d)
    yield d
    assert not d.queue, f"{len(d.queue)} draws left unused"


def _text(rbm=None, ae=None, pretrain=True):
    rbm = {"n_in": 12, "n_out": 8, "loss_function": "xent", **(rbm or {})}
    ae = {"n_in": 8, "n_out": 4, "loss_function": "mse", **(ae or {})}
    return (JaxNNC.builder().seed(SEED).learning_rate(0.1).updater("sgd")
            .activation("sigmoid").list()
            .layer(JL.RBM(**rbm))
            .layer(JL.AutoEncoder(**ae))
            .layer(JL.OutputLayer(n_in=4, n_out=2, activation="softmax",
                                  loss_function="mcxent"))
            .pretrain(pretrain).build().to_json())


def _pair(text):
    jn = JaxMLN(JaxMLC.from_json(text)).init()
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(text), device="cpu")
    params_from_numpy(tn, _np(jn.params))
    return jn, tn


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.random((n, 12)) < 0.3
    x = base.astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(base.sum(1) > 3).astype(int)]
    return x, y


def _tensors(p):
    return {k: torch.tensor(np.asarray(v)) for k, v in p.items()}


# ---------------------------------------------------------- AutoEncoder

@pytest.mark.parametrize("corruption,sparsity", [(0.0, 0.0), (0.0, 0.05),
                                                 (0.3, 0.0), (0.5, 0.1)])
def test_autoencoder_loss_and_gradient(draws, corruption, sparsity):
    jn, tn = _pair(_text(ae=dict(corruption_level=corruption, sparsity=sparsity)))
    ji, ti = jn.impls[1], tn.impls[1]
    x = np.random.default_rng(1).random((10, 8)).astype(np.float32)
    key = jax.random.PRNGKey(42)
    if corruption > 0.0:
        draws.add(key, x.shape, AE_DRAW)
    jl, jg = jax.value_and_grad(lambda p: ji.pretrain_loss(p, jnp.asarray(x), key))(
        jn.params["layer1"])
    p = {k: v.requires_grad_() for k, v in _tensors(jn.params["layer1"]).items()}
    tl = ti.pretrain_loss(p, torch.tensor(x), 7)
    grads = torch.autograd.grad(tl, list(p.values()))
    _close(tl, float(jl), F32)
    for (name, _), g in zip(p.items(), grads):
        _close(g, jg[name], F32)
    _close(ti.encode(p, torch.tensor(x)), ji.encode(jn.params["layer1"], x), F32)


# ------------------------------------------------------------------ RBM

@pytest.mark.parametrize("hidden,visible,k", [
    ("binary", "binary", 1), ("binary", "binary", 3), ("binary", "softmax", 2),
    ("binary", "gaussian", 1), ("binary", "linear", 1),
    ("rectified", "binary", 1), ("rectified", "linear", 3)])
def test_rbm_cd_gradients(draws, hidden, visible, k):
    loss = "mse" if visible in ("gaussian", "linear") else "xent"
    jn, tn = _pair(_text(rbm=dict(hidden_unit=hidden, visible_unit=visible, k=k,
                                  loss_function=loss)))
    ji, ti = jn.impls[0], tn.impls[0]
    x, _ = _data(16, seed=2)
    key = jax.random.PRNGKey(9)
    if hidden == "binary":
        for kk in jax.random.split(key, k):
            draws.add(kk, (16, 8))
    jg, jerr = ji.cd_gradients(jn.params["layer0"], jnp.asarray(x), key)
    tg, terr = ti.cd_gradients(_tensors(jn.params["layer0"]), torch.tensor(x), 5)
    assert set(tg) == set(jg) == {"W", "b", "vb"}
    for name in jg:
        _close(tg[name], jg[name], F32)
    _close(terr, float(jerr), F32)
    _close(ti.pretrain_loss(_tensors(jn.params["layer0"]), torch.tensor(x), 5)
           if hidden != "binary" else terr, float(jerr), F32)


# ------------------------------------------------------------ pretrain

def _mln_draws(draws, jn, n, batch, epochs):
    """The reference's draws for ``pretrain`` of the DBN stack, in order:
    the RBM's (layer 0) Gibbs samples, then the AE's (layer 1)
    corruption, one per step."""
    steps = epochs * -(-n // batch)
    rows = [min(batch, n - s * batch) for s in range(-(-n // batch))] * epochs
    key0 = jax.random.PRNGKey(SEED + 104729 * 1)
    for it in range(steps):
        for kk in jax.random.split(jax.random.fold_in(key0, it),
                                   jn.impls[0].conf.k):
            draws.add(kk, (rows[it], 8))
    key1 = jax.random.PRNGKey(SEED + 104729 * 2)
    for it in range(steps):
        draws.add(jax.random.fold_in(key1, it), (rows[it], 8), AE_DRAW)


@pytest.mark.parametrize("epochs,batch", [(1, 16), (2, 24)])
def test_pretrain_matches_with_the_same_draws(draws, epochs, batch):
    jn, tn = _pair(_text())
    x, y = _data()
    _mln_draws(draws, jn, len(x), batch, epochs)
    seen = []
    tn.set_listeners(lambda net, it, score: seen.append((it, score)))
    jl = jn.pretrain(JaxDataSet(x, y), epochs=epochs, batch_size=batch)
    tl = tn.pretrain(DataSet(x, y), epochs=epochs, batch_size=batch)
    assert set(tl) == set(jl) == {"layer0", "layer1"}
    for name in jl:
        _close(tl[name], jl[name], F32)
    for layer, p in jn.params.items():
        for name, w in p.items():
            _close(tn.params[layer][name], w, GRAD)
    steps = epochs * -(-len(x) // batch)
    assert [s for s, _ in seen] == [steps, steps]
    assert seen[-1][1] == pytest.approx(tl["layer1"])


def test_fit_runs_pretrain_once_then_supervised(draws, monkeypatch):
    jn, tn = _pair(_text())
    x, y = _data()
    _mln_draws(draws, jn, len(x), 32, 1)  # fit's pretrain: batch 32
    jn.fit(JaxDataSet(x, y))
    tn.fit(DataSet(x, y))
    assert tn._pretrained and jn._pretrained
    calls = []
    monkeypatch.setattr(type(tn), "pretrain",
                        lambda self, *a, **k: calls.append(1))
    for _ in range(3):
        jn.fit(JaxDataSet(x, y))
        tn.fit(DataSet(x, y))
    assert not calls
    for layer, p in jn.params.items():
        for name, w in p.items():
            _close(tn.params[layer][name], w, GRAD)
    _close(tn.score(), float(jn.score()), F32)
    tn.init()
    assert not tn._pretrained


def test_autoencoder_loss_falls_over_epochs():
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(_text()),
                            device="cpu").init()
    x, y = _data()
    short = net.pretrain(DataSet(x, y), epochs=1)
    net.init()
    long = net.pretrain(DataSet(x, y), epochs=20)
    assert long["layer1"] < short["layer1"]
    assert np.isfinite(list(long.values())).all()


def _graph(ns_nnc, ns_l, ns_g, pretrain=True):
    return (ns_g.ComputationGraphConfiguration.builder(
                ns_nnc(seed=SEED, learning_rate=0.1, updater="sgd",
                       activation="sigmoid"))
            .add_inputs("in")
            .add_layer("rbm", ns_l.RBM(n_in=12, n_out=8, loss_function="xent"),
                       "in")
            .add_layer("ae", ns_l.AutoEncoder(n_in=8, n_out=4,
                                              loss_function="mse"), "rbm")
            .add_layer("out", ns_l.OutputLayer(n_in=4, n_out=2,
                                               activation="softmax",
                                               loss_function="mcxent"), "ae")
            .set_outputs("out").pretrain(pretrain).build())


def test_graph_pretrain_matches_with_the_same_draws(draws):
    import deeplearning4j_tpu_torch.nn.conf.layers as TL
    from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration

    jg = JG.ComputationGraph(_graph(JaxNNC, JL, JG)).init()
    tg = TG.ComputationGraph(_graph(NeuralNetConfiguration, TL, TG), device="cpu")
    params_from_numpy(tg, _np(jg.params))
    x, y = _data()
    # topological order: in (0), rbm (1), ae (2), out (3)
    for vi, (name, cols) in ((1, ("rbm", 8)), (2, ("ae", 8))):
        key = jax.random.PRNGKey(SEED + 104729 * (vi + 1))
        for it in range(2 * 4):  # 2 epochs of 4 minibatches of 16
            rng = jax.random.fold_in(key, it)
            if name == "rbm":
                draws.add(jax.random.split(rng, 1)[0], (16, cols))
            else:
                draws.add(rng, (16, cols), AE_DRAW)
    jl = jg.pretrain(JaxMDS([x], [y]), epochs=2, batch_size=16)
    tl = tg.pretrain(MultiDataSet([x], [y]), epochs=2, batch_size=16)
    assert set(tl) == set(jl) == {"rbm", "ae"}
    for name in jl:
        _close(tl[name], jl[name], F32)
    for layer, p in jg.params.items():
        for name, w in p.items():
            _close(tg.params[layer][name], w, GRAD)
