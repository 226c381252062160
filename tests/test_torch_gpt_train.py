"""The port's GPT training slice against the JAX package.

A small JAX ``gpt`` (vocab 64, d_model 32, 2 layers, 4 heads, max_len
64) is initialised and its parameters carried into the port's net; ids
come from a numpy seed, labels are the ids rolled by one (sparse). f32
unless named. The loss and every gradient agree within 1e-4 on both
sides of the flash dispatch (t = 16 takes the kernels' branch, run by
their plain versions on the CPU; t = 12 has no dividing block and takes
SDPA); SGD and Adam steps, the updater zoo, masks, ignore-ids, the bf16
policy and the model zip with its updater state agree as stated beside
each test. Dropout cannot replay ``jax.random``: it is compared by its
statistics.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models.zoo.transformer import gpt as jax_gpt
from deeplearning4j_tpu.nn.conf.configuration import (
    MultiLayerConfiguration as JaxMLC,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn import updater as jupd
from deeplearning4j_tpu.ops import losses as jlosses
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.models.zoo.transformer import (
    gpt,
    gpt_train_flops_per_token,
)
from deeplearning4j_tpu_torch.nn import updater as tupd
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.base import apply_dropout
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import losses as tlosses
from deeplearning4j_tpu_torch.util import model_serializer as tser
from deeplearning4j_tpu_torch.util.model_serializer import (
    opt_state_from_numpy,
    params_from_numpy,
)

SIZE = dict(vocab_size=64, d_model=32, n_layers=2, num_heads=4, max_len=64)
TOL = 1e-4


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _pair(compute_dtype="float32", seed=3, block_dropout=None, **conf):
    """A JAX net and the port's net with its parameters; ``conf``
    overrides fields of the global configuration on both sides,
    ``block_dropout`` the transformer blocks' dropout."""
    d = json.loads(jax_gpt(compute_dtype=compute_dtype, seed=seed,
                           **SIZE).conf.to_json())
    d["conf"].update(conf)
    if block_dropout is not None:
        for layer in d["layers"]:
            if layer["@type"] == "TransformerBlock":
                layer["dropout"] = block_dropout
    text = json.dumps(d)
    jn = JaxMLN(JaxMLC.from_json(text)).init()
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(text), device="cpu")
    params_from_numpy(tn, _np(jn.params))
    return jn, tn


def _data(b, t, seed=0, vocab=SIZE["vocab_size"]):
    ids = np.random.default_rng(seed).integers(0, vocab, (b, t))
    return ids.astype(np.float32), np.roll(ids, -1, axis=1).astype(np.float32)


def _both(x, y, fm=None, lm=None):
    return JaxDataSet(x, y, fm, lm), DataSet(x, y, fm, lm)


def _assert_tree_close(got, want, rtol, atol):
    for layer, p in want.items():
        for name, w in p.items():
            np.testing.assert_allclose(
                got[layer][name].detach().float().numpy(), np.asarray(w, np.float32),
                rtol=rtol, atol=atol, err_msg=f"{layer}/{name}")


@pytest.fixture(scope="module")
def nets():
    return _pair()


# ---------------------------------------------------- loss and gradients

@pytest.mark.parametrize("t", [16, 12])  # 16: flash branch; 12: SDPA
def test_loss_and_gradients_match(nets, t):
    jn, tn = nets
    jds, tds = _both(*_data(3, t))
    jg, js = jn.gradient_and_score(jds)
    tg, ts = tn.gradient_and_score(tds)
    assert abs(ts - js) <= TOL * max(1.0, abs(js))
    assert set(tg) == set(jg) and all(set(tg[k]) == set(jg[k]) for k in jg)
    _assert_tree_close(tg, jg, TOL, TOL)
    assert abs(tn.score(tds) - js) <= TOL * max(1.0, abs(js))


def test_labels_mask_and_ignore_ids_match(nets):
    jn, tn = nets
    x, y = _data(3, 16, seed=1)
    y[0, :5] = -1  # ignore-ids: zero loss, left out of the mean
    y[2, 7] = -3
    lm = np.ones((3, 16), np.float32)
    lm[1, 10:] = 0.0
    jds, tds = _both(x, y, lm=lm)
    jg, js = jn.gradient_and_score(jds)
    tg, ts = tn.gradient_and_score(tds)
    assert abs(ts - js) <= TOL * max(1.0, abs(js))
    _assert_tree_close(tg, jg, TOL, TOL)


def test_bf16_policy_close():
    """bf16 rounds at other places in the two frameworks (the embedding
    gradient is summed in bf16 in both, in another order): 3e-2."""
    jn, tn = _pair("bfloat16")
    jds, tds = _both(*_data(2, 16, seed=2))
    jg, js = jn.gradient_and_score(jds)
    tg, ts = tn.gradient_and_score(tds)
    assert abs(ts - js) <= 3e-2
    for layer, p in jg.items():
        for name, w in p.items():
            g = tg[layer][name]
            assert g.dtype == torch.float32  # gradients of the f32 params
            w = torch.tensor(np.asarray(w, np.float32))
            rel = ((g - w).norm() / w.norm().clamp_min(1e-12)).item()
            assert rel <= 3e-2, (layer, name, rel)


# ------------------------------------------------------------ fit steps

def test_sgd_three_steps_match():
    jn, tn = _pair(updater="sgd", learning_rate=0.05)
    jds, tds = _both(*_data(3, 16, seed=4))
    for _ in range(3):
        jn.fit(jds)
        tn.fit(tds)
    assert tn.opt_state["step"] == int(jn.opt_state["step"]) == 3
    _assert_tree_close(tn.params, jn.params, 1e-5, 1e-5)


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
                w = np.asarray(w)
                got = tn.opt_state["updater"][l][n][k].numpy()
                np.testing.assert_allclose(got, w, rtol=1e-4,
                                           atol=1e-4 * np.abs(w).max() + 1e-12,
                                           err_msg=f"{l}/{n}/{k}")


def test_adam_steps_scores_and_state_match(nets):
    jn, tn = _pair()
    jds, tds = _both(*_data(3, 16, seed=5))
    for _ in range(3):
        jn.fit(jds)
        tn.fit(tds)
        js, ts = jn.score(), tn.score()
        assert abs(ts - js) <= TOL * abs(js)
    _adam_close(tn, jn, tn.gc.learning_rate)


def test_unpadded_tail_matches_padded_tail():
    """fit(ds, batch_size=4) over 10 rows: the port feeds the tail of 2
    rows as it is; the JAX package's shape bucketing pads a tail to the
    full batch with zero rows and a labels mask that leaves them out
    (built here by hand: its own bucketing builds a [b] mask, which does
    not broadcast over sparse [b, t] labels). ``_masked_mean`` makes the
    two losses, and so the steps, the same."""
    jn, tn = _pair(updater="sgd", learning_rate=0.05)
    x, y = _data(10, 16, seed=6)
    for i in (0, 4):
        jn.fit(JaxDataSet(x[i:i + 4], y[i:i + 4]))
    pad = lambda a: np.concatenate([a, np.zeros_like(a[:2])])  # noqa: E731
    lm = np.zeros((4, 16), np.float32)
    lm[:2] = 1.0
    jn.fit(JaxDataSet(pad(x[8:]), pad(y[8:]), None, lm))
    tn.fit(DataSet(x, y), batch_size=4)
    assert tn.opt_state["step"] == 3
    assert abs(tn.score() - jn.score()) <= TOL
    _assert_tree_close(tn.params, jn.params, 1e-5, 1e-5)


def test_iterator_and_arrays_feed_fit():
    _, a = _pair(updater="sgd", learning_rate=0.05)
    _, b = _pair(updater="sgd", learning_rate=0.05)
    x, y = _data(6, 16, seed=7)
    it = ListDataSetIterator(DataSet(x, y), batch_size=4)
    assert [d.num_examples() for d in it] == [4, 2]
    a.fit(it)
    b.fit(x, y, batch_size=4)
    for layer, p in a.params.items():
        for name, v in p.items():
            assert torch.equal(v, b.params[layer][name])


def test_iterations_and_regularization_match():
    """conf.iterations steps per batch, and the L1/L2 penalties (every
    parameter except ones named "b") in the score."""
    jn, tn = _pair(updater="sgd", learning_rate=0.05, iterations=2,
                   l1=1e-3, l2=1e-2)
    jds, tds = _both(*_data(2, 16, seed=8))
    jg, js = jn.gradient_and_score(jds)
    tg, ts = tn.gradient_and_score(tds)
    assert abs(ts - js) <= TOL * abs(js)
    _assert_tree_close(tg, jg, TOL, TOL)
    jn.fit(jds)
    tn.fit(tds)
    assert tn.opt_state["step"] == 2
    _assert_tree_close(tn.params, jn.params, 1e-5, 1e-5)


# ------------------------------------------------------ model zip + updater

def test_jax_zip_with_adam_state_resumes_in_port(tmp_path):
    jn, _ = _pair()
    jds, tds = _both(*_data(3, 16, seed=9))
    for _ in range(2):
        jn.fit(jds)
    path = str(tmp_path / "jax.zip")
    jser.write_model(jn, path)
    tn = tser.restore_multi_layer_network(path, device="cpu")
    assert tn.opt_state["step"] == 2
    jn.fit(jds)
    tn.fit(tds)
    assert abs(tn.score() - jn.score()) <= TOL * abs(jn.score())
    _adam_close(tn, jn, tn.gc.learning_rate)


def test_port_zip_with_adam_state_restores_in_jax(tmp_path):
    _, tn = _pair()
    tn.fit(DataSet(*_data(3, 16, seed=10)))
    tn.fit(DataSet(*_data(3, 16, seed=11)))
    path = str(tmp_path / "port.zip")
    tser.write_model(tn, path)
    assert jser.verify_model_file(path) == []
    back = jser.restore_multi_layer_network(path)
    assert int(back.opt_state["step"]) == 2
    _assert_tree_close(tn.params, back.params, 0, 0)
    for l, p in back.opt_state["updater"].items():
        for n, st in p.items():
            assert set(st) == {"m", "v"}
            for k, w in st.items():
                np.testing.assert_array_equal(
                    tn.opt_state["updater"][l][n][k].numpy(), np.asarray(w))
    again = tser.restore_multi_layer_network(path, device="cpu")
    assert again.opt_state["step"] == 2
    no_upd = tser.restore_multi_layer_network(path, device="cpu",
                                              load_updater=False)
    assert no_upd.opt_state["step"] == 0


def test_opt_state_from_numpy_rejects_mismatches():
    jn, tn = _pair()
    tree = _np(jn.opt_state)
    tree["updater"]["layer1"]["Wo"]["m"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        opt_state_from_numpy(tn, tree)
    tree = _np(jn.opt_state)
    tree["updater"]["layer1"]["Wo"]["h"] = np.zeros((32, 32), np.float32)
    with pytest.raises(ValueError, match="unknown keys"):
        opt_state_from_numpy(tn, tree)


# ---------------------------------------------------------- flat params

def test_params_flat_order_matches_ravel_pytree():
    """12 layers: "layer10" sorts before "layer2", as ravel_pytree sorts."""
    size = dict(vocab_size=16, d_model=8, n_layers=10, num_heads=2, max_len=8)
    jn = jax_gpt(compute_dtype="float32", **size).init()
    tn = gpt(compute_dtype="float32", device="cpu", **size)
    params_from_numpy(tn, _np(jn.params))
    np.testing.assert_array_equal(tn.params_flat(), np.asarray(jn.params_flat()))
    assert tn.num_params() == jn.num_params()
    vec = np.arange(tn.num_params(), dtype=np.float32) / 1e4
    tn.set_params_flat(vec)
    jn.set_params_flat(vec)
    _assert_tree_close(tn.params, jn.params, 0, 0)
    with pytest.raises(ValueError, match="flat vector"):
        tn.set_params_flat(vec[:-1])


# ------------------------------------------------------ updaters + losses

@pytest.mark.parametrize("norm", [m.value for m in tupd.GradientNormalization])
@pytest.mark.parametrize("updater", [u.value for u in tupd.Updater])
def test_updater_and_normalization_match(updater, norm):
    """Identical tensors through 3 steps of each updater after each
    gradient normalization, under the inverse lr policy: 1e-6."""
    rng = np.random.default_rng(13)
    kw = dict(updater=updater, learning_rate=0.05, lr_policy="inverse",
              lr_policy_decay_rate=0.1, lr_policy_power=0.75)
    jc, tc = jupd.UpdaterConfig(**kw), tupd.UpdaterConfig(**kw)
    shapes = {"W": (4, 3), "b": (3,)}
    js = {k: jupd.init_updater_state(jc, jnp.zeros(s, jnp.float32))
          for k, s in shapes.items()}
    ts = {k: tupd.init_updater_state(tc, torch.zeros(s)) for k, s in shapes.items()}
    for it in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32) * (it + 1)
             for k, s in shapes.items()}
        jg = jupd.normalize_gradient(norm, {k: jnp.asarray(v) for k, v in g.items()}, 0.5)
        tg = tupd.normalize_gradient(norm, {k: torch.tensor(v) for k, v in g.items()}, 0.5)
        for k in shapes:
            ju, js[k] = jupd.apply_updater(jc, jg[k], js[k], jnp.asarray(it, jnp.int32))
            tu, ts[k] = tupd.apply_updater(tc, tg[k], ts[k], it)
            np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6, atol=1e-6)
            for name in js[k]:
                np.testing.assert_allclose(ts[k][name].numpy(), np.asarray(js[k][name]),
                                           rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("policy", [p.value for p in tupd.LearningRatePolicy])
def test_learning_rate_policies_match(policy):
    kw = dict(learning_rate=0.1, lr_policy=policy, lr_policy_decay_rate=0.9,
              lr_policy_power=0.5, lr_policy_steps=3.0, max_iterations=20,
              lr_schedule={0: 0.1, 4: 0.05, 9: 0.01})
    jc, tc = jupd.UpdaterConfig(**kw), tupd.UpdaterConfig(**kw)
    for it in (0, 1, 4, 7, 12):
        want = jupd.effective_learning_rate(jc, jnp.asarray(it, jnp.int32))
        got = tupd.effective_learning_rate(tc, it)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("name", [f.value for f in tlosses.LossFunction])
def test_every_loss_matches(name):
    rng = np.random.default_rng(14)
    labels = rng.uniform(0.05, 0.95, (5, 6)).astype(np.float32)
    preds = rng.uniform(0.05, 0.95, (5, 6)).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0], np.float32)
    for m in (None, mask):
        for reduction in ("mean", "batch"):
            want = jlosses.compute_loss(
                name, jnp.asarray(labels), jnp.asarray(preds),
                mask=None if m is None else jnp.asarray(m), reduction=reduction)
            got = tlosses.compute_loss(
                name, torch.tensor(labels), torch.tensor(preds),
                mask=None if m is None else torch.tensor(m), reduction=reduction)
            np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("name", ["mcxent", "negativeloglikelihood", "xent"])
def test_from_logits_losses_match(name):
    rng = np.random.default_rng(15)
    z = rng.standard_normal((3, 4, 7)).astype(np.float32) * 3
    labels = (rng.uniform(size=(3, 4, 7)) > 0.5).astype(np.float32)
    mask = np.ones((3, 4), np.float32)
    mask[1, 2:] = 0
    want = jlosses.compute_loss(name, jnp.asarray(labels), jnp.asarray(z),
                                mask=jnp.asarray(mask), from_logits=True)
    got = tlosses.compute_loss(name, torch.tensor(labels), torch.tensor(z),
                               mask=torch.tensor(mask), from_logits=True)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("from_logits", [True, False])
def test_sparse_labels_match_and_reject_other_losses(from_logits):
    rng = np.random.default_rng(16)
    z = rng.standard_normal((2, 5, 9)).astype(np.float32)
    if not from_logits:
        z = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    ids = rng.integers(-1, 9, (2, 5)).astype(np.float32)
    want = jlosses.compute_loss("mcxent", jnp.asarray(ids), jnp.asarray(z),
                                from_logits=from_logits)
    got = tlosses.compute_loss("mcxent", torch.tensor(ids), torch.tensor(z),
                               from_logits=from_logits)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    with pytest.raises(ValueError, match="sparse"):
        tlosses.compute_loss("mse", torch.tensor(ids), torch.tensor(z))


def test_masked_mean_value_and_gradient():
    """The value is total * (1/count); the gradient that of total/count."""
    per = torch.tensor([1.0, 2.0, 4.0, 8.0], requires_grad=True)
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0])
    out = tlosses._masked_mean(per, mask)
    assert out.item() == (torch.tensor(7.0) * (1.0 / torch.tensor(3.0))).item()
    out.backward()
    np.testing.assert_array_equal(per.grad.numpy(),
                                  (mask / 3.0).numpy())


# --------------------------------------------------------------- dropout

def test_dropout_keeps_the_share_and_scales():
    """Torch cannot replay jax.random: compare statistics. Kept share
    1 - p within 5 standard deviations; survivors scaled by 1/(1-p)."""
    p, n = 0.3, 200_000
    x = torch.ones(n)
    y = apply_dropout(x, p, torch.Generator().manual_seed(0))
    kept = (y != 0).float().mean().item()
    assert abs(kept - (1 - p)) <= 5 * ((p * (1 - p) / n) ** 0.5)
    assert torch.allclose(y[y != 0], torch.tensor(1 / (1 - p)))
    z = apply_dropout(x, p, torch.Generator().manual_seed(0))
    assert torch.equal(y, z)


def test_dropout_trains_deterministically_and_not_in_eval():
    _, a = _pair(block_dropout=0.2)
    _, b = _pair(block_dropout=0.2)
    assert a.impls[1].dropout_rate == 0.2
    tds = DataSet(*_data(3, 16, seed=17))
    eval_score = a.score(tds)
    assert eval_score == a.gradient_and_score(tds)[1]
    a.fit(tds)
    b.fit(tds)
    assert a.score() != eval_score  # the train step dropped units
    for layer, p in a.params.items():
        for name, v in p.items():
            assert torch.equal(v, b.params[layer][name])


def test_drop_connect_masks_the_head_weights_not_its_input():
    """With use_drop_connect, the head's dropout probability masks W
    (inverted-scaled, biases untouched) and its input is left alone."""
    _, tn = _pair(use_drop_connect=True, dropout=0.5)
    head = tn.out
    params = tn.params[head.name]
    got = head.maybe_drop_connect(params, True, 5)
    W, W0 = got["W"], params["W"]
    kept = (W != 0).float().mean().item()
    assert abs(kept - 0.5) <= 5 * (0.25 / W.numel()) ** 0.5
    assert torch.allclose(W[W != 0], 2 * W0[W != 0])
    assert got["b"] is params["b"]
    x = torch.ones(3, SIZE["d_model"])
    assert head.maybe_dropout_input(x, True, 5) is x
    assert head.maybe_drop_connect(params, False, 5) is params


def test_unported_paths_raise():
    _, tn = _pair()
    tn.conf.pretrain = True
    with pytest.raises(NotImplementedError, match="A2"):
        tn.fit(DataSet(*_data(2, 16)))
    tn.conf.pretrain = False
    # truncated BPTT is ported; on a stack without recurrent layers it
    # raises as the reference's _fit_tbptt does
    tn.conf.backprop_type = "truncated_bptt"
    x = np.zeros((2, 30, 4), np.float32)
    with pytest.raises(ValueError, match="no recurrent layers"):
        tn._fit_batch(DataSet(x, x))


def test_cpu_fit_launches_no_kernel(nets):
    _, tn = _pair()
    kernels.reset_launches()
    tn.fit(DataSet(*_data(2, 16)))
    assert sum(kernels.LAUNCHES.values()) == 0


def test_train_flops_per_token_matches_reference():
    from deeplearning4j_tpu.models.zoo.transformer import (
        gpt_train_flops_per_token as jax_flops,
    )
    assert gpt_train_flops_per_token(8192, 512, 8, 1024) == \
        jax_flops(8192, 512, 8, 1024)
