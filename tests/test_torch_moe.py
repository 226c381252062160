"""The port's routed experts against the JAX package.

``ops/moe.py``: the port computes the reference's dense one-hot
dispatch/combine einsums by index. On the same numpy-seeded logits the
routing (each token's expert and queue slot, overflow and masked tokens)
is the reference's exactly, the gate and aux loss within 1e-6, and
``moe_ffn``'s output and gradients within 2e-5 and 2e-4 in f32 (3e-2,
relative to the largest magnitude, in bf16: the gate's gradient is
rounded to bf16 at another point). ``MoELayer`` in a MultiLayerNetwork
and in a ComputationGraph, and a MoE ``gpt`` (2 layers, d 32, 4
experts), carry the reference's parameters: each block's routing equal,
loss and gradients in f32 within 2e-4 (relative to the largest
magnitude), one Adam step by ``tests/test_torch_gpt_train.py``'s rule
(``_adam_close``), ``fit_scan``'s scores within 2e-4, and greedy
``generate`` token for token. ``gpt_stack_blocks`` stacks the same
arrays.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.graph as JG
import deeplearning4j_tpu.ops.moe as jmoe
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models.zoo.transformer import gpt as jax_gpt
from deeplearning4j_tpu.models.zoo.transformer import (
    gpt_stack_blocks as jax_stack,
)
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.configuration import (
    MultiLayerConfiguration as JaxMLC,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
import deeplearning4j_tpu_torch.nn.graph as TG
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models.zoo.transformer import gpt, gpt_stack_blocks
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.moe import AUX_LOSS_KEY
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import moe as tmoe
from deeplearning4j_tpu_torch.util.model_serializer import (
    opt_state_from_numpy,
    params_from_numpy,
)

TOL, GRAD = 2e-5, 2e-4
BF16 = 3e-2
SIZE = dict(vocab_size=64, d_model=32, n_layers=2, num_heads=4, max_len=64,
            num_experts=4)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(got, want, tol):
    got = np.asarray(got.detach().float().numpy() if torch.is_tensor(got)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max error {err:.3g} of max |want| {scale:.3g} > {tol}"


def _trees_close(got, want, tol):
    assert set(got) == set(want)
    for layer, p in want.items():
        assert set(got[layer]) == set(p), layer
        for name, w in p.items():
            _close(got[layer][name], w, tol)


def _adam_close(tn, jn, lr):
    """Params, m and v after Adam steps (``tests/test_torch_gpt_train.py``'s
    rule). Adam's normalised step m / (sqrt(v) + eps) is about sign(g)
    wherever |g| >> eps, so where a gradient is at rounding-noise level
    (an expert bias that one token reached) its step can differ by up
    to lr: params are held to 2 lr per step, and 99.9 % of them to 1e-5;
    m and v, which carry no such division, to 1e-4 relative."""
    steps = tn.opt_state["step"]
    assert steps == int(jn.opt_state["step"])
    off = 0
    for layer, p in jn.params.items():
        for name, w in p.items():
            got, w = tn.params[layer][name].numpy(), np.asarray(w)
            np.testing.assert_allclose(got, w, rtol=1e-4, atol=2 * lr * steps)
            off += int((np.abs(got - w) > 1e-5).sum())
    assert off <= 1e-3 * tn.num_params()
    for layer, p in jn.opt_state["updater"].items():
        for name, st in p.items():
            for k, w in st.items():
                w = np.asarray(w)
                np.testing.assert_allclose(
                    tn.opt_state["updater"][layer][name][k].numpy(), w,
                    rtol=1e-4, atol=1e-4 * np.abs(w).max() + 1e-12,
                    err_msg=f"{layer}/{name}/{k}")


def _slots(dispatch):
    """The reference's [n, E, C] dispatch as the port's slot per token
    (expert * C + position; E * C where a token is not kept)."""
    d = np.asarray(dispatch)
    n, e, c = d.shape
    out = np.full(n, e * c, np.int64)
    for i, ei, ci in zip(*np.nonzero(d)):
        assert out[i] == e * c, "a token in two slots"
        out[i] = ei * c + ci
    return out


# ------------------------------------------------------------- routing

@pytest.mark.parametrize("n,e,capacity,masked", [
    (12, 3, 2, False), (12, 3, 12, False), (64, 4, 5, False),
    (64, 4, 9, True), (33, 8, 1, True)])
def test_routing_matches_the_reference_exactly(n, e, capacity, masked):
    rng = np.random.default_rng(n * 100 + capacity)
    logits = rng.standard_normal((n, e)).astype(np.float32)
    valid = (rng.random(n) < 0.7).astype(np.float32) if masked else None
    dispatch, combine, aux = jmoe.top1_dispatch(
        jnp.asarray(logits), capacity,
        valid=None if valid is None else jnp.asarray(valid))
    slot, gate, taux = tmoe.top1_route(
        torch.tensor(logits), capacity,
        None if valid is None else torch.tensor(valid))
    np.testing.assert_array_equal(slot.numpy(), _slots(dispatch))
    # the gate of each kept token is its combine weight
    kept = slot.numpy() < e * capacity
    comb = np.asarray(combine).sum(axis=(1, 2))
    np.testing.assert_allclose(gate.numpy()[kept], comb[kept], rtol=1e-6, atol=0)
    assert abs(float(taux) - float(aux)) <= 1e-6 * max(1.0, abs(float(aux)))
    if masked:  # masked tokens take no slot
        assert not kept[valid == 0].any()


def test_argmax_takes_the_first_maximum():
    logits = torch.zeros(4, 3)  # every expert ties: each token to expert 0
    slot, _, _ = tmoe.top1_route(logits, 2)
    assert slot.tolist() == [0, 1, 6, 6]  # capacity 2: the rest overflow


def _moe_arrays(n, d, f, e, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) * sc for s, sc in (
        ((n, d), 1.0), ((d, e), 1.0), ((e, d, f), 0.3), ((e, f), 0.1),
        ((e, f, d), 0.3), ((e, d), 0.1))]


@pytest.mark.parametrize("cf,masked", [(1.25, False), (0.5, False), (1.0, True),
                                       (4.0, False)])
def test_moe_ffn_index_form_matches_the_einsums(cf, masked):
    """Output, aux and every gradient (x, the router, the experts) of a
    weighted sum of the output plus the aux loss."""
    n, d, f, e = 48, 8, 16, 4
    arrs = _moe_arrays(n, d, f, e, seed=int(cf * 10) + masked)
    rng = np.random.default_rng(5)
    r = rng.standard_normal((n, d)).astype(np.float32)
    valid = (rng.random(n) < 0.6).astype(np.float32) if masked else None

    def jloss(*a):
        y, aux = jmoe.moe_ffn(*a, capacity_factor=cf,
                              valid=None if valid is None else jnp.asarray(valid))
        return jnp.sum(y * r) + aux, (y, aux)

    (jl, (jy, jaux)), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True)(*map(jnp.asarray, arrs))
    ts = [torch.tensor(a, requires_grad=True) for a in arrs]
    ty, taux = tmoe.moe_ffn(*ts, capacity_factor=cf,
                            valid=None if valid is None else torch.tensor(valid))
    (ty * torch.tensor(r)).sum().add(taux).backward()
    _close(ty, jy, TOL)
    assert abs(float(taux.detach()) - float(jaux)) <= 1e-6
    for t, g in zip(ts, jg):
        _close(t.grad, g, GRAD)


def test_moe_ffn_bf16_matches_the_einsums():
    """bf16 x and experts (the router in f32 on both sides): output and
    gradients at the flash tests' bf16 tolerance."""
    n, d, f, e = 64, 16, 32, 4
    arrs = _moe_arrays(n, d, f, e, seed=3)
    r = np.random.default_rng(6).standard_normal((n, d)).astype(np.float32)

    def jloss(x, Wg, W1, b1, W2, b2):
        y, aux = jmoe.moe_ffn(x, Wg, W1, b1, W2, b2)
        return jnp.sum(y.astype(jnp.float32) * r) + aux, y

    jin = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    (_, jy), jg = jax.value_and_grad(jloss, argnums=tuple(range(6)),
                                     has_aux=True)(*jin)
    ts = [torch.tensor(a).to(torch.bfloat16).requires_grad_() for a in arrs]
    ty, taux = tmoe.moe_ffn(*ts)
    ((ty.float() * torch.tensor(r)).sum() + taux).backward()
    _close(ty, np.asarray(jy, np.float32), BF16)
    for t, g in zip(ts, jg):
        _close(t.grad, np.asarray(g, np.float32), BF16)


def test_overflowed_and_masked_tokens_get_zero_output():
    n, d = 8, 6
    x = torch.ones(n, d)
    Wg = torch.zeros(d, 2)
    Wg[:, 0] = 1.0  # every token prefers expert 0
    W1, b1 = torch.full((2, d, 8), 0.1), torch.zeros(2, 8)
    W2, b2 = torch.full((2, 8, d), 0.1), torch.zeros(2, d)
    y, _ = tmoe.moe_ffn(x, Wg, W1, b1, W2, b2, capacity_factor=0.25)  # cap 1
    assert y[0].abs().max() > 0.01
    assert torch.equal(y[1:], torch.zeros(n - 1, d))
    valid = torch.tensor([0, 0, 0, 0, 0, 0, 1, 1.0])
    y, aux = tmoe.moe_ffn(x, Wg, W1, b1, W2, b2, capacity_factor=1.0,
                          valid=valid)  # cap 4: the padding must not fill it
    assert torch.equal(y[:6], torch.zeros(6, d))
    assert y[6:].abs().max() > 0.01
    p0 = float(torch.softmax(torch.tensor([1.0 * d, 0.0]), 0)[0])
    assert float(aux) == pytest.approx(2 * p0, rel=1e-5)


# ------------------------------------------------------ MoELayer in nets

def _moe_mln_json(residual):
    return (JaxNNC.builder().seed(7).learning_rate(0.05).updater("adam")
            .activation("tanh").weight_init("xavier").list()
            .layer(JL.DenseLayer(n_in=6, n_out=8))
            .layer(JL.MoELayer(n_in=8, n_out=8, num_experts=4,
                               capacity_factor=1.0, aux_loss_weight=0.05,
                               residual=residual))
            .layer(JL.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                  loss_function="mcxent"))
            .build().to_json())


def _mln_pair(text):
    jn = JaxMLN(JaxMLC.from_json(text)).init()
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(text), device="cpu")
    params_from_numpy(tn, _np(jn.params))
    return jn, tn


def _cls_data(seed=0, b=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)]
    return x, y


@pytest.mark.parametrize("residual", [False, True])
def test_moe_layer_loss_gradients_and_adam_step(residual):
    jn, tn = _mln_pair(_moe_mln_json(residual))
    x, y = _cls_data()
    jg, js = jn.gradient_and_score(JaxDataSet(x, y))
    tg, ts = tn.gradient_and_score(DataSet(x, y))
    assert abs(ts - js) <= GRAD * max(1.0, abs(js))
    _trees_close(tg, jg, GRAD)
    assert tn.score(DataSet(x, y)) == pytest.approx(js, rel=GRAD)
    jn.fit(JaxDataSet(x, y))
    tn.fit(DataSet(x, y))
    _trees_close(tn.params, jn.params, GRAD)
    assert tn.score() == pytest.approx(float(jn.score()), rel=GRAD)
    # the step's aux loss rides the state and is part of the score
    aux = float(tn.states["layer1"][AUX_LOSS_KEY])
    assert aux > 0.0
    assert aux == pytest.approx(float(jn.states["layer1"][AUX_LOSS_KEY]), rel=GRAD)


def test_moe_layer_fit_scan_scores_match():
    jn, tn = _mln_pair(_moe_mln_json(True))
    x, y = _cls_data(seed=1, b=64)
    js = np.asarray(jn.fit_scan(JaxDataSet(x, y), 16, epochs=2))
    ts = tn.fit_scan(DataSet(x, y), 16, epochs=2)
    np.testing.assert_allclose(ts, js, rtol=GRAD, atol=GRAD)
    _trees_close(tn.params, jn.params, GRAD)


def test_moe_layer_masks_its_timesteps():
    """[b, t, d] input with a features mask: masked steps take no slot,
    get zero output, and leave the aux loss (one forward of the layer on
    both sides)."""
    conf = JL.MoELayer(n_in=8, n_out=8, num_experts=4, capacity_factor=1.0,
                       residual=True)
    gc = JaxNNC(seed=3, weight_init="xavier")
    from deeplearning4j_tpu.nn.layers.base import build_layer as jbuild
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as TL
    from deeplearning4j_tpu_torch.nn.layers.base import build_layer as tbuild
    jimpl = jbuild(gc, conf, "moe")
    timpl = tbuild(NeuralNetConfiguration(seed=3, weight_init="xavier"),
                   TL.MoELayer(n_in=8, n_out=8, num_experts=4,
                               capacity_factor=1.0, residual=True), "moe")
    p = _np(jimpl.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 6, 8)).astype(np.float32)
    mask = (rng.random((4, 6)) < 0.6).astype(np.float32)
    jy, js = jimpl.forward(p, jnp.asarray(x), {}, False, mask=jnp.asarray(mask))
    ty, ts = timpl.forward({k: torch.tensor(v) for k, v in p.items()},
                           torch.tensor(x), {}, False, mask=torch.tensor(mask))
    _close(ty, jy, TOL)
    assert abs(float(ts[AUX_LOSS_KEY]) - float(js[AUX_LOSS_KEY])) <= 1e-7
    assert torch.equal(ty[torch.tensor(mask) == 0], torch.zeros(
        int((mask == 0).sum()), 8))


def _moe_graph(ns_nnc, ns_l, ns_g):
    return (ns_g.ComputationGraphConfiguration.builder(
                ns_nnc(seed=5, activation="tanh", weight_init="xavier",
                       learning_rate=0.05, updater="adam"))
            .add_inputs("in")
            .add_layer("dense", ns_l.DenseLayer(n_in=6, n_out=8), "in")
            .add_layer("moe", ns_l.MoELayer(n_in=8, n_out=8, num_experts=4,
                                            capacity_factor=1.0,
                                            aux_loss_weight=0.05,
                                            residual=True), "dense")
            .add_layer("out", ns_l.OutputLayer(n_in=8, n_out=3,
                                               activation="softmax",
                                               loss_function="mcxent"), "moe")
            .set_outputs("out").build())


def test_moe_layer_in_a_graph_adds_its_aux_loss():
    import deeplearning4j_tpu_torch.nn.conf.layers as TL
    from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration

    jg = JG.ComputationGraph(_moe_graph(JaxNNC, JL, JG)).init()
    tg = TG.ComputationGraph(_moe_graph(NeuralNetConfiguration, TL, TG),
                             device="cpu")
    params_from_numpy(tg, _np(jg.params))
    x, y = _cls_data(seed=4)
    jmds = JaxMDS([x], [y])
    inputs, labels, fm, lm = jg._tensors(jmds)
    jgr = jax.grad(lambda p: jg._score_fn(p, jg.states, inputs, labels, False,
                                          None, fm, lm)[0])(jg.params)
    js = float(jg.score(jmds))
    tgr, ts = tg.gradient_and_score(MultiDataSet([x], [y]))
    assert abs(ts - js) <= GRAD * max(1.0, abs(js))
    _trees_close(tgr, jgr, GRAD)
    jg.fit(JaxMDS([x], [y]))
    tg.fit(MultiDataSet([x], [y]))
    _trees_close(tg.params, jg.params, GRAD)
    assert float(tg.states["moe"][AUX_LOSS_KEY]) > 0.0


# ------------------------------------------------------------ MoE gpt

def _gpt_pair(seed=3, **size):
    text = jax_gpt(compute_dtype="float32", seed=seed, **{**SIZE, **size}
                   ).conf.to_json()
    return _mln_pair(text)


@pytest.fixture(scope="module")
def moe_gpt():
    return _gpt_pair()


def _gpt_data(b=3, t=16, seed=0):
    ids = np.random.default_rng(seed).integers(0, SIZE["vocab_size"], (b, t))
    return ids.astype(np.float32), np.roll(ids, -1, axis=1).astype(np.float32)


def test_moe_gpt_config_json_is_the_references():
    assert gpt(device="cpu", **SIZE).conf.to_json() == \
        jax_gpt(**SIZE).conf.to_json()


def test_moe_gpt_routes_every_block_as_the_reference(moe_gpt, monkeypatch):
    """Each block's expert choices and slots equal the reference's (the
    inference forward, traced eagerly so its dispatch is concrete),
    asserted before anything numeric."""
    jn, tn = moe_gpt
    x, _ = _gpt_data(4, 16, seed=2)
    j_routes, t_routes = [], []
    j_orig, t_orig = jmoe.top1_dispatch, tmoe.top1_route

    def j_rec(*a, **k):
        out = j_orig(*a, **k)
        j_routes.append(_slots(out[0]))
        return out

    def t_rec(*a, **k):
        out = t_orig(*a, **k)
        t_routes.append(out[0].numpy().copy())
        return out

    monkeypatch.setattr(jmoe, "top1_dispatch", j_rec)
    monkeypatch.setattr(tmoe, "top1_route", t_rec)
    with jax.disable_jit():
        jout = np.asarray(jn.output(x))
    tout = tn.output(x)
    assert len(j_routes) == len(t_routes) == SIZE["n_layers"]
    for jr, tr in zip(j_routes, t_routes):
        np.testing.assert_array_equal(tr, jr)
    _close(tout, jout, TOL * 10)


@pytest.mark.parametrize("t", [16, 12])  # 16: flash branch; 12: SDPA
def test_moe_gpt_loss_and_gradients_match(moe_gpt, t):
    jn, tn = moe_gpt
    x, y = _gpt_data(3, t)
    jg, js = jn.gradient_and_score(JaxDataSet(x, y))
    tg, ts = tn.gradient_and_score(DataSet(x, y))
    assert abs(ts - js) <= GRAD * max(1.0, abs(js))
    _trees_close(tg, jg, GRAD)
    assert abs(tn.score(DataSet(x, y)) - js) <= GRAD * max(1.0, abs(js))


def test_moe_gpt_adam_step_matches():
    jn, tn = _gpt_pair(seed=5)
    x, y = _gpt_data(3, 16, seed=1)
    opt_state_from_numpy(tn, jax.tree.map(np.asarray, jn.opt_state))
    jn.fit(JaxDataSet(x, y))
    tn.fit(DataSet(x, y))
    assert tn.score() == pytest.approx(float(jn.score()), rel=GRAD)
    _adam_close(tn, jn, tn.gc.learning_rate)


def test_moe_gpt_generate_matches_token_for_token(moe_gpt):
    jn, tn = moe_gpt
    prompt = np.random.default_rng(4).integers(0, SIZE["vocab_size"], (3, 9))
    want = np.asarray(jn.generate(prompt, 12))
    np.testing.assert_array_equal(tn.generate(prompt, 12), want)


def test_moe_gpt_serving_routes_no_drop(moe_gpt):
    """Prefill and decode route with capacity n: no token overflows, so
    a row's logits do not depend on its batch mates."""
    from deeplearning4j_tpu_torch.nn.generate import build_generator

    _, tn = moe_gpt
    g = build_generator(tn)
    ids = torch.as_tensor(np.random.default_rng(7).integers(0, 64, (4, 16)))
    full = g.prefill(tn.params, ids, torch.full((4,), 16), 20)[1]
    alone = g.prefill(tn.params, ids[:1], torch.full((1,), 16), 20)[1]
    torch.testing.assert_close(alone, full[:1], rtol=1e-5, atol=1e-5)


def test_gpt_stack_blocks_stacks_the_references_arrays(moe_gpt):
    jn, tn = moe_gpt
    want = jax_stack(jn)
    got = gpt_stack_blocks(tn)
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


def test_moe_gpt_trains_on_the_cpu():
    tn = gpt(compute_dtype="float32", seed=1, device="cpu", **SIZE).init()
    x, y = _gpt_data(4, 16, seed=3)
    tn.fit(DataSet(x, y))
    first = tn.score()
    for _ in range(8):
        tn.fit(DataSet(x, y))
    assert np.isfinite(tn.score()) and tn.score() < first


def test_moe_gpt_bf16_loss_matches():
    """The bf16 policy (experts in bf16, the router in f32): loss and
    gradients within the bf16 tolerance."""
    d = json.loads(jax_gpt(compute_dtype="bfloat16", seed=3, **SIZE).conf.to_json())
    jn, tn = _mln_pair(json.dumps(d))
    x, y = _gpt_data(3, 16)
    jg, js = jn.gradient_and_score(JaxDataSet(x, y))
    tg, ts = tn.gradient_and_score(DataSet(x, y))
    assert abs(ts - js) <= BF16 * max(1.0, abs(js))
    _trees_close(tg, jg, BF16)
