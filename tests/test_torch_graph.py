"""The port's ComputationGraph against the JAX package's.

Small graphs built by both packages' builders (or carried into the port
through the reference's JSON), with the reference's parameters carried
across and data from numpy seeds, all in f32 unless stated: the
reference's test graphs (``tests/test_graph.py``: an MLP, a two-input
merge, two outputs, a residual add, an LSTM under ``LastTimeStepVertex``
with a features mask) and one graph that uses all 12 vertices. Outputs
and scores are held to 1e-5 and gradients to 1e-4, relative to the
largest magnitude of the reference's array; one updater step (SGD or
nesterovs) to 1e-5; each vertex's forward to 1e-6. ``check_gradients_graph``
runs in f64 on both packages with the reference's defaults.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf.graph as JV
import deeplearning4j_tpu.nn.conf.layers as JL
import deeplearning4j_tpu.nn.conf.preprocessors as JP
import deeplearning4j_tpu.nn.graph as JG
import deeplearning4j_tpu_torch.nn.conf.graph as TV
import deeplearning4j_tpu_torch.nn.conf.layers as TL
import deeplearning4j_tpu_torch.nn.conf.preprocessors as TP
import deeplearning4j_tpu_torch.nn.graph as TG
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.gradientcheck import check_gradients_graph as jax_gc
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListMultiDataSetIterator
from deeplearning4j_tpu_torch.nn import generate as tgen
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.gradientcheck import check_gradients_graph
from deeplearning4j_tpu_torch.util import model_serializer as tser
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

F32, GRAD, VERTEX = 1e-5, 1e-4, 1e-6
JAX = types.SimpleNamespace(NNC=JaxNNC, L=JL, V=JV, P=JP, G=JG)
TORCH = types.SimpleNamespace(NNC=NeuralNetConfiguration, L=TL, V=TV, P=TP, G=TG)
B = 6


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max error {err:.3g} of max |want| {scale:.3g} > {tol}"


def _base(ns, **kw):
    c = ns.NNC(seed=42, activation="tanh", weight_init="xavier")
    for k, v in kw.items():
        setattr(c, k, v)
    return c


def _graph(ns, kind):
    """The graph ``kind`` built by the package ``ns``'s builder."""
    L, V = ns.L, ns.V
    if kind == "mlp":
        b = (ns.G.ComputationGraphConfiguration.builder(
                _base(ns, learning_rate=0.5, updater="nesterovs"))
             .add_inputs("in")
             .add_layer("dense", L.DenseLayer(n_in=4, n_out=16, activation="relu",
                                              weight_init="relu"), "in")
             .add_layer("out", L.OutputLayer(n_in=16, n_out=3, activation="softmax",
                                             loss_function="mcxent"), "dense")
             .set_outputs("out"))
    elif kind == "merge":
        b = (ns.G.ComputationGraphConfiguration.builder(_base(ns))
             .add_inputs("in1", "in2")
             .add_layer("d1", L.DenseLayer(n_in=3, n_out=4), "in1")
             .add_layer("d2", L.DenseLayer(n_in=2, n_out=3), "in2")
             .add_vertex("merge", V.MergeVertex(), "d1", "d2")
             .add_layer("out", L.OutputLayer(n_in=7, n_out=2, activation="softmax",
                                             loss_function="mcxent"), "merge")
             .set_outputs("out"))
    elif kind == "multi_out":
        b = (ns.G.ComputationGraphConfiguration.builder(_base(ns))
             .add_inputs("in")
             .add_layer("shared", L.DenseLayer(n_in=4, n_out=5), "in")
             .add_layer("out1", L.OutputLayer(n_in=5, n_out=2, activation="softmax",
                                              loss_function="mcxent"), "shared")
             .add_layer("out2", L.OutputLayer(n_in=5, n_out=3, activation="identity",
                                              loss_function="mse"), "shared")
             .set_outputs("out1", "out2"))
    elif kind == "residual":
        b = (ns.G.ComputationGraphConfiguration.builder(_base(ns))
             .add_inputs("in")
             .add_layer("d1", L.DenseLayer(n_in=4, n_out=4), "in")
             .add_vertex("res", V.ElementWiseVertex(op="add"), "d1", "in")
             .add_layer("out", L.OutputLayer(n_in=4, n_out=2, activation="softmax",
                                             loss_function="mcxent"), "res")
             .set_outputs("out"))
    elif kind == "lstm_last":
        b = (ns.G.ComputationGraphConfiguration.builder(_base(ns))
             .add_inputs("in")
             .add_layer("lstm", L.GravesLSTM(n_in=3, n_out=4), "in")
             .add_vertex("last", V.LastTimeStepVertex(mask_input="in"), "lstm")
             .add_layer("out", L.OutputLayer(n_in=4, n_out=2, activation="softmax",
                                             loss_function="mcxent"), "last")
             .set_outputs("out"))
    else:  # every vertex kind, on two static inputs and a sequence
        b = (ns.G.ComputationGraphConfiguration.builder(
                _base(ns, learning_rate=0.1, updater="sgd"))
             .add_inputs("a", "b", "seq")
             .add_layer("d1", L.DenseLayer(n_in=4, n_out=4), "a")
             .add_vertex("merge", V.MergeVertex(), "d1", "b")
             .add_vertex("sub", V.SubsetVertex(from_index=1, to_index=6), "merge")
             .add_vertex("scale", V.ScaleVertex(scale=2.0), "sub")
             .add_vertex("shift", V.ShiftVertex(shift=0.5), "scale")
             .add_vertex("l2n", V.L2NormalizeVertex(), "shift")
             .add_vertex("max", V.ElementWiseVertex(op="max"), "l2n", "shift")
             .add_vertex("stack", V.StackVertex(), "l2n", "max")
             .add_vertex("unstack", V.UnstackVertex(from_index=1, stack_size=2),
                         "stack")
             .add_vertex("l2", V.L2Vertex(), "unstack", "sub")
             .add_layer("lstm", L.GravesLSTM(n_in=3, n_out=5), "seq")
             .add_vertex("last", V.LastTimeStepVertex(mask_input="seq"), "lstm")
             .add_vertex("dup", V.DuplicateToTimeSeriesVertex(ref_input="seq"),
                         "last", "seq")
             .add_vertex("flat", V.PreprocessorVertex(
                 preprocessor=ns.P.CnnToFeedForwardPreProcessor()), "dup")
             .add_vertex("merge2", V.MergeVertex(), "l2", "last", "flat", "unstack")
             .add_layer("out", L.OutputLayer(n_in=1 + 5 + 4 * 5 + 6, n_out=2,
                                             activation="softmax",
                                             loss_function="mcxent"), "merge2")
             .add_layer("out2", L.OutputLayer(n_in=6, n_out=3, activation="identity",
                                              loss_function="mse"), "max")
             .set_outputs("out", "out2"))
    return b.build()


KINDS = ("mlp", "merge", "multi_out", "residual", "lstm_last", "all_vertices")


def _data(kind, n=B, seed=0):
    """(features, labels, features masks) as lists."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    hot = lambda k: np.eye(k, dtype=np.float32)[rng.integers(0, k, n)]  # noqa: E731
    if kind == "mlp":
        return [f32(n, 4)], [hot(3)], None
    if kind == "merge":
        return [f32(n, 3), f32(n, 2)], [hot(2)], None
    if kind == "multi_out":
        return [f32(n, 4)], [hot(2), f32(n, 3)], None
    if kind == "residual":
        return [f32(n, 4)], [hot(2)], None
    mask = np.ones((n, 4 if kind == "all_vertices" else 6), np.float32)
    mask[1, 2:] = 0
    if kind == "lstm_last":
        return [f32(n, 6, 3)], [hot(2)], [mask]
    return [f32(n, 4), f32(n, 4), f32(n, 4, 3)], [hot(2), f32(n, 3)], \
        [None, None, mask]


def _pair(kind, dtype=torch.float32):
    jconf = _graph(JAX, kind)
    jn = JG.ComputationGraph(jconf).init(
        dtype=jnp.float64 if dtype == torch.float64 else jnp.float32)
    tn = TG.ComputationGraph(TG.ComputationGraphConfiguration.from_json(
        jconf.to_json()), device="cpu").init(dtype)
    params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
    return jn, tn


def _mds(kind, n=B, seed=0):
    x, y, m = _data(kind, n, seed)
    return JaxMDS(x, y, features_masks=m), MultiDataSet(x, y, features_masks=m)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                               else np.asarray(v))
    return out


def _assert_trees(got, want, tol):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for k, w in want.items():
        _close(got[k], w, tol)


# ------------------------------------------------------------ configuration


@pytest.mark.parametrize("kind", KINDS)
def test_json_and_yaml_are_the_references_both_ways(kind):
    jconf, tconf = _graph(JAX, kind), _graph(TORCH, kind)
    s = jconf.to_json()
    assert tconf.to_json() == s
    assert TG.ComputationGraphConfiguration.from_json(s).to_json() == s
    assert JG.ComputationGraphConfiguration.from_json(tconf.to_json()).to_json() == s
    assert tconf.to_yaml() == jconf.to_yaml()
    assert TG.ComputationGraphConfiguration.from_yaml(jconf.to_yaml()).to_json() == s


def test_all_vertices_graph_uses_every_vertex():
    conf = _graph(TORCH, "all_vertices")
    used = {type(v.vertex).__name__ for v in conf.vertices if v.vertex is not None}
    assert used == set(TV._VERTEX_REGISTRY) and len(used) == 12
    assert set(TV._VERTEX_REGISTRY) == set(JV._VERTEX_REGISTRY)


@pytest.mark.parametrize("kind", KINDS)
def test_topological_order_is_the_references(kind):
    jconf = _graph(JAX, kind)
    tconf = TG.ComputationGraphConfiguration.from_json(jconf.to_json())
    assert TG.topological_order(tconf.vertices) == JG.topological_order(jconf.vertices)


@pytest.mark.parametrize("verts, match", [
    ([("in", "input", []), ("a", "op", ["in", "b"]), ("b", "op", ["a"])], "cycle"),
    ([("a", "op", ["ghost"])], "unknown input"),
])
def test_topological_order_errors_are_the_references(verts, match):
    msgs = []
    for G in (JG, TG):
        with pytest.raises(ValueError, match=match) as e:
            G.topological_order([G.VertexDef(*v) for v in verts])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    order = [("in", "input", []), ("c", "op", ["a", "b"]), ("a", "op", ["in"]),
             ("b", "op", ["a"])]
    assert TG.topological_order([TG.VertexDef(*v) for v in order]) == \
        ["in", "a", "b", "c"]


# ------------------------------------------------------------ vertices


def _vertex_cases():
    rng = np.random.default_rng(5)
    a, b = (rng.standard_normal((4, 6)).astype(np.float32) for _ in range(2))
    seq = rng.standard_normal((4, 5, 3)).astype(np.float32)
    mask = np.ones((4, 5), np.float32)
    mask[0, 2:] = 0
    mask[3, 1:] = 0
    return [
        ("MergeVertex", {}, [a, b], None),
        ("ElementWiseVertex", {"op": "add"}, [a, b, a], None),
        ("ElementWiseVertex", {"op": "subtract"}, [a, b], None),
        ("ElementWiseVertex", {"op": "product"}, [a, b], None),
        ("ElementWiseVertex", {"op": "max"}, [a, b], None),
        ("SubsetVertex", {"from_index": 1, "to_index": 3}, [a], None),
        ("StackVertex", {}, [a, b], None),
        ("UnstackVertex", {"from_index": 1, "stack_size": 2}, [a], None),
        ("L2NormalizeVertex", {}, [seq], None),
        ("L2Vertex", {}, [a, b], None),
        ("ScaleVertex", {"scale": -1.5}, [a], None),
        ("ShiftVertex", {"shift": 0.25}, [a], None),
        ("PreprocessorVertex", "rnn_to_ff", [seq], None),
        ("LastTimeStepVertex", {"mask_input": "in"}, [seq], None),
        ("LastTimeStepVertex", {"mask_input": "in"}, [seq], [mask]),
        ("DuplicateToTimeSeriesVertex", {"ref_input": "in"}, [a, seq], None),
    ]


@pytest.mark.parametrize("name, kw, ins, masks", _vertex_cases(),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_vertex_forward_matches_reference(name, kw, ins, masks):
    if kw == "rnn_to_ff":
        jv = JV.PreprocessorVertex(preprocessor=JP.RnnToFeedForwardPreProcessor())
        tv = TV.PreprocessorVertex(preprocessor=TP.RnnToFeedForwardPreProcessor())
    else:
        jv, tv = getattr(JV, name)(**kw), getattr(TV, name)(**kw)
    assert tv.to_dict() == jv.to_dict()
    assert TV.vertex_from_dict(jv.to_dict()) == tv
    want = jv.forward([jnp.asarray(x) for x in ins],
                      None if masks is None else [jnp.asarray(m) for m in masks])
    got = tv.forward([torch.tensor(x) for x in ins],
                     None if masks is None else [torch.tensor(m) for m in masks])
    _close(got.numpy(), np.asarray(want), VERTEX)


# ------------------------------------------------------------ the container


@pytest.mark.parametrize("kind", KINDS)
def test_outputs_score_and_gradients_match_reference(kind):
    jn, tn = _pair(kind)
    jmds, mds = _mds(kind)
    fmasks = {n: m for n, m in zip(jn.input_names, mds.features_masks or [])
              if m is not None}
    for got, want in zip(tn.outputs(*mds.features, features_masks=fmasks),
                         jn.outputs(*jmds.features, features_masks=fmasks)):
        _close(got, np.asarray(want), F32)
    _close(tn.score(mds), jn.score(jmds), F32)
    inputs, labels, fm, lm = jn._tensors(jmds)
    jgrads = jax.grad(lambda p: jn._score_fn(p, jn.states, inputs, labels, False,
                                             None, fm, lm)[0])(jn.params)
    grads, score = tn.gradient_and_score(mds)
    _close(score, jn.score(jmds), F32)
    _assert_trees(grads, jgrads, GRAD)


@pytest.mark.parametrize("kind", KINDS)
def test_one_updater_step_matches_reference(kind):
    jn, tn = _pair(kind)
    jmds, mds = _mds(kind)
    jn.fit(jmds)
    tn.fit(mds)
    _close(tn.score(), float(jn._score), F32)
    _assert_trees(tn.params, jn.params, F32)
    _assert_trees(tn.opt_state["updater"], jn.opt_state["updater"], F32)
    assert tn.opt_state["step"] == int(jn.opt_state["step"]) == 1


def test_fit_takes_datasets_iterators_and_epochs():
    """A DataSet feeds a one-input graph; ``batch_size`` and an iterator
    give the same minibatches; ``epochs`` repeats them; iterators honor
    shuffling and a pre-processor as the reference's do."""
    jn, tn = _pair("mlp")
    (x,), (y,), _ = _data("mlp", 12)
    jn.fit(JaxMDS([x], [y]), epochs=2, batch_size=5)
    tn.fit(DataSet(x, y), epochs=2, batch_size=5)
    _assert_trees(tn.params, jn.params, F32)
    assert tn.opt_state["step"] == 6
    _, tn2 = _pair("mlp")
    tn2.fit(ListMultiDataSetIterator(MultiDataSet([x], [y]), 5), epochs=2)
    _assert_trees(tn2.params, tn.params, 1e-6)

    from deeplearning4j_tpu.datasets.iterators import ListMultiDataSetIterator as JIt
    mds = MultiDataSet([x], [y])
    ti, ji = (ListMultiDataSetIterator(mds, 5, shuffle=True, seed=3),
              JIt(JaxMDS([x], [y]), 5, shuffle=True, seed=3))
    for _ in range(2):
        got = [b.features[0] for b in ti]
        want = [b.features[0] for b in ji]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    class Halve:
        def pre_process(self, m):
            m.features = [f / 2 for f in m.features]

    ti = ListMultiDataSetIterator(mds, 12)
    ti.set_pre_processor(Halve())
    assert ti.pre_processor() is not None
    np.testing.assert_array_equal(next(iter(ti)).features[0], x / 2)


def test_multidataset_slicing_and_shuffle_are_the_references():
    x, y, m = _data("all_vertices", 8)
    jm, tm = JaxMDS(x, y, features_masks=m), MultiDataSet(x, y, features_masks=m)
    for got, want in ((tm[2:5], jm[2:5]), (tm.shuffle(7), jm.shuffle(7))):
        for g, w in zip(got.features + got.labels, want.features + want.labels):
            np.testing.assert_array_equal(g, w)
        assert got.features_masks[0] is None
        np.testing.assert_array_equal(got.features_masks[2], want.features_masks[2])
    assert [b.num_examples() for b in tm.batch_by(3)] == \
        [b.num_examples() for b in jm.batch_by(3)] == [3, 3, 2]


def _seq_graph(ns, tbptt=None):
    b = (ns.G.ComputationGraphConfiguration.builder(
            _base(ns, learning_rate=0.1, updater="sgd"))
         .add_inputs("in")
         .add_layer("lstm", ns.L.GravesLSTM(n_in=4, n_out=6), "in")
         .add_layer("out", ns.L.RnnOutputLayer(n_in=6, n_out=4, activation="softmax",
                                               loss_function="mcxent"), "lstm")
         .set_outputs("out"))
    if tbptt:
        b = b.backprop_type("truncated_bptt").t_bptt_forward_length(tbptt)
    return b.build()


def _seq_data(n=4, t=7, seed=1):
    ids = np.random.default_rng(seed).integers(0, 4, (n, t))
    eye = np.eye(4, dtype=np.float32)
    return eye[ids], eye[np.roll(ids, -1, axis=1)]


def _seq_pair(tbptt=None):
    jconf = _seq_graph(JAX, tbptt)
    jn = JG.ComputationGraph(jconf).init()
    tn = TG.ComputationGraph(TG.ComputationGraphConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
    return jn, tn


def test_tbptt_fit_matches_reference():
    jn, tn = _seq_pair(tbptt=3)
    x, y = _seq_data()
    for _ in range(2):
        jn.fit(JaxMDS([x], [y]))
        tn.fit(MultiDataSet([x], [y]))
    assert tn.opt_state["step"] == int(jn.opt_state["step"]) == 6
    _close(tn.score(), float(jn._score), F32)
    _assert_trees(tn.params, jn.params, F32)
    # the stored carries come back after the chunks
    assert tn.states["lstm"] == {}
    with pytest.raises(ValueError, match="per-timestep label"):
        tn.fit(MultiDataSet([x], [y[:, 0]]))


@pytest.mark.parametrize("kind", ["merge", "all_vertices_nomask"])
def test_fit_scan_matches_reference(kind):
    base = kind.replace("_nomask", "")
    jn, tn = _pair(base)
    x, y, _ = _data(base, 12)
    jstaged = jn.stage_scan(JaxMDS(x, y), 4)
    staged = tn.stage_scan(MultiDataSet(x, y), 4)
    assert set(staged[0]) == set(jn.input_names)
    assert set(staged[1]) == set(jn.loss_outputs)
    for _ in range(2):
        want = np.asarray(jn.fit_scan(None, 4, epochs=2, staged=jstaged))
        got = tn.fit_scan(None, 4, epochs=2, staged=staged)
        _close(got, want, F32)
    assert tn.score() == float(got[-1])
    _assert_trees(tn.params, jn.params, F32)
    _assert_trees(tn.opt_state["updater"], jn.opt_state["updater"], F32)
    with pytest.raises(ValueError, match="masked"):
        tn.stage_scan(MultiDataSet(x, y, features_masks=[np.ones(12)] * len(x)), 4)


def test_fit_scan_equals_per_step_fit():
    _, a = _pair("multi_out")
    _, b = _pair("multi_out")
    x, y, _ = _data("multi_out", 12)
    scores = a.fit_scan(MultiDataSet(x, y), 4, epochs=2)
    steps = []
    for _ in range(2):
        for i in range(0, 12, 4):
            b.fit(MultiDataSet([f[i:i + 4] for f in x], [l[i:i + 4] for l in y]))
            steps.append(b.score())
    np.testing.assert_allclose(scores, steps, rtol=1e-6, atol=0)
    _assert_trees(a.params, b.params, 1e-6)


def test_rnn_time_step_matches_reference():
    """Single steps, then a burst with a static 2-D input beside it,
    then a cleared state; bursts of two lengths raise."""
    def build(ns):
        return (ns.G.ComputationGraphConfiguration.builder(_base(ns))
                .add_inputs("seq", "ctx")
                .add_layer("lstm", ns.L.GravesLSTM(n_in=4, n_out=6), "seq")
                .add_vertex("merge", ns.V.MergeVertex(), "lstm", "ctx")
                .add_layer("out", ns.L.OutputLayer(n_in=8, n_out=4,
                                                   activation="softmax",
                                                   loss_function="mcxent"), "merge")
                .set_outputs("out")
                .build())
    jconf = build(JAX)
    assert build(TORCH).to_json() == jconf.to_json()
    jn = JG.ComputationGraph(jconf).init()
    tn = TG.ComputationGraph(TG.ComputationGraphConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
    rng = np.random.default_rng(2)
    seq = rng.standard_normal((3, 5, 4)).astype(np.float32)
    ctx = rng.standard_normal((3, 2)).astype(np.float32)
    for s in range(2):
        _close(tn.rnn_time_step(seq[:, s], ctx)[0],
               np.asarray(jn.rnn_time_step(seq[:, s], ctx)[0]), F32)
    got, want = tn.rnn_time_step(seq[:, 2:], ctx), jn.rnn_time_step(seq[:, 2:], ctx)
    assert got[0].shape == (3, 3, 4)
    _close(got[0], np.asarray(want[0]), F32)
    tn.rnn_clear_previous_state()
    jn.rnn_clear_previous_state()
    _close(tn.rnn_time_step(seq, ctx)[0], np.asarray(jn.rnn_time_step(seq, ctx)[0]),
           F32)
    with pytest.raises(ValueError, match="disagree on length"):
        tn.rnn_time_step(seq, seq[:, :2, :2])


def _gpt_chain(ns, vocab=16, d=16, layers=2, max_len=32):
    b = (ns.G.ComputationGraphConfiguration.builder(
            ns.NNC(seed=0, learning_rate=3e-4, updater="adam", activation="identity",
                   weight_init="xavier"))
         .add_inputs("ids")
         .add_layer("emb", ns.L.SequenceEmbeddingLayer(n_in=vocab, n_out=d,
                                                       max_len=max_len), "ids"))
    prev = "emb"
    for i in range(layers):
        b = b.add_layer(f"blk{i}", ns.L.TransformerBlock(n_in=d, n_out=d, num_heads=2,
                                                         causal=True), prev)
        prev = f"blk{i}"
    return (b.add_layer("head", ns.L.RnnOutputLayer(n_in=d, n_out=vocab,
                                                   activation="softmax",
                                                   loss_function="mcxent"), prev)
            .set_outputs("head").build())


def _random_tree(params, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {l: {n: (scale * rng.standard_normal(np.shape(v))
                    * (np.shape(v)[0] ** -0.5 if np.ndim(v) == 2 else 0.1)
                    ).astype(np.float32) for n, v in p.items()}
            for l, p in params.items()}


def test_gpt_chain_generate_matches_reference():
    jconf = _gpt_chain(JAX)
    assert _gpt_chain(TORCH).to_json() == jconf.to_json()
    jn = JG.ComputationGraph(jconf).init()
    tree = _random_tree(jn.params, 3, scale=3.0)
    jn.params = jax.tree.map(jnp.asarray, tree)
    tn = TG.ComputationGraph(TG.ComputationGraphConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    params_from_numpy(tn, tree)
    prompts = np.random.default_rng(4).integers(0, 16, (3, 5))
    want = np.asarray(jn.generate(prompts, 9))
    got = tn.generate(prompts, 9)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tgen.generate_eager(tn, prompts, 9), got)
    assert isinstance(tgen.build_generator(tn), tgen.TransformerGenerator)
    # a graph whose outputs or vertices break the chain has no decode order
    for kind, match in (("multi_out", "single-input/single-output"),
                        ("residual", "breaks the chain")):
        with pytest.raises(ValueError, match=match):
            _pair(kind)[1].generate(prompts, 2)


def test_char_rnn_chain_generate_matches_reference():
    def build(ns):
        return (ns.G.ComputationGraphConfiguration.builder(
                    ns.NNC(seed=1, learning_rate=0.01, updater="adam",
                           activation="tanh"))
                .add_inputs("in")
                .add_layer("l0", ns.L.GravesLSTM(n_in=8, n_out=16), "in")
                .add_layer("l1", ns.L.GravesLSTM(n_in=16, n_out=16), "l0")
                .add_layer("out", ns.L.RnnOutputLayer(n_in=16, n_out=8,
                                                      activation="softmax",
                                                      loss_function="mcxent"), "l1")
                .set_outputs("out").build())
    jconf = build(JAX)
    jn = JG.ComputationGraph(jconf).init()
    tree = _random_tree(jn.params, 5, scale=3.0)
    jn.params = jax.tree.map(jnp.asarray, tree)
    tn = TG.ComputationGraph(build(TORCH), device="cpu").init()
    params_from_numpy(tn, tree)
    prompts = np.random.default_rng(6).integers(0, 8, (4, 5))
    want = np.asarray(jn.generate(prompts, 7))
    got = tn.generate(prompts, 7)
    np.testing.assert_array_equal(got, want)
    assert isinstance(tgen.build_generator(tn), tgen.RecurrentGenerator)


@pytest.mark.parametrize("kind, subset", [("merge", None), ("multi_out", None),
                                          ("residual", None), ("lstm_last", 100),
                                          ("all_vertices", 150)])
def test_check_gradients_graph_passes_in_f64_on_both(kind, subset):
    jn, tn = _pair(kind, torch.float64)
    x, y, m = _data(kind, 5)
    x64 = [f.astype(np.float64) for f in x]
    y64 = [f.astype(np.float64) for f in y]
    jres = jax_gc(jn, JaxMDS(x64, y64, features_masks=m), subset=subset)
    res = check_gradients_graph(tn, MultiDataSet(x64, y64, features_masks=m),
                                subset=subset)
    assert jres.ok and res.ok, (jres.failures[:3], res.failures[:3])
    assert res.n_checked == jres.n_checked
    assert all(t.dtype == torch.float64 for p in tn.params.values()
               for t in p.values())


def test_pretrain_and_missing_outputs_raise():
    # pretraining (ROADMAP Queue A3) is ported: a graph with no RBM or
    # AutoEncoder vertex pretrains nothing, as the reference's
    jn, tn = _pair("mlp")
    assert tn.pretrain(None) == jn.pretrain(None) == {}
    conf = _graph(TORCH, "mlp")
    conf.outputs = []
    with pytest.raises(ValueError, match="no outputs"):
        TG.ComputationGraph(conf, device="cpu")
    conf.outputs = ["dense"]
    with pytest.raises(ValueError, match="output/loss layer"):
        TG.ComputationGraph(conf, device="cpu")


def test_params_flat_is_the_references():
    jn, tn = _pair("all_vertices")
    np.testing.assert_array_equal(tn.params_flat(), np.asarray(jn.params_flat()))
    assert tn.num_params() == jn.num_params()
    vec = np.arange(tn.num_params(), dtype=np.float32) / 1000
    tn.set_params_flat(vec)
    jn.set_params_flat(vec)
    _assert_trees(tn.params, jn.params, 0)


@pytest.mark.parametrize("kind", ["merge", "all_vertices"])
def test_zip_crosses_both_ways(tmp_path, kind):
    """A reference zip (after a step: updater state and step count)
    restores in the port, and the port's zip in the JAX package, with
    the same outputs, parameters and updater state."""
    jn, tn = _pair(kind)
    jmds, mds = _mds(kind)
    jn.fit(jmds)
    jpath = str(tmp_path / "ref.zip")
    jser.write_model(jn, jpath)
    back = tser.restore_computation_graph(jpath, device="cpu")
    assert isinstance(tser.restore_model(jpath, device="cpu"), TG.ComputationGraph)
    _assert_trees(back.params, jn.params, 0)
    _assert_trees(back.opt_state["updater"], jn.opt_state["updater"], 0)
    assert back.opt_state["step"] == 1
    fmasks = {n: m for n, m in zip(jn.input_names, mds.features_masks or [])
              if m is not None}
    _close(back.outputs(*mds.features, features_masks=fmasks)[0],
           np.asarray(jn.outputs(*jmds.features, features_masks=fmasks)[0]), F32)

    tn.fit(mds)
    tpath = str(tmp_path / "port.zip")
    tser.write_model(tn, tpath)
    with open(tpath, "rb") as f:
        assert f.read(2) == b"PK"
    ref = jser.restore_computation_graph(tpath)
    _assert_trees(tn.params, ref.params, 0)
    _assert_trees(tn.opt_state["updater"], ref.opt_state["updater"], 0)
    assert int(ref.opt_state["step"]) == 1
    payload = tser.config_payload(tn)
    assert payload == jser.config_payload(jn)
    assert json.loads(json.dumps(payload))["model_type"] == "ComputationGraph"
    with pytest.raises(ValueError, match="expected MultiLayerNetwork"):
        tser.restore_multi_layer_network(tpath, device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mlp", "merge", "multi_out", "residual"])
def test_graph_fit_scan_on_card_matches_cpu(cuda_device, kind):
    """f32 on the card against the CPU: scores and parameters after 6
    fit_scan steps within 1e-4."""
    _, cpu = _pair(kind)
    card = TG.ComputationGraph(cpu.conf, device=cuda_device).init()
    params_from_numpy(card, {l: {n: v.numpy() for n, v in p.items()}
                             for l, p in cpu.params.items()})
    x, y, _ = _data(kind, 12)
    want = cpu.fit_scan(MultiDataSet(x, y), 4, epochs=2)
    got = card.fit_scan(MultiDataSet(x, y), 4, epochs=2)
    _close(got, want, 1e-4)
    _assert_trees(card.params, cpu.params, 1e-4)


@pytest.mark.cuda
def test_graph_chains_launch_their_kernels_on_card(cuda_device):
    """The char-RNN as a graph (128 units) streams and generates through
    ``lstm_fwd_only``, and a ``gpt`` chain prefills through
    ``flash_fwd``; greedy tokens equal the MultiLayerNetwork's on the
    same parameters."""
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.models.zoo.transformer import gpt
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    def char_graph():
        return (TG.ComputationGraphConfiguration.builder(
                    NeuralNetConfiguration(seed=1, activation="tanh"))
                .add_inputs("in")
                .add_layer("layer0", L.GravesLSTM(n_in=8, n_out=128), "in")
                .add_layer("layer1", L.GravesLSTM(n_in=128, n_out=128), "layer0")
                .add_layer("layer2", L.RnnOutputLayer(n_in=128, n_out=8,
                                                      activation="softmax",
                                                      loss_function="mcxent"),
                           "layer1")
                .set_outputs("layer2").build())

    g = TG.ComputationGraph(char_graph(), device=cuda_device).init()
    mln_conf = (NeuralNetConfiguration.builder().seed(1).activation("tanh").list()
                .layer(L.GravesLSTM(n_in=8, n_out=128))
                .layer(L.GravesLSTM(n_in=128, n_out=128))
                .layer(L.RnnOutputLayer(n_in=128, n_out=8, activation="softmax",
                                        loss_function="mcxent")).build())
    tree = _random_tree({k: {n: v.cpu().numpy() for n, v in p.items()}
                         for k, p in g.params.items()}, 8, scale=3.0)
    params_from_numpy(g, tree)
    m = params_from_numpy(MultiLayerNetwork(mln_conf, device=cuda_device).init(), tree)
    prompts = np.random.default_rng(9).integers(0, 8, (4, 5))
    kernels.reset_launches()
    got = g.generate(prompts, 6)
    assert kernels.LAUNCHES["lstm_fwd_only"] > 0
    np.testing.assert_array_equal(got, m.generate(prompts, 6))
    x = np.eye(8, dtype=np.float32)[prompts]
    kernels.reset_launches()
    out = g.rnn_time_step(x)[0]
    assert kernels.LAUNCHES["lstm_fwd_only"] == 2 * 5
    np.testing.assert_allclose(out, m.rnn_time_step(x), rtol=0, atol=1e-5)

    size = dict(vocab_size=16, d_model=128, n_layers=2, num_heads=2, max_len=32,
                compute_dtype="float32")
    net = gpt(device=cuda_device, **size).init()
    conf = _gpt_chain(TORCH, vocab=16, d=128, layers=2, max_len=32)
    chain = TG.ComputationGraph(conf, device=cuda_device).init()
    names = ["emb", "blk0", "blk1", "head"]
    gtree = _random_tree({n: {k: v.cpu().numpy() for k, v in net.params[f"layer{i}"].items()}
                          for i, n in enumerate(names)}, 10)
    params_from_numpy(chain, gtree)
    params_from_numpy(net, {f"layer{i}": gtree[n] for i, n in enumerate(names)})
    kernels.reset_launches()
    toks = chain.generate(prompts, 6)
    assert kernels.LAUNCHES["flash_fwd"] >= 2
    np.testing.assert_array_equal(toks, net.generate(prompts, 6))
