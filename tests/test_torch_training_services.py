"""The port's training services against the JAX package's on the same
seed-made inputs and carried parameters.

- Iterators: ``ListDataSetIterator``'s protocol and orders equal the
  reference's batch for batch (with a ``CombinedPreProcessor``); an
  ``export_dataset`` directory written by either package reads in the
  other's ``ExportedDataSetIterator`` with the same batches, and the
  cursor (``state()``) is the reference's and round-trips.
- Deferred scores: listener scores of ``fit`` equal the reference's at
  1e-6 relative, iteration for iteration, on both containers' paths;
  the sink fetches only when a listener's frequency, the ring's capacity
  or the end of ``fit`` asks (counted).
- ``TrainingStats``: aggregation, ``merge``, JSON and the Chrome trace
  equal the reference's on an injected list of durations.
- ``TrainingSupervisor``: a fault-free supervised run is bit for bit the
  unsupervised one; a poisoned batch rolls back to the snapshot exactly
  and the next step runs at the halved rate (the updater specs rebuilt),
  equal to the reference's supervised run at 1e-5; ``TrainingDiverged``
  after ``max_rollbacks`` with the reference's report; ``state``/
  ``restore``.
- ``ResumableTrainer``: a preempted and resumed run equals the
  uninterrupted one bit for bit; the ``.old`` unit, the sweep of stale
  temporary units and the refusal of an iterator without ``restore``;
  a unit written by the port resumes in the JAX package and the
  reverse, ending within 1e-5 of the uninterrupted run.
- Early stopping: the conditions, both savers and the trainer's result
  against the reference's trainer (scores at 1e-5).
- ``ROC`` and ``RegressionEvaluation``: equal to the reference's on
  random arrays (the same numpy code: exactly).

Nets are small f32 MLPs with plain SGD (so parameters compare at 1e-5
relative to their largest magnitude) and data come from numpy seeds.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import export as jexport
from deeplearning4j_tpu.datasets import iterators as jiters
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.earlystopping import earlystopping as jes
from deeplearning4j_tpu.eval.regression import RegressionEvaluation as JReg
from deeplearning4j_tpu.eval.roc import ROC as JROC
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize import listeners as jlisteners
from deeplearning4j_tpu.optimize.resumable import ResumableTrainer as JResumable
from deeplearning4j_tpu.optimize.supervisor import TrainingSupervisor as JSupervisor
from deeplearning4j_tpu.optimize.training_stats import TrainingStats as JStats
from deeplearning4j_tpu_torch.datasets import export as texport
from deeplearning4j_tpu_torch.datasets import iterators as titers
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.earlystopping import earlystopping as tes
from deeplearning4j_tpu_torch.eval import ROC, RegressionEvaluation
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import (
    CollectScoresIterationListener,
    TrainingStats,
)
from deeplearning4j_tpu_torch.optimize import deferred
from deeplearning4j_tpu_torch.optimize.resumable import ResumableTrainer
from deeplearning4j_tpu_torch.optimize.supervisor import (
    TrainingDiverged,
    TrainingSupervisor,
)
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

REL = 1e-5
SCORE_REL = 1e-6
LR = 0.1


def _jconf(lr=LR, updater="sgd", seed=5):
    return (JNNC.builder().seed(seed).learning_rate(lr).updater(updater)
            .activation("tanh").list()
            .layer(JL.DenseLayer(n_in=6, n_out=12))
            .layer(JL.OutputLayer(n_in=12, n_out=3, activation="softmax",
                                  loss_function="mcxent"))
            .build())


def _pair(lr=LR, updater="sgd"):
    """(reference net, port net on the CPU) with the same parameters."""
    jn = JMLN(_jconf(lr, updater)).init()
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(jn.conf.to_json()),
                           device="cpu")
    params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
    return jn, tn


def _port_net(lr=LR, params=None):
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _jconf(lr).to_json()), device="cpu").init()
    if params is not None:
        params_from_numpy(tn, params)
    return tn


def _graph(lr=LR):
    conf = (ComputationGraphConfiguration.builder(NeuralNetConfiguration(
                seed=5, activation="tanh", learning_rate=lr, updater="sgd"))
            .add_inputs("in")
            .add_layer("dense", TL.DenseLayer(n_in=6, n_out=12), "in")
            .add_layer("out", TL.OutputLayer(n_in=12, n_out=3,
                                             activation="softmax",
                                             loss_function="mcxent"), "dense")
            .set_outputs("out").build())
    return ComputationGraph(conf, device="cpu").init()


def _data(n=24, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 6)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


def _host(tree):
    """{path: numpy array} of a nested dict of tensors or arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in _host(v).items()})
        else:
            out[k] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                      else np.asarray(v))
    return out


def _close(got, want, tol=REL, err=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (err, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    rel = float(np.abs(got - want).max()) / scale
    assert rel <= tol, f"{err}: max error {rel:.3g} of max |want| {scale:.3g} > {tol}"


def _trees_close(got, want, tol=REL):
    got, want = _host(got), _host(want)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], tol, k)


def _trees_equal(got, want):
    got, want = _host(got), _host(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------- iterators


class _Scale:
    def __init__(self, s):
        self.s = s

    def pre_process(self, ds):
        ds.features = ds.features * self.s


class _Shift:
    def pre_process(self, ds):
        return type(ds)(ds.features + 1.0, ds.labels)


def _drain(it):
    out = []
    while it.has_next():
        ds = it.next()
        out.append((np.asarray(ds.features), np.asarray(ds.labels)))
    return out


def _assert_batches(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("shuffle", [False, True])
def test_list_iterator_protocol_and_orders_are_the_references(shuffle):
    x, y = _data(22)
    t = titers.ListDataSetIterator(DataSet(x, y), 5, shuffle=shuffle, seed=3)
    j = jiters.ListDataSetIterator(JDataSet(x, y), 5, shuffle=shuffle, seed=3)
    assert (t.batch(), t.total_examples()) == (j.batch(), j.total_examples())
    _assert_batches(_drain(t), _drain(j))  # the construction's order
    t.reset()
    j.reset()
    _assert_batches(_drain(t), _drain(j))
    for _ in range(2):  # ``for`` starts from a reset
        _assert_batches([(d.features, d.labels) for d in t],
                        [(d.features, d.labels) for d in j])
    t.set_pre_processor(titers.CombinedPreProcessor(_Scale(2.0), _Shift()))
    j.set_pre_processor(jiters.CombinedPreProcessor(_Scale(2.0), _Shift()))
    _assert_batches([(d.features, d.labels) for d in t],
                    [(d.features, d.labels) for d in j])
    assert isinstance(t, titers.DataSetIterator)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_export_reads_in_the_other_package_and_the_cursor_round_trips(
        writer, tmp_path):
    rng = np.random.default_rng(4)
    chunks = [(rng.standard_normal((7, 6)).astype(np.float32),
               np.eye(3, dtype=np.float32)[rng.integers(0, 3, 7)])
              for _ in range(4)]
    d = str(tmp_path / "data")
    if writer == "port":
        n = texport.export_dataset((DataSet(a, b) for a, b in chunks), d, 6)
        it = lambda **kw: jexport.ExportedDataSetIterator(d, **kw)  # noqa: E731
        own = lambda **kw: texport.ExportedDataSetIterator(d, **kw)  # noqa: E731
    else:
        n = jexport.export_dataset((JDataSet(a, b) for a, b in chunks), d, 6)
        it = lambda **kw: texport.ExportedDataSetIterator(d, **kw)  # noqa: E731
        own = lambda **kw: jexport.ExportedDataSetIterator(d, **kw)  # noqa: E731
    assert n == 5  # 28 examples re-batched by 6: four of 6 and a tail of 4
    with open(os.path.join(d, "manifest.json")) as f:
        assert json.load(f) == {"format": "dl4j_tpu_dataset_export_v1",
                                "num_batches": 5, "num_examples": 28,
                                "batch_size": 6}
    other, mine = it(shuffle=True, seed=2), own(shuffle=True, seed=2)
    assert (other.batch(), other.total_examples()) == (6, 28)
    for _ in range(2):
        _assert_batches(_drain(other), _drain(mine))
        other.reset()
        mine.reset()
    # a cursor taken mid-epoch by one package restores in the other
    for _ in range(2):
        other.next()
        mine.next()
    assert other.state() == mine.state() == {
        "epoch": 2, "position": 2, "shuffle": True, "seed": 2}
    moved = own(shuffle=True, seed=2).restore(json.loads(json.dumps(other.state())))
    _assert_batches(_drain(moved), _drain(other))
    with pytest.raises(ValueError, match="mismatch"):
        it(shuffle=False).restore(mine.state())


def test_export_refuses_stale_batches_and_masked_rebatching(tmp_path):
    d = str(tmp_path / "data")
    x, y = _data(10)
    texport.export_dataset(DataSet(x, y), d, 4)
    assert len(texport.ExportedDataSetIterator(d).files) == 3
    texport.export_dataset(DataSet(x, y), d, 5)  # the earlier batches go
    assert len(texport.ExportedDataSetIterator(d).files) == 2
    np.savez(os.path.join(d, "batch_000009.npz"), features=x, labels=y)
    with pytest.raises(ValueError, match="stale or missing"):
        texport.ExportedDataSetIterator(d)
    with pytest.raises(ValueError, match="masked"):
        texport.export_dataset(DataSet(x, y, labels_mask=np.ones(10)), d, 4)
    with pytest.raises(FileNotFoundError):
        texport.ExportedDataSetIterator(str(tmp_path))


# -------------------------------------------------------- deferred scores


def test_listener_scores_match_the_references_fit():
    jn, tn = _pair()
    x, y = _data(24)
    jl = [jlisteners.CollectScoresIterationListener(1),
          jlisteners.CollectScoresIterationListener(4)]
    tl = [CollectScoresIterationListener(1), CollectScoresIterationListener(4)]
    jn.set_listeners(*jl)
    tn.set_listeners(*tl)
    for _ in range(2):
        jn.fit(jiters.ListDataSetIterator(JDataSet(x, y), 4))
        tn.fit(titers.ListDataSetIterator(DataSet(x, y), 4))
    for t, j in zip(tl, jl):
        assert [i for i, _ in t.scores] == [i for i, _ in j.scores]
        _close([s for _, s in t.scores], [s for _, s in j.scores], SCORE_REL)
    assert [i for i, _ in tl[0].scores] == list(range(1, 13))
    assert [i for i, _ in tl[1].scores] == [4, 8, 12]
    assert tn.score() == tl[0].scores[-1][1]
    _close(tn.score(), jn.score(), SCORE_REL)


@pytest.mark.parametrize("container", ["multilayer", "graph"])
@pytest.mark.parametrize("frequency,capacity,fetches", [
    (5, 64, 4),    # at 5, 10, 15, 20; the end of fit finds the ring empty
    (7, 64, 3),    # at 7, 14, and the end of fit's 6
    (None, 64, 1),  # no listener: the end of fit
    (None, 8, 3),  # no listener: the ring full at 8 and 16, then the end
])
def test_the_sink_fetches_only_when_asked(container, frequency, capacity,
                                          fetches):
    x, y = _data(40)
    batches = [DataSet(x[i:i + 2], y[i:i + 2]) for i in range(0, 40, 2)]
    every = _graph() if container == "graph" else _port_net()
    ref = CollectScoresIterationListener(1)
    every.set_listeners(ref)
    every.fit(batches)
    net = _graph() if container == "graph" else _port_net()
    sink = deferred.score_sink(net)
    sink.capacity = capacity
    listener = CollectScoresIterationListener(frequency or 1)
    if frequency:
        net.set_listeners(listener)
    net.fit(batches)
    assert (sink.flushes, sink.flush_calls) == (fetches, fetches + (frequency == 5))
    assert len(sink) == 0 and isinstance(net._score, float)
    assert every.score() == net.score()
    if frequency:
        assert listener.scores == [s for s in ref.scores if s[0] % frequency == 0]
    assert deferred.score_sink(every).flushes == 20


def test_deferred_helpers():
    net = _port_net()
    net.fit(DataSet(*_data(4)))
    assert deferred.host_step(net) == 1
    deferred.set_host_step(net, 5)
    assert net.opt_state["step"] == 5
    assert deferred.listener_sync_period(lambda *a: None) == 1
    assert deferred.listener_sync_period(CollectScoresIterationListener(3)) == 3
    from deeplearning4j_tpu_torch.optimize.listeners import ScoreIterationListener
    assert deferred.listener_sync_period(ScoreIterationListener(6)) == 6
    # a TBPTT fit pushes one score per chunk, and flushes at its end
    conf = (NeuralNetConfiguration.builder().seed(3).learning_rate(0.05)
            .updater("sgd").activation("tanh").list()
            .layer(TL.GravesLSTM(n_in=2, n_out=4))
            .layer(TL.RnnOutputLayer(n_in=4, n_out=2, activation="softmax",
                                     loss_function="mcxent"))
            .backprop_type("truncated_bptt").t_bptt_forward_length(3)
            .t_bptt_backward_length(3).build())
    rnn = MultiLayerNetwork(conf, device="cpu").init()
    seen = CollectScoresIterationListener(2)
    rnn.set_listeners(seen)
    xs = np.random.default_rng(1).random((2, 9, 2)).astype(np.float32)
    rnn.fit(DataSet(xs, xs))
    assert [i for i, _ in seen.scores] == [2]
    assert deferred.score_sink(rnn).flushes == 2  # at 2, then the end's 3


# ---------------------------------------------------------- training stats


def test_training_stats_match_the_reference(tmp_path):
    t, j = TrainingStats(max_events=7), JStats(max_events=7)
    durations = [("step", 3.5, 0.0), ("data_wait", 0.25, 3.5),
                 ("step", 2.75, 4.0), ("step", 4.125, 7.0),
                 ("average", 1.0, 11.5)]
    for phase, ms, start in durations:
        t.add(phase, ms, start_ms=start)
        j.add(phase, ms, start_ms=start)
    t2, j2 = TrainingStats(), JStats()
    for s in (t2, j2):
        s.add("step", 5.0, start_ms=1.0)
        s.add("stage", 0.5, start_ms=6.0)
    t.merge(t2, prefix="worker1/")
    j.merge(j2, prefix="worker1/")
    t.merge(t2)
    j.merge(j2)
    assert t.summary() == j.summary()
    assert t.phases() == j.phases()
    assert t.timeline() == j.timeline() and len(t.timeline()) == 7
    assert t.to_dict() == j.to_dict()
    assert t.chrome_trace() == j.chrome_trace()
    assert repr(t) == repr(j)
    for name in ("export_json", "export_chrome_trace"):
        a, b = str(tmp_path / f"t_{name}"), str(tmp_path / f"j_{name}")
        getattr(t, name)(a)
        getattr(j, name)(b)
        with open(a) as fa, open(b) as fb:
            assert json.load(fa) == json.load(fb)
    live = TrainingStats(keep_timeline=False)
    with live.time("step"):
        pass
    assert live.summary()["step"]["count"] == 1 and live.timeline() == []


# ------------------------------------------------------------- supervisor


def _batches(n=6, poison=None):
    x, y = _data(4 * n, seed=3)
    out = []
    for i in range(n):
        xb = x[4 * i:4 * i + 4].copy()
        if i == poison:
            xb[0, 0] = np.nan
        out.append((xb, y[4 * i:4 * i + 4]))
    return out


@pytest.mark.parametrize("container", ["multilayer", "graph"])
def test_fault_free_supervised_run_is_bit_for_bit(container):
    make = _graph if container == "graph" else _port_net
    plain, guarded = make(), make()
    sup = TrainingSupervisor(guarded)
    for xb, yb in _batches():
        plain.fit(DataSet(xb, yb))
        assert sup.step(DataSet(xb, yb))
        assert plain.score() == guarded.score()
    _trees_equal(guarded.params, plain.params)
    _trees_equal(guarded.opt_state["updater"], plain.opt_state["updater"])
    assert sup.report()["rollbacks"] == 0


@pytest.mark.parametrize("container", ["multilayer", "graph"])
def test_rollback_restores_the_snapshot_and_halves_the_rate(container):
    make = _graph if container == "graph" else _port_net
    net = make()
    sup = TrainingSupervisor(net, max_rollbacks=3)
    batches = _batches(poison=2)
    for xb, yb in batches[:2]:
        sup.step(DataSet(xb, yb))
    snapshot = {k: v.clone() for k, v in _flat(net).items()}
    assert not sup.step(DataSet(*batches[2]))
    assert sup.rollbacks == 1 and sup.batches_skipped == [2]
    for k, v in _flat(net).items():
        np.testing.assert_array_equal(v.numpy(), snapshot[k].numpy(), err_msg=k)
    # the next step runs at 0.5 lr: equal to a net built at 0.5 lr, from
    # the snapshot, taking the same batch
    half = make(LR * 0.5)
    params_from_numpy(half, {l: {n: t.numpy() for n, t in p.items()}
                             for l, p in net.params.items()})
    half.opt_state = net.opt_state
    sup.step(DataSet(*batches[3]))
    half.fit(DataSet(*batches[3]))
    _trees_equal(net.params, half.params)
    assert net.gc.learning_rate == LR * 0.5
    assert sup.report()["events"][0]["lr_scale"] == 0.5


def _flat(net):
    return {f"{l}/{n}": t for l, p in net.params.items() for n, t in p.items()}


def test_supervised_rollback_matches_the_reference():
    jn, tn = _pair()
    js, ts = JSupervisor(jn, max_rollbacks=3), TrainingSupervisor(tn, max_rollbacks=3)
    for xb, yb in _batches(poison=1):
        assert js.step(JDataSet(xb, yb)) == ts.step(DataSet(xb, yb))
    _trees_close(tn.params, jn.params)
    got, want = ts.report(), js.report()
    for r in (got, want):
        for e in r["events"]:
            assert np.isnan(e.pop("score"))
    assert got == want and got["batches_skipped"] == [1]


def test_training_diverged_after_max_rollbacks():
    jn, tn = _pair()
    js, ts = JSupervisor(jn, max_rollbacks=2), TrainingSupervisor(tn, max_rollbacks=2)
    bad = [b for b in _batches(n=3, poison=0)][:1] * 3
    for i, (xb, yb) in enumerate(bad):
        if i < 2:
            assert not ts.step(DataSet(xb, yb))
            assert not js.step(JDataSet(xb, yb))
            continue
        with pytest.raises(TrainingDiverged) as te:
            ts.step(DataSet(xb, yb))
        from deeplearning4j_tpu.optimize.supervisor import TrainingDiverged as JDiv
        with pytest.raises(JDiv) as je:
            js.step(JDataSet(xb, yb))
    got, want = te.value.report, je.value.report
    for r in (got, want):
        for e in r["events"]:
            assert np.isnan(e.pop("score"))
    assert got == want
    assert [e["action"] for e in got["events"]] == ["rollback", "rollback", "give_up"]
    assert json.loads(ts.to_json())["rollbacks"] == 3


def test_supervisor_state_restores_without_compounding_the_backoff():
    net = _port_net()
    sup = TrainingSupervisor(net, lr_backoff=0.25)
    for xb, yb in _batches(n=3, poison=1):
        sup.step(DataSet(xb, yb))
    state = json.loads(json.dumps(sup.state()))
    fresh = _port_net(lr=LR * 0.25)  # a checkpoint's config holds the scaled rate
    again = TrainingSupervisor(fresh, lr_backoff=0.25)
    again.restore(state)
    assert fresh.gc.learning_rate == LR * 0.25
    assert (again.rollbacks, again.steps_done, again.batches_skipped) == (1, 3, [1])
    assert fresh._specs["layer0"][2].learning_rate == LR * 0.25
    off = TrainingSupervisor(_port_net(), enabled=False)
    xb, yb = _batches(n=1, poison=0)[0]
    assert off.step(DataSet(xb, yb)) and off.rollbacks == 0
    with pytest.raises(ValueError, match="lr_backoff"):
        TrainingSupervisor(net, lr_backoff=1.0)


# -------------------------------------------------------------- resumable


def _export(tmp_path, writer=texport, seed=1, n=5):
    rng = np.random.default_rng(seed)
    ds = (JDataSet if writer is jexport else DataSet)
    x = rng.standard_normal((n * 4, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n * 4)]
    d = str(tmp_path / f"data_{writer.__name__.split('.')[0]}")
    writer.export_dataset(ds(x, y), d, 4)
    return d


def test_preempted_run_equals_uninterrupted(tmp_path):
    d = _export(tmp_path)
    params = jax.tree.map(np.asarray, JMLN(_jconf()).init().params)
    ref = ResumableTrainer(_port_net(params=params), str(tmp_path / "ref"),
                           checkpoint_every=2)
    ref.fit(texport.ExportedDataSetIterator(d, shuffle=True, seed=9), epochs=3)
    ck = str(tmp_path / "ck")
    t1 = ResumableTrainer(_port_net(params=params), ck, checkpoint_every=2)
    assert t1.fit(texport.ExportedDataSetIterator(d, shuffle=True, seed=9),
                  epochs=3, max_steps=7) == 7
    t2 = ResumableTrainer(_port_net(), ck, checkpoint_every=2)
    it2 = texport.ExportedDataSetIterator(d, shuffle=True, seed=9)
    t2.resume_or_start(it2)
    assert t2.steps_done == 7 and t2.model.device.type == "cpu"
    assert t2.fit(it2, epochs=3) == 8
    _trees_equal(t2.model.params, ref.model.params)
    _trees_equal(t2.model.opt_state["updater"], ref.model.opt_state["updater"])
    assert t2.model.opt_state["step"] == ref.model.opt_state["step"] == 15


def test_old_unit_recovery_and_stale_tmp_sweep(tmp_path):
    d = _export(tmp_path)
    ck = str(tmp_path / "ck")
    t1 = ResumableTrainer(_port_net(), ck, checkpoint_every=1)
    t1.fit(texport.ExportedDataSetIterator(d), epochs=1, max_steps=3)
    os.rename(f"{ck}/checkpoint", f"{ck}/checkpoint.old")  # between renames
    os.makedirs(f"{ck}/.ckpt_tmp_dead")
    t2 = ResumableTrainer(_port_net(), ck, checkpoint_every=1)
    assert not os.path.exists(f"{ck}/.ckpt_tmp_dead") and t2.has_checkpoint()
    t2.resume_or_start(texport.ExportedDataSetIterator(d))
    assert t2.steps_done == 3
    t2.fit(texport.ExportedDataSetIterator(d), epochs=1, max_steps=1)
    assert os.path.isdir(f"{ck}/checkpoint")
    assert not os.path.isdir(f"{ck}/checkpoint.old")
    # an unreadable newest unit falls back to the previous one
    os.rename(f"{ck}/checkpoint", f"{ck}/checkpoint.old")
    os.makedirs(f"{ck}/checkpoint")
    with open(f"{ck}/checkpoint/model.zip", "wb") as f:
        f.write(b"torn")
    with open(f"{ck}/checkpoint/cursor.json", "w") as f:
        f.write("{}")
    t3 = ResumableTrainer(_port_net(), ck)
    t3.resume_or_start(texport.ExportedDataSetIterator(d))
    assert t3.steps_done == 4
    fresh = ResumableTrainer(_port_net(), str(tmp_path / "none"))
    assert not fresh.has_checkpoint() and fresh.resume_or_start() is fresh.model


def test_non_resumable_iterator_is_refused_on_resume(tmp_path):
    d = _export(tmp_path)
    ck = str(tmp_path / "ck")
    ResumableTrainer(_port_net(), ck, checkpoint_every=1).fit(
        texport.ExportedDataSetIterator(d), epochs=1, max_steps=2)
    plain = titers.ListDataSetIterator(DataSet(*_data(8)), 4)
    with pytest.raises(ValueError, match="restore"):
        ResumableTrainer(_port_net(), ck).resume_or_start(plain)
    net = _port_net()
    with pytest.raises(ValueError, match="different model"):
        ResumableTrainer(net, ck).fit(texport.ExportedDataSetIterator(d),
                                      supervisor=TrainingSupervisor(_port_net()))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_unit_resumes_in_the_other_package(writer, tmp_path):
    """Three steps and a preemption in one package, the rest in the
    other (from its own export), against the uninterrupted run."""
    jd, td = _export(tmp_path, jexport), _export(tmp_path, texport)
    jn = JMLN(_jconf()).init()
    params = jax.tree.map(np.asarray, jn.params)
    want = JResumable(JMLN(_jconf()).init(), str(tmp_path / "ref"), 2)
    want.fit(jexport.ExportedDataSetIterator(jd, shuffle=True, seed=9), epochs=2)
    ck = str(tmp_path / "ck")
    if writer == "port":
        ResumableTrainer(_port_net(params=params), ck, 2).fit(
            texport.ExportedDataSetIterator(td, shuffle=True, seed=9),
            epochs=2, max_steps=3)
        rest = JResumable(JMLN(_jconf()).init(), ck, 2)
        it = jexport.ExportedDataSetIterator(jd, shuffle=True, seed=9)
    else:
        JResumable(JMLN(_jconf()).init(), ck, 2).fit(
            jexport.ExportedDataSetIterator(jd, shuffle=True, seed=9),
            epochs=2, max_steps=3)
        rest = ResumableTrainer(_port_net(), ck, 2)
        it = texport.ExportedDataSetIterator(td, shuffle=True, seed=9)
    rest.resume_or_start(it)
    assert rest.steps_done == 3 and it.state()["position"] == 3
    assert rest.fit(it, epochs=2) == 7
    _trees_close(rest.model.params, want.model.params)
    _trees_close(rest.model.opt_state["updater"], want.model.opt_state["updater"])
    assert int(rest.model.opt_state["step"]) == 10


def test_supervisor_state_rides_in_the_cursor(tmp_path):
    d = _export(tmp_path)
    ck = str(tmp_path / "ck")
    net = _port_net()
    sup = TrainingSupervisor(net)
    trainer = ResumableTrainer(net, ck, checkpoint_every=1)
    trainer.fit(texport.ExportedDataSetIterator(d), epochs=1, max_steps=2,
                supervisor=sup)
    with open(f"{ck}/checkpoint/cursor.json") as f:
        cursor = json.load(f)
    assert cursor["supervisor"]["steps_done"] == 2
    assert cursor["iterator"] == {"epoch": 0, "position": 2, "shuffle": False,
                                  "seed": 0}
    again = TrainingSupervisor(_port_net())
    t2 = ResumableTrainer(_port_net(), ck)
    t2.resume_or_start(texport.ExportedDataSetIterator(d), supervisor=again)
    assert again.model is t2.model and again.steps_done == 2


# --------------------------------------------------------- early stopping


def _es_run(pkg, net, saver, x, y, xv, yv, its):
    ds_cls = JDataSet if pkg is jes else DataSet
    it_mod = jiters if pkg is jes else titers
    cfg = pkg.EarlyStoppingConfiguration(
        epoch_termination_conditions=[
            pkg.MaxEpochsTerminationCondition(6),
            pkg.ScoreImprovementEpochTerminationCondition(1, 1e-3)],
        iteration_termination_conditions=its,
        score_calculator=pkg.DataSetLossCalculator(
            it_mod.ListDataSetIterator(ds_cls(xv, yv), 5)),
        model_saver=saver, save_last_model=True)
    return pkg.EarlyStoppingTrainer(
        cfg, net, it_mod.ListDataSetIterator(ds_cls(x, y), 4)).fit()


@pytest.mark.parametrize("saver", ["memory", "file"])
def test_early_stopping_matches_the_reference(saver, tmp_path):
    jn, tn = _pair(lr=0.5)
    x, y = _data(16, seed=5)
    xv, yv = _data(10, seed=6)
    savers = {"memory": (jes.InMemoryModelSaver(), tes.InMemoryModelSaver()),
              "file": (jes.LocalFileModelSaver(str(tmp_path / "j")),
                       tes.LocalFileModelSaver(str(tmp_path / "t")))}[saver]
    want = _es_run(jes, jn, savers[0], x, y, xv, yv, [])
    got = _es_run(tes, tn, savers[1], x, y, xv, yv, [])
    for field in ("termination_reason", "termination_details", "total_epochs",
                  "best_model_epoch"):
        assert getattr(got, field) == getattr(want, field), field
    _close(got.best_model_score, want.best_model_score, SCORE_REL)
    best = got.best_model
    assert best is not tn and best.device.type == "cpu"
    held_out = DataSet(xv, yv)
    _close(best.score(held_out), got.best_model_score, SCORE_REL)
    _trees_close(best.params, want.best_model.params)
    latest = savers[1].get_latest_model()
    _trees_equal(latest.params, tn.params)
    if saver == "file":  # a saver on the directory alone restores where asked
        again = tes.LocalFileModelSaver(str(tmp_path / "t"), device="cpu")
        _trees_equal(again.get_best_model().params, best.params)


def test_iteration_conditions_and_stop_reason():
    jn, tn = _pair(lr=0.5)
    x, y = _data(16, seed=5)
    xv, yv = _data(10, seed=6)
    got = _es_run(tes, tn, tes.InMemoryModelSaver(), x, y, xv, yv,
                  [tes.MaxScoreIterationTerminationCondition(-1.0)])
    want = _es_run(jes, jn, jes.InMemoryModelSaver(), x, y, xv, yv,
                   [jes.MaxScoreIterationTerminationCondition(-1.0)])
    assert (got.termination_reason, got.termination_details, got.total_epochs) == (
        want.termination_reason, want.termination_details, want.total_epochs) == (
        "IterationTerminationCondition", "MaxScoreIterationTerminationCondition", 1)
    assert got.best_model is tn  # nothing was scored: the live model
    assert tes.MaxScoreIterationTerminationCondition(1.0).terminate(float("nan"))
    timer = tes.MaxTimeIterationTerminationCondition(-1.0)
    timer.initialize()
    assert timer.terminate(0.0)
    assert not tes.MaxTimeIterationTerminationCondition(1e6).terminate(0.0)
    cond = tes.ScoreImprovementEpochTerminationCondition(2, 0.1)
    assert [cond.terminate(e, s) for e, s in enumerate([1.0, 0.95, 0.5, 0.45, 0.44])] \
        == [False, False, False, False, True]
    assert tes.MaxEpochsTerminationCondition(3).terminate(2, 0.0)
    calc = tes.DataSetLossCalculator(
        titers.ListDataSetIterator(DataSet(xv, yv), 4), average=False)
    _close(calc.calculate_score(tn), tn.score(DataSet(xv, yv)) * 10, SCORE_REL)


# -------------------------------------------------------------- evaluation


def test_roc_is_the_references():
    rng = np.random.default_rng(8)
    t, j = ROC(threshold_steps=40), JROC(threshold_steps=40)
    for b in range(3):
        labels = rng.integers(0, 2, 50)
        preds = np.clip(0.35 * labels + 0.65 * rng.random(50), 0, 1)
        if b == 1:
            preds[[3, 7]] = np.nan
            labels = np.eye(2)[labels]
            preds = np.stack([1 - preds, preds], axis=1)
        mask = (rng.random(50) > 0.2).astype(np.float32) if b == 2 else None
        t.eval(labels, preds, mask=mask)
        j.eval(labels, preds, mask=mask)
    np.testing.assert_array_equal(t.tp, j.tp)
    np.testing.assert_array_equal(t.fp, j.fp)
    assert (t.pos, t.neg) == (j.pos, j.neg)
    assert t.get_roc_curve() == j.get_roc_curve()
    assert t.calculate_auc() == j.calculate_auc() and 0.5 < t.calculate_auc() < 1
    empty = ROC()
    assert empty.get_roc_curve()[0] == (0.0, 0.0, 0.0)


def test_regression_evaluation_is_the_references():
    rng = np.random.default_rng(9)
    t = RegressionEvaluation(column_names=["a", "b", "c"])
    j = JReg(column_names=["a", "b", "c"])
    for _ in range(2):
        lab = rng.standard_normal((20, 3))
        pred = lab + 0.3 * rng.standard_normal((20, 3))
        t.eval(lab, pred)
        j.eval(lab, pred)
    lab = rng.standard_normal((4, 5, 3))
    pred = lab + 0.1 * rng.standard_normal((4, 5, 3))
    mask = (rng.random((4, 5)) > 0.3).astype(np.float32)
    t.eval(lab, pred, mask=mask)
    j.eval(lab, pred, mask=mask)
    for c in range(3):
        for stat in ("mean_squared_error", "mean_absolute_error",
                     "root_mean_squared_error", "r_squared",
                     "pearson_correlation"):
            assert getattr(t, stat)(c) == getattr(j, stat)(c), (stat, c)
    assert t.stats() == j.stats()
    assert RegressionEvaluation(2)._n == 2
    flat = RegressionEvaluation()
    flat.eval(np.ones((3, 2)), np.ones((3, 2)))
    assert flat.r_squared(0) == 0.0 and flat.pearson_correlation(1) == 0.0


def test_graph_fit_flushes_at_the_end_of_an_epochs_loop():
    """The graph's in-memory path (``epochs`` over one staged batch)
    also ends with the flush."""
    g = _graph()
    x, y = _data(6)
    seen = CollectScoresIterationListener(10)
    g.set_listeners(seen)
    g.fit(MultiDataSet([x], [y]), epochs=3)
    assert seen.scores == [] and deferred.score_sink(g).flushes == 1
    assert isinstance(g._score, float)
