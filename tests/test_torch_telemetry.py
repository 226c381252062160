"""The port's telemetry wiring against the JAX package's, on the CPU.

With tracing on in both packages (a fresh registry each), the same
calls on nets with the same parameters must give the same span names
and attributes in the same order (durations and timestamps left out)
and the same counter values:

- MLP-Iris ``fit`` (one batch and an iterator), ``score``, ``predict``
  and ``evaluate``; a truncated-BPTT char-RNN ``fit``; ``fit_scan`` on
  both containers;
- the feed's padded tail, the deferred fetches, the dispatch misses and
  the staged bytes (equal where the source dtype is the compute dtype:
  the port counts the source dtype it copies, the reference the cast
  arrays);
- the supervisor's rollbacks and marks, a corrupt checkpoint's
  integrity counter and fault event, ``PerformanceListener``'s counter;
- ``generate`` on a tiny GPT and a tiny char-RNN (the decode family),
  and the paged scheduler's ``start=False`` core (``dl4j_sched_*``,
  ``dl4j_kvpool_*``, ``dl4j_attr_*``, the time series and the request
  traces) on the same requests.

The port's own fits with tracing on and off are bit for bit. The card's
cases are in ``tests/test_torch_telemetry_cuda.py``.
"""

import importlib.util
import json
import math
import os
import threading
import zipfile

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.monitor as jmon
import deeplearning4j_tpu_torch.monitor as tmon
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.models.zoo.transformer import gpt as jax_gpt
from deeplearning4j_tpu.monitor import reqtrace as jrt
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.generate import generate as jgenerate
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize.listeners import PerformanceListener as JPerf
from deeplearning4j_tpu.optimize.supervisor import TrainingDiverged as JDiverged
from deeplearning4j_tpu.optimize.supervisor import TrainingSupervisor as JSup
from deeplearning4j_tpu.serving import continuous as jcont
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.datasets.staging import stager_of
from deeplearning4j_tpu_torch.models.zoo.transformer import gpt
from deeplearning4j_tpu_torch.monitor import reqtrace as trt
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.generate import generate
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.deferred import score_sink
from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresIterationListener,
    PerformanceListener,
)
from deeplearning4j_tpu_torch.optimize.supervisor import (
    TrainingDiverged,
    TrainingSupervisor,
)
from deeplearning4j_tpu_torch.serving.continuous import ContinuousDecodeScheduler
from deeplearning4j_tpu_torch.util import model_serializer as tser
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

_SCRIPT = os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                       "check_telemetry_schema.py")
_spec = importlib.util.spec_from_file_location("check_telemetry_schema",
                                               _SCRIPT)
schema = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(schema)

SYNC, MISS = tmon.SCORE_SYNC_COUNTER, tmon.JIT_CACHE_MISS_COUNTER
PADDED, H2D = tmon.FEED_PADDED_BATCHES_COUNTER, tmon.H2D_BYTES_COUNTER


class Side:
    """One package's registry and tracer for a test."""

    def __init__(self, mon):
        self.mon = mon
        self.reg = mon.MetricsRegistry()
        self.old = mon.set_registry(self.reg)
        self.tracer = mon.enable_tracing()

    def value(self, name, **labels):
        m = self.reg.get(name, **labels)
        return None if m is None else m.value

    def spans(self, main_only=True):
        """(name, attrs) of the spans and marks, in order; by default
        those of this thread only (the feed's stages run on their own)."""
        me = threading.get_ident()
        return [(e["name"], e.get("attrs", {})) for e in self.tracer.events()
                if not main_only or e["tid"] == me]

    def close(self):
        self.mon.disable_tracing()
        self.mon.set_registry(self.old)


@pytest.fixture
def sides():
    j, t = Side(jmon), Side(tmon)
    try:
        yield j, t
    finally:
        j.close()
        t.close()


def _same_spans(j, t, main_only=True):
    got, want = t.spans(main_only), j.spans(main_only)
    assert got == want
    return got


def _counters(side, *names):
    return [side.value(n) for n in names]


# ------------------------------------------------------------------ nets

def _mlp_conf(NNC, Lm):
    return (NNC.builder().seed(3).learning_rate(0.1).updater("adam")
            .activation("relu").list()
            .layer(Lm.DenseLayer(n_in=4, n_out=16))
            .layer(Lm.OutputLayer(n_in=16, n_out=3, activation="softmax",
                                  loss_function="mcxent")).build())


def _mlp_pair():
    jn = JMLN(_mlp_conf(JNNC, JL)).init()
    tn = MultiLayerNetwork(_mlp_conf(NeuralNetConfiguration, L),
                           device="cpu").init()
    params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
    return jn, tn


def _iris_like(n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(dtype)
    y = np.eye(3, dtype=dtype)[rng.integers(0, 3, n)]
    return x, y


V, H = 8, 16


def _char_conf(tbptt=None):
    lst = (JNNC.builder().seed(3).learning_rate(0.01).updater("adam")
           .activation("tanh").list()
           .layer(JL.GravesLSTM(n_in=V, n_out=H))
           .layer(JL.RnnOutputLayer(n_in=H, n_out=V, activation="softmax",
                                    loss_function="mcxent")))
    if tbptt:
        lst = lst.backprop_type("truncated_bptt").t_bptt_forward_length(tbptt)
    return lst.build()


def _char_pair(tbptt=None):
    jc = _char_conf(tbptt)
    jn = JMLN(jc).init()
    rng = np.random.default_rng(5)
    tree = {l: {n: (rng.standard_normal(np.shape(v)) * 0.3).astype(np.float32)
                for n, v in p.items()} for l, p in jn.params.items()}
    jn.params = jax.tree.map(jax.numpy.asarray, tree)
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(jc.to_json()),
                           device="cpu")
    params_from_numpy(tn, tree)
    return jn, tn


def _char_data(b, t, seed=1):
    ids = np.random.default_rng(seed).integers(0, V, (b, t))
    eye = np.eye(V, dtype=np.float32)
    return eye[ids], eye[np.roll(ids, -1, axis=1)]


def _graph_conf(ns_nnc, ns_l, graph_cls):
    return (graph_cls.builder(ns_nnc(seed=42, activation="tanh",
                                     learning_rate=0.1, updater="sgd"))
            .add_inputs("in")
            .add_layer("dense", ns_l.DenseLayer(n_in=4, n_out=8), "in")
            .add_layer("out", ns_l.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                               loss_function="mcxent"), "dense")
            .set_outputs("out").build())


def _graph_pair():
    from deeplearning4j_tpu.nn.graph import ComputationGraphConfiguration as JCGC
    jc = _graph_conf(JNNC, JL, JCGC)
    jn = JGraph(jc).init()
    tn = ComputationGraph(ComputationGraphConfiguration.from_json(jc.to_json()),
                          device="cpu").init()
    params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
    return jn, tn


# ----------------------------------------------------- training spans

def test_mlp_fit_score_predict_evaluate_spans_are_the_references(sides):
    j, t = sides
    jn, tn = _mlp_pair()
    x, y = _iris_like(40)
    for _ in range(2):
        jn.fit(JDataSet(x, y))
        tn.fit(DataSet(x, y))
    jn.score(JDataSet(x, y))
    tn.score(DataSet(x, y))
    jn.predict(x)
    tn.predict(x)
    jn.evaluate(JDataSet(x, y), batch_size=16)
    tn.evaluate(DataSet(x, y), batch_size=16)
    got = _same_spans(j, t)
    assert [n for n, _ in got] == [
        "data_load", "compile", "score_sync", "data_load", "device_step",
        "score_sync", "eval", "inference", "eval", "eval", "eval"]
    assert [a for n, a in got if n == "eval"][1:] == [
        {"path": "evaluate", "compile": True, "rows": 16},
        {"path": "evaluate", "compile": False, "rows": 16},
        {"path": "evaluate", "compile": False, "rows": 8}]
    assert _counters(t, SYNC, MISS) == _counters(j, SYNC, MISS) == [2, 2]


def test_tbptt_char_rnn_fit_spans_are_the_references(sides):
    j, t = sides
    jn, tn = _char_pair(tbptt=3)
    x, y = _char_data(4, 7)
    jn.fit(JDataSet(x, y))
    tn.fit(DataSet(x, y))
    got = _same_spans(j, t)
    # chunks of 3, 3 and 1 steps: the last is a new signature
    assert [n for n, _ in got] == ["data_load", "compile", "data_load",
                                   "device_step", "data_load", "compile",
                                   "score_sync"]
    assert got[-1][1] == {"count": 3}
    assert _counters(t, SYNC, MISS) == _counters(j, SYNC, MISS) == [1, 2]


@pytest.mark.parametrize("container", ["multilayer", "graph"])
def test_fit_scan_spans_are_the_references(sides, container):
    j, t = sides
    jn, tn = _graph_pair() if container == "graph" else _mlp_pair()
    x, y = _iris_like(20)
    jst = jn.stage_scan(JDataSet(x, y), 8)
    tst = tn.stage_scan(DataSet(x, y), 8)
    for epochs in (2, 2, 1):
        jn.fit_scan(None, 8, epochs=epochs, staged=jst)
        tn.fit_scan(None, 8, epochs=epochs, staged=tst)
    got = _same_spans(j, t)
    path = "graph_fit_scan" if container == "graph" else "fit_scan"
    assert got == [("data_load", {"path": "stage_scan", "examples": 16}),
                   ("compile", {"path": path, "epochs": 2}),
                   ("device_step", {"path": path, "epochs": 2}),
                   ("compile", {"path": path, "epochs": 1})]


def test_graph_fit_spans_are_the_references(sides):
    from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMDS
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet

    j, t = sides
    jn, tn = _graph_pair()
    x, y = _iris_like(12)
    jn.fit(JMDS([x], [y]), epochs=2)
    tn.fit(MultiDataSet([x], [y]), epochs=2)
    got = _same_spans(j, t)
    assert [n for n, _ in got] == ["data_load", "compile", "data_load",
                                   "device_step", "score_sync"]
    assert got[0][1] == {"path": "graph_fit"}


# ------------------------------------------------ the feed's counters

@pytest.mark.parametrize("source", [np.float32, np.uint8])
def test_feed_counters_are_the_references(sides, source):
    """10 rows in batches of 4: a padded tail (a new signature: its
    labels mask), a listener every 2 steps, the staged bytes."""
    j, t = sides
    jn, tn = _mlp_pair()
    x, y = _iris_like(10, seed=4)
    # the features in ``source``; the reference's bucketing reads integer
    # labels as ids, so the labels stay f32
    xs, ys = (np.abs(x) * 10).astype(source), y
    jl, tl = JPerf(frequency=2), CollectScoresIterationListener(frequency=2)
    jn.set_listeners(jl)
    tn.set_listeners(tl)
    jn.fit(JList(JDataSet(xs, ys), 4))
    tn.fit(ListDataSetIterator(DataSet(xs, ys), 4))
    names = (PADDED, SYNC, MISS)
    assert _counters(t, *names) == _counters(j, *names) == [1, 2, 2]
    assert t.value(SYNC) == score_sink(tn).flushes
    stager = stager_of(tn)
    assert t.value(H2D) == stager.nbytes and stager.copies == 0
    # three batches of features and labels, and the tail's f32 mask
    itemsize = np.dtype(source).itemsize
    assert t.value(H2D) == 3 * 4 * (4 * itemsize + 3 * 4) + 4 * 4
    if source == np.float32:
        assert t.value(H2D) == j.value(H2D)
    else:  # the reference counts the features cast to f32
        assert j.value(H2D) == 3 * 4 * (4 + 3) * 4 + 4 * 4
    assert t.value(tmon.FEED_QUEUE_DEPTH_GAUGE) is not None
    stage = [a for n, a in t.spans(main_only=False) if n == "stage"]
    assert stage == [{"path": "device_feed"}] * 3
    assert [n for n, _ in t.spans()] == [n for n, _ in j.spans()]


# ------------------------------------------------- services' counters

def _poisoned(n=4, poison=1):
    x, y = _iris_like(4 * n, seed=3)
    out = []
    for i in range(n):
        xb = x[4 * i:4 * i + 4].copy()
        if i == poison:
            xb[0, 0] = np.nan
        out.append((xb, y[4 * i:4 * i + 4]))
    return out


def _marks(side):
    return [(n, {k: (repr(v) if isinstance(v, float) and math.isnan(v) else v)
                 for k, v in a.items()})
            for n, a in side.spans() if n.startswith("training_")]


def test_supervisor_rollbacks_and_marks_are_the_references(sides):
    j, t = sides
    jn, tn = _mlp_pair()
    js, ts = JSup(jn, max_rollbacks=1), TrainingSupervisor(tn, max_rollbacks=1)
    batches = _poisoned(poison=1)
    for xb, yb in batches[:2]:
        assert js.step(JDataSet(xb, yb)) == ts.step(DataSet(xb, yb))
    with pytest.raises(TrainingDiverged):
        ts.step(DataSet(*batches[1]))
    with pytest.raises(JDiverged):
        js.step(JDataSet(*batches[1]))
    assert _marks(t) == _marks(j) == [
        ("training_rollback", {"rollback": 1, "score": "nan", "lr_scale": 0.5}),
        ("training_diverged", {"rollbacks": 2, "score": "nan"})]
    names = (tmon.FAULT_ROLLBACKS_COUNTER,)
    assert _counters(t, *names) == _counters(j, *names) == [2]
    assert t.value(tmon.FAULT_EVENTS_COUNTER, domain="training") == \
        j.value(jmon.FAULT_EVENTS_COUNTER, domain="training") == 2


def test_corrupt_checkpoint_counts_as_the_reference(sides, tmp_path):
    j, t = sides
    jn, tn = _mlp_pair()
    path = str(tmp_path / "m.zip")
    tser.write_model(tn, path)
    with zipfile.ZipFile(path) as z:
        members = {n: z.read(n) for n in z.namelist()}
    bad = bytearray(members["coefficients.npz"])
    bad[len(bad) // 2] ^= 0xFF
    members["coefficients.npz"] = bytes(bad)
    with zipfile.ZipFile(path, "w") as z:  # CRCs recomputed: the manifest's not
        for n, b in members.items():
            z.writestr(n, b)
    with pytest.raises(tser.CheckpointCorruptError):
        tser.restore_model(path, device="cpu")
    with pytest.raises(jser.CheckpointCorruptError):
        jser.restore_model(path)
    for side in (j, t):
        assert side.value(tmon.FAULT_CKPT_INTEGRITY_COUNTER) == 1
        assert side.value(tmon.FAULT_EVENTS_COUNTER, domain="checkpoint") == 1
    assert ("checkpoint", {"op": "zip_save", "path": path}) in t.spans()


def test_resume_skipping_a_torn_unit_records_a_fault(sides, tmp_path):
    from deeplearning4j_tpu_torch.optimize.resumable import ResumableTrainer

    _, t = sides
    _, tn = _mlp_pair()
    trainer = ResumableTrainer(tn, str(tmp_path), checkpoint_every=1)
    x, y = _iris_like(8)
    trainer.fit(ListDataSetIterator(DataSet(x, y), 4))
    unit = os.path.join(str(tmp_path), "checkpoint", "model.zip")
    with open(unit, "wb") as f:
        f.write(b"torn")
    ResumableTrainer(tn, str(tmp_path)).resume_or_start()
    assert t.value(tmon.FAULT_EVENTS_COUNTER, domain="checkpoint") >= 1
    assert t.value(tmon.FAULT_CKPT_INTEGRITY_COUNTER) >= 1


def test_performance_listener_counts_as_the_reference(sides):
    j, t = sides
    jn, tn = _mlp_pair()
    jn.set_listeners(JPerf(frequency=2))
    tn.set_listeners(PerformanceListener(frequency=2))
    x, y = _iris_like(20)
    jn.fit(JList(JDataSet(x, y), 4))
    tn.fit(ListDataSetIterator(DataSet(x, y), 4))
    assert t.value("dl4j_iterations_total") == \
        j.value("dl4j_iterations_total") == 5
    assert t.value("dl4j_iterations_per_sec") > 0


# ------------------------------------------------------------ serving

SIZE = dict(vocab_size=11, d_model=16, n_layers=2, num_heads=2, max_len=32)


@pytest.fixture(scope="module")
def gpts():
    jn = jax_gpt(compute_dtype="float32", seed=0, **SIZE).init()
    tn = gpt(compute_dtype="float32", seed=0, device="cpu", **SIZE)
    params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
    return jn, tn


DECODE = (tmon.DECODE_REQUESTS_COUNTER, tmon.DECODE_PREFILL_TOKENS_COUNTER,
          tmon.DECODE_TOKENS_COUNTER)


@pytest.mark.parametrize("kind", ["transformer", "recurrent"])
def test_generate_ticks_the_decode_family_as_the_reference(sides, gpts, kind):
    j, t = sides
    if kind == "transformer":
        jn, tn = gpts
        prompts = np.random.default_rng(3).integers(0, 11, (2, 5))
    else:
        jn, tn = _char_pair()
        prompts = np.random.default_rng(3).integers(0, V, (2, 5))
    for new in (4, 4, 6):
        want = jgenerate(jn, prompts, new)
        got = generate(tn, prompts, new)
        if kind == "transformer":
            np.testing.assert_array_equal(got, want)
    assert _counters(t, *DECODE) == _counters(j, *DECODE) == [3, 30, 28]
    for side in (j, t):
        for name in (tmon.DECODE_PREFILL_LATENCY_HISTOGRAM,
                     tmon.DECODE_LATENCY_HISTOGRAM):
            assert side.reg.get(name).count == 3
    got = _same_spans(j, t)
    # a transformer's prefill signs its cache length (prompt + new
    # tokens); a recurrent one's does not
    fresh = "compile" if kind == "transformer" else "inference"
    assert [n for n, _ in got] == ["compile", "compile", "inference",
                                   "inference", fresh, "compile"]
    assert got[0][1] == {"path": "generate_prefill", "bucket": 8, "rows": 2}
    assert got[1][1] == {"path": "generate_decode", "rows": 2, "max_new": 4}
    assert t.value(MISS) == j.value(MISS) == (4 if kind == "transformer" else 3)


KNOBS = dict(slots=4, burst_tokens=4, block_size=4, start=False)
SCHED = ("dl4j_sched_admitted_rows_total", "dl4j_sched_retired_rows_total",
         "dl4j_sched_preemptions_total", "dl4j_sched_bursts_total",
         "dl4j_sched_active_sequences", "dl4j_sched_queued_prefills")


def _serve(cls, net, prompts, rt, **kw):
    tracer = rt.enable_request_tracing()
    try:
        s = cls(net=net, **dict(KNOBS, **kw))
        futs = [s.submit(p, 10) for p in prompts[:3]]
        s.step()
        futs += [s.submit(p, 10) for p in prompts[3:]]
        for _ in range(200):
            if all(f.done() for f in futs):
                break
            s.step()
        return s, [f.result(0) for f in futs], tracer
    finally:
        rt.disable_request_tracing()


def _trace_shape(tracer):
    """Each completed trace's root and spans, timing attributes left out."""
    untimed = lambda a: {k: v for k, v in a.items() if k != "ttft_ms"}  # noqa: E731
    return [(tr["name"], untimed(tr["attrs"]),
             [(s["name"], untimed(s.get("attrs", {}))) for s in tr["spans"]])
            for tr in tracer.completed_traces()]


@pytest.mark.parametrize("num_blocks", [None, 12])
def test_paged_scheduler_metrics_and_traces_are_the_references(sides, gpts,
                                                               num_blocks):
    j, t = sides
    jn, tn = gpts
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 11, (1, int(n))) for n in (5, 9, 3, 12, 7)]
    js, jout, jtr = _serve(jcont.ContinuousDecodeScheduler, jn, prompts, jrt,
                           num_blocks=num_blocks)
    ts, tout, ttr = _serve(ContinuousDecodeScheduler, tn, prompts, trt,
                           num_blocks=num_blocks)
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a, b)
    st = ts.stats()
    assert _counters(t, *SCHED) == _counters(j, *SCHED)
    assert [v or 0 for v in _counters(t, *SCHED)] == [
        st["admitted_rows"], st["retired_rows"], st["preemptions"],
        st["bursts"], 0, 0]
    assert (st["preemptions"] > 0) == (num_blocks is not None)
    for name in (tmon.KVPOOL_BLOCKS_TOTAL_GAUGE, tmon.KVPOOL_BLOCKS_FREE_GAUGE,
                 tmon.KVPOOL_ALLOC_FAILURES_COUNTER):
        assert t.value(name, pool="decode") == j.value(name, pool="decode")
    assert t.value(tmon.KVPOOL_BLOCKS_FREE_GAUGE, pool="decode") == \
        st["pool"]["blocks_total"]
    for name in (tmon.ATTR_PREFILL_TOKENS_COUNTER, tmon.ATTR_DECODE_TOKENS_COUNTER):
        assert t.value(name, model="default") == j.value(name, model="default")
    # every admission samples one token, every burst the rest
    assert t.value(tmon.ATTR_DECODE_TOKENS_COUNTER, model="default") + \
        st["admitted_rows"] == sum(c["tokens"] for c in ts.completed)
    assert t.reg.get(tmon.SCHED_BURST_LATENCY_HISTOGRAM).count == st["bursts"]
    for name in (tmon.TS_SCHED_ACTIVE, tmon.TS_SCHED_QUEUED,
                 tmon.TS_SCHED_POOL_OCCUPANCY):
        assert t.mon.ts_query(name, 600.0)["count"] == \
            j.mon.ts_query(name, 600.0)["count"] > 0
    assert t.value(MISS) == j.value(MISS)
    assert _trace_shape(ttr) == _trace_shape(jtr)
    shapes = _trace_shape(ttr)
    assert len(shapes) == len(prompts)
    for name, attrs, spans in shapes:
        assert name == "decode_request" and attrs["outcome"] == "ok"
        names = [n for n, _ in spans]
        assert {"queue_wait", "prefill", "decode_burst"} <= set(names)
    assert (sum(n == "preempt" for _, _, sp in shapes for n, _ in sp)
            == st["preemptions"])
    assert [n for n, _ in t.spans()] == [n for n, _ in j.spans()]


def test_request_traces_pass_the_schema_check(gpts, tmp_path):
    _, tn = gpts
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 11, (1, int(n))) for n in (5, 9, 3)]
    trt.configure_flight_recorder()
    _serve(ContinuousDecodeScheduler, tn, prompts, trt)
    path = trt.flight_recorder().dump(str(tmp_path / "flight.jsonl"))
    assert schema.validate_jsonl_file(path) == []
    with open(path) as f:
        traces = [json.loads(line) for line in f]
    assert sum(r["type"] == "trace" for r in traces) == 3


# --------------------------------------------------- tracing on and off

def _traced_fit(traced, pipeline):
    _, tn = _char_pair()
    if traced:
        reg = tmon.MetricsRegistry()
        old = tmon.set_registry(reg)
        tmon.enable_tracing()
    try:
        scores = CollectScoresIterationListener(frequency=1)
        tn.set_listeners(scores)
        x, y = _char_data(10, 6, seed=2)
        tn.fit(ListDataSetIterator(DataSet(x, y), 4), feed_pipeline=pipeline)
        tn.fit(DataSet(x, y))
        scan = tn.fit_scan(DataSet(x[:8], y[:8]), 4, epochs=2)
        gen = generate(tn, np.zeros((2, 3), np.int64), 4, temperature=0.7,
                       seed=3)
        return tn, scores.scores, scan, gen
    finally:
        if traced:
            tmon.disable_tracing()
            tmon.set_registry(old)


@pytest.mark.parametrize("pipeline", [True, False])
def test_tracing_on_and_off_are_bit_for_bit(pipeline):
    on, s_on, scan_on, gen_on = _traced_fit(True, pipeline)
    off, s_off, scan_off, gen_off = _traced_fit(False, pipeline)
    assert s_on == s_off and len(s_on) == 4
    np.testing.assert_array_equal(scan_on, scan_off)
    np.testing.assert_array_equal(gen_on, gen_off)
    for l, p in off.params.items():
        for n, v in p.items():
            assert torch.equal(on.params[l][n], v), f"{l}/{n}"
