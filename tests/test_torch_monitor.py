"""The port's monitor core against the JAX package's.

The same operations go through both packages' modules: the registry's
Prometheus text (label and HELP escaping included) and JSON must be
byte-equal, the time-series store under an injected logical clock must
answer every query alike, request traces and the flight recorder must
give the same span structure (everything but timestamps, durations and
thread ids), and the step-health watchdog the same counts on the same
score stream. Also the reference's own span-overhead bound (< 0.1 ms a
span) and command-line case, the gauge that holds a card's tensor
until it is read, and the ``torch.profiler`` wrappers.
"""

import importlib.util
import json
import math
import os
import time

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.monitor as jmon
import deeplearning4j_tpu_torch.monitor as tmon
from deeplearning4j_tpu.monitor import reqtrace as jrt
from deeplearning4j_tpu.monitor import timeseries as jts
from deeplearning4j_tpu_torch.monitor import reqtrace as trt
from deeplearning4j_tpu_torch.monitor import timeseries as tts
from deeplearning4j_tpu_torch.util import profiler

_SCRIPT = os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                       "check_telemetry_schema.py")
_spec = importlib.util.spec_from_file_location("check_telemetry_schema",
                                               _SCRIPT)
schema = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(schema)


@pytest.fixture
def registries():
    """A fresh process registry in each package, restored afterwards."""
    regs = (jmon.MetricsRegistry(), tmon.MetricsRegistry())
    olds = (jmon.set_registry(regs[0]), tmon.set_registry(regs[1]))
    try:
        yield regs
    finally:
        jmon.set_registry(olds[0])
        tmon.set_registry(olds[1])
        jmon.disable_tracing()
        tmon.disable_tracing()


# ------------------------------------------------------------- registry

ODD = 'a"b\\c\nd'


def _ops_counters(reg):
    reg.counter("dl4j_x_total", "plain help").inc()
    reg.counter("dl4j_x_total", "", path=ODD).inc(2.5)
    reg.counter("dl4j_x_total", "", path="plain", kind="z").inc(3)
    reg.counter("dl4j_y_total", 'help with "quotes" \\ and\nnewline').inc(7)


def _ops_gauges(reg):
    reg.gauge("dl4j_g", "gauge").set(3)
    reg.gauge("dl4j_g", "", pool="p\n1").set(0.1)
    reg.gauge("dl4j_g", "", pool="inf").set(float("inf"))
    reg.gauge("dl4j_g", "", pool="ninf").set(float("-inf"))
    reg.gauge("dl4j_g", "", pool="nan").set(float("nan"))
    reg.gauge("dl4j_g", "", pool="big").set(1e17)
    reg.gauge("dl4j_unset", "never set")


def _ops_histograms(reg):
    h = reg.histogram("dl4j_h_ms", "durations", phase="x")
    for v in (0.05, 0.3, 0.3, 7.0, 12345.0, 1e9, float("nan")):
        h.observe(v)
    h2 = reg.histogram("dl4j_h_ms", "", buckets=(1.0, 2.0), phase=ODD)
    for v in (0.5, 1.5, 2.5):
        h2.observe(v)
    reg.histogram("dl4j_rows", "rows", buckets=tmon.INFER_BATCH_SIZE_BUCKETS
                  ).observe(64)


def _ops_mixed(reg):
    _ops_counters(reg)
    _ops_gauges(reg)
    _ops_histograms(reg)


@pytest.mark.parametrize("ops", [_ops_counters, _ops_gauges, _ops_histograms,
                                 _ops_mixed])
def test_prometheus_text_and_json_are_the_references_byte_for_byte(ops):
    jr, tr = jmon.MetricsRegistry(), tmon.MetricsRegistry()
    ops(jr)
    ops(tr)
    assert tr.prometheus_text() == jr.prometheus_text()
    assert tr.to_json() == jr.to_json()
    assert tr.names() == jr.names()
    assert schema.validate_prometheus_text(tr.prometheus_text()) == []


def test_registry_kinds_and_family_totals_as_the_reference():
    for mod in (jmon, tmon):
        reg = mod.MetricsRegistry()
        reg.counter("dl4j_c_total", a="1").inc(2)
        reg.counter("dl4j_c_total", a="2").inc(3)
        assert reg.family_total("dl4j_c_total") == 5
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("dl4j_c_total")
        with pytest.raises(ValueError, match="only go up"):
            reg.counter("dl4j_c_total").inc(-1)


def test_every_metric_name_and_bucket_is_the_references():
    names = lambda m: {k: v for k, v in vars(m).items()  # noqa: E731
                       if k.isupper() and isinstance(v, (str, tuple))}
    assert names(tmon) == names(jmon)
    assert tmon.DEFAULT_MS_BUCKETS == jmon.DEFAULT_MS_BUCKETS
    for k in ("TS_SCHED_ACTIVE", "TS_SCHED_QUEUED", "TS_SCHED_POOL_OCCUPANCY",
              "TS_SLO_BURN", "TS_WORKER_SERVED"):
        assert getattr(tts, k) == getattr(jts, k)


def test_record_fault_and_phase_breakdown_as_the_reference(registries):
    jr, tr = registries
    for mod, reg in ((jmon, jr), (tmon, tr)):
        mod.record_fault("checkpoint")
        mod.record_fault("training")
        mod.record_fault("training")
        h = reg.histogram(mod.PHASE_HISTOGRAM, "", phase="device_step")
        for v in (1.0, 2.0, 4.0):
            h.observe(v)
    assert tr.prometheus_text() == jr.prometheus_text()
    assert tmon.phase_breakdown(tr) == jmon.phase_breakdown(jr)


class _CardScalar:
    """Stands in for a CUDA tensor: ``is_cuda`` and a counted read."""

    is_cuda = True

    def __init__(self, v):
        self.v, self.reads = v, 0

    def __float__(self):
        self.reads += 1
        return float(self.v)


def test_gauge_holds_a_card_tensor_until_it_is_read():
    reg = tmon.MetricsRegistry()
    x = _CardScalar(2.5)
    reg.gauge("dl4j_quant_scale_absmax", layer="l", param="W").set(x)
    assert x.reads == 0  # setting never waits on the card
    assert "dl4j_quant_scale_absmax" in reg.prometheus_text()
    assert x.reads == 1
    assert reg.get("dl4j_quant_scale_absmax", layer="l", param="W").value == 2.5
    assert x.reads == 1  # read once, then held as a float
    reg.gauge("dl4j_g").set(torch.tensor(1.5))  # a CPU tensor reads at once
    assert reg.get("dl4j_g").value == 1.5


# ---------------------------------------------------------- time series

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _series_run(mod, clock):
    store = mod.TimeSeriesStore(clock=clock, tiers=((1.0, 5), (10.0, 4)),
                                samples_per_bucket=8, max_series=3)
    rng = np.random.default_rng(4)
    answers = []
    for step in range(90):
        clock.t += float(rng.choice([0.1, 0.3, 0.7, 1.9]))
        store.record(("a", "b", "c", "d")[step % 4], float(rng.normal()))
        if step % 9 == 0:
            answers.append([store.query(n, w) for n in ("b", "c", "d")
                            for w in (0.5, 3.0, 30.0, 500.0)])
    answers.append(store.snapshot())
    answers.append(store.summary(window_s=20.0))
    answers.append([store.series(n).tier_view(i) for n in store.names()
                    for i in (0, 1)])
    return store, answers


def _nan_safe(obj):
    return json.loads(json.dumps(obj, default=str).replace("NaN", '"nan"'))


def test_time_series_queries_are_the_references_under_one_clock():
    _, want = _series_run(jts, _Clock())
    _, got = _series_run(tts, _Clock())
    assert _nan_safe(got) == _nan_safe(want)


def test_merged_summaries_and_hooks_are_the_references(registries):
    sums = []
    for mod in (jts, tts):
        stores = []
        for k in range(3):
            clock = _Clock()
            st, _ = _series_run(mod, clock)
            clock.t += k
            stores.append(st.summary(window_s=60.0))
        sums.append(mod.merge_summaries(stores + [{"bad": 1}]))
    assert sums[1] == sums[0]
    for mod, pkg, reg in ((jts, jmon, registries[0]), (tts, tmon, registries[1])):
        assert mod.timeseries_enabled()
        mod.ts_record(mod.TS_SCHED_ACTIVE, 3)
        old = mod.set_timeseries_enabled(False)
        mod.ts_record(mod.TS_SCHED_ACTIVE, 5)
        mod.set_timeseries_enabled(old)
        q = mod.ts_query(mod.TS_SCHED_ACTIVE, 10.0)
        assert q["count"] == 1 and q["mean"] == 3.0
        assert reg.timeseries is pkg.get_registry().timeseries


# ------------------------------------------------------- request traces

def _strip(rec):
    """A record without its timestamps, durations and thread ids, at
    every depth."""
    if isinstance(rec, dict):
        return {k: _strip(v) for k, v in rec.items()
                if k not in ("ts_us", "dur_us", "tid")}
    if isinstance(rec, list):
        return [_strip(v) for v in rec]
    return rec


def _trace_run(rt, tmp_dir, overflow):
    tracer = rt.enable_request_tracing(sample=1.0, max_spans_per_trace=8)
    rt.configure_flight_recorder(dump_dir=tmp_dir, capacity_traces=4)
    try:
        out = []
        for r in range(3):
            root = rt.begin_trace("decode_request", rows=1, t_in=5 + r)
            ctx = root.ctx
            child = rt.start_span("admission", ctx, slot=r)
            rt.record_span(child.ctx, "queue_wait", 1.0, 2.0, row=0)
            ps = rt.record_span(ctx, "prefill", 3.0, 4.0, kind="dense")
            # with ``overflow`` the third trace passes its cap of 8 spans:
            # the rest, its root's record included, are dropped (counted)
            for b in range(12 if overflow and r == 2 else 2):
                rt.record_span(ps, "decode_burst", 5.0 + b, 1.0, seq=b)
            rt.trace_event(ctx, "preempt", seq=r)
            child.close(done=True)
            with rt.use_trace(ctx):
                assert rt.current_trace() is ctx
            spans = rt.finish_trace(root, outcome="ok", tokens=4)
            out.append([_strip(s) for s in spans])
        rt.flight_event("rollback", step=3)
        out.append(rt.flight_trigger("ejection", endpoint="e1") is not None)
        out.append([_strip(t) for t in tracer.completed_traces()])
        out.append(tracer.dropped)
        unsampled = rt.RequestTracer(sample=0.0)
        out.append(unsampled.begin_trace("x") is None)
        recs = rt.flight_recorder().records()
        out.append([{k: v for k, v in r.items() if k not in ("ts_us", "pid",
                                                            "spans")}
                    for r in recs])
        path = rt.flight_recorder().dump(os.path.join(tmp_dir, "f.jsonl"))
        return out, path
    finally:
        rt.disable_request_tracing()
        rt.configure_flight_recorder()


@pytest.mark.parametrize("overflow", [False, True])
def test_request_traces_and_flight_recorder_as_the_references(registries,
                                                              tmp_path,
                                                              overflow):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want, _ = _trace_run(jrt, str(tmp_path / "j"), overflow)
    got, path = _trace_run(trt, str(tmp_path / "t"), overflow)
    assert got == want
    assert (got[-3] > 0) == overflow  # the tracer's dropped spans
    if not overflow:
        assert schema.validate_jsonl_file(path) == []
    jr, tr = registries
    strip_phase = lambda t: "\n".join(  # noqa: E731
        line for line in t.splitlines() if "dl4j_req_phase_ms" not in line)
    assert strip_phase(tr.prometheus_text()) == strip_phase(jr.prometheus_text())
    assert tr.get(trt.TRACE_SPANS_COUNTER).value == \
        jr.get(jrt.TRACE_SPANS_COUNTER).value


def test_wire_context_round_trip_as_the_reference():
    for rt in (jrt, trt):
        ctx = rt.TraceContext("t1", "s2")
        back = rt.from_wire(ctx.wire())
        assert (back.trace_id, back.span_id) == ("t1", "s2")
        assert rt.from_wire({"id": 3}) is None and rt.from_wire(None) is None


# ---------------------------------------------------------- step health

def _stream():
    rng = np.random.default_rng(9)
    out = []
    for i in range(80):
        score = float(rng.normal())
        if i in (7, 41):
            score = float("nan")
        if i == 60:
            score = float("inf")
        dur = 10.0 + float(rng.random())
        if i in (30, 55, 70):
            dur = 100.0
        out.append((score, None if i == 0 else dur, i))
    return out


def test_step_health_counts_are_the_references_on_one_score_stream(registries):
    jr, tr = registries
    dogs = (jmon.StepHealthWatchdog(window=32, min_samples=10),
            tmon.StepHealthWatchdog(window=32, min_samples=10))
    for score, dur, i in _stream():
        for dog in dogs:
            dog.record(score, dur, iteration=i)
    assert dogs[1].nan_iterations == dogs[0].nan_iterations == [7, 41, 60]
    assert dogs[1].slow_iterations == dogs[0].slow_iterations
    assert dogs[1].slow_iterations
    assert dogs[1].percentiles() == dogs[0].percentiles()
    assert tr.prometheus_text() == jr.prometheus_text()
    assert not dogs[1].healthy()


def test_watchdog_reads_only_what_the_deferred_ring_delivers(registries):
    """On the listener chain of ``fit`` the watchdog sees each step's
    exact score once, in order, from the ring's batched fetch."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.deferred import score_sink
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresIterationListener,
    )

    conf = (NeuralNetConfiguration.builder().seed(5).learning_rate(0.1)
            .updater("sgd").activation("tanh").list()
            .layer(L.DenseLayer(n_in=4, n_out=8))
            .layer(L.OutputLayer(n_in=8, n_out=2, activation="softmax",
                                 loss_function="mcxent")).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((40, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 40)]
    dog = tmon.StepHealthWatchdog(window=8, min_samples=2)
    seen = []
    record = dog.record
    dog.record = lambda score, dur, iteration=-1: (  # noqa: E731
        seen.append((iteration, type(score))), record(score, dur, iteration))
    scores = CollectScoresIterationListener(frequency=5)
    net.set_listeners(scores, dog)
    net.fit(ListDataSetIterator(DataSet(x, y), 4))
    # the watchdog declares no frequency: the ring fetches at every step
    # (ten stacked fetches), and the watchdog reads only host floats
    assert score_sink(net).flushes == 10
    assert seen == [(i, float) for i in range(1, 11)]
    assert registries[1].get(tmon.SCORE_GAUGE).value == float(net.score())
    assert scores.scores[-1] == (10, float(net.score()))
    assert dog.nan_iterations == [] and dog.healthy()


# ---------------------------------------------------- spans and overhead

def test_span_feeds_the_phase_histogram_and_tags_errors(registries, tmp_path):
    _, tr = registries
    path = str(tmp_path / "ev.jsonl")
    tracer = tmon.enable_tracing(path)
    with tmon.span("device_step", iteration=1):
        pass
    with pytest.raises(KeyError):
        with tmon.span("eval", path="score"):
            raise KeyError("x")
    tmon.mark("nan_score", iteration=2)
    tmon.disable_tracing()
    ev = tracer.events()
    assert [e["name"] for e in ev] == ["device_step", "eval", "nan_score"]
    assert ev[1]["attrs"] == {"path": "score", "error": "KeyError"}
    assert tr.get(tmon.PHASE_HISTOGRAM, phase="eval").count == 1
    assert schema.validate_events_file(path) == []
    trace = tracer.chrome_trace()
    assert [e["ph"] for e in trace["traceEvents"]] == ["M", "X", "X", "i"]


def _best_s(fn, repeats=5):
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def test_monitoring_overhead_under_5_percent(registries):
    """The reference's bars: a span costs < 0.1 ms, and spans around a
    step-loop-scale workload (~2 ms a step) cost < 5 %. Each loop's time
    is its best of five, so that the sleeps' jitter on a loaded host is
    not read as the spans' cost."""
    n = 200

    def bare_spans():
        for _ in range(n):
            pass

    def spans():
        for i in range(n):
            with tmon.span("device_step", iteration=i):
                pass

    per_span_ms = max(0.0, _best_s(spans) - _best_s(bare_spans)) / n * 1e3
    assert per_span_ms < 0.1, f"span overhead {per_span_ms:.4f}ms"

    def work():
        time.sleep(0.002)

    def bare():
        for _ in range(30):
            work()

    def instrumented():
        for i in range(30):
            with tmon.span("device_step", iteration=i):
                work()

    assert _best_s(instrumented, 3) < _best_s(bare, 3) * 1.05 + 0.05


def test_command_line_interface(registries, tmp_path):
    _, tr = registries
    tmon.enable_tracing(str(tmp_path / "ev.jsonl"))
    with tmon.span("device_step"):
        pass
    tracer = tmon.disable_tracing()
    tracer.export_chrome_trace(str(tmp_path / "trace.json"))
    metrics = tmp_path / "metrics.txt"
    metrics.write_text(tr.prometheus_text())
    rc = schema.main([str(tmp_path / "ev.jsonl"), str(tmp_path / "trace.json"),
                      "--metrics", str(metrics), "--check-names"])
    assert rc == 0
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"type": "span", "name": "x"}\n')
    assert schema.main([str(bad)]) == 1


def test_training_stats_share_the_monitor_clock():
    from deeplearning4j_tpu_torch.monitor import tracing
    from deeplearning4j_tpu_torch.optimize.training_stats import TrainingStats

    stats = TrainingStats()
    assert stats._origin == tracing._ORIGIN
    with stats.time("step"):
        pass
    (phase, start_ms, _), = stats._events
    assert phase == "step"
    assert abs(start_ms - tracing.now_us() / 1e3) < 1000.0


# ------------------------------------------------------------- profiler

def test_profiler_trace_writes_a_loadable_trace(tmp_path):
    with profiler.trace(str(tmp_path)):
        with profiler.annotate("phase_x"):
            torch.ones(8).sum()
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert files, os.listdir(tmp_path)
    with open(tmp_path / files[0]) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "phase_x" in names


def test_profiler_server_is_not_available():
    with pytest.raises(profiler.ProfilerServerUnavailable,
                       match="no on-demand profiling server"):
        profiler.start_server(9999)
    assert isinstance(profiler.ProfilerServerUnavailable(), NotImplementedError)
    assert math.isfinite(tmon.now_us())
