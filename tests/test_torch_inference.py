"""The port's serving engine (``parallel/inference.py``
``ParallelInference``) against the JAX package's.

The nets: a 4-8-3 tanh MLP (seed 7, f32), its ComputationGraph twin, a
GravesLSTM char-RNN (vocab 8, hidden 16) and a tiny ``gpt`` (vocab 11,
d_model 16, 2 layers, 2 heads, max_len 32, f32), each with the JAX net's
parameters carried into the port's. Requests are made from a seed with
numpy and go through both engines (the reference's on its CPU devices,
the port's on ``devices=["cpu", ...]``, the same device twice where two
replicas are needed). Tolerances, relative to the largest magnitude of
the expected rows (f32): a caller's rows within 1e-6 of the port's own
``net.output`` of those rows (bit for bit where the batch held the same
rows) and within 1e-4 of the reference engine's (the reference's XLA
programs at some coalesced batch shapes round its tanh otherwise: up to
2.4e-5 was seen); token ids equal exactly. Coalescing, padding, the latency window,
backpressure, errors, draining, warmup's first dispatches
(``dl4j_jit_cache_miss_total``), the Prometheus names, batch-statistics
nets, quarantine with redispatch and probe (a ``poison_hook``), the
batch FIFO, the coalesced ``generate``, the continuous engine
with and without the prefix cache, and the knobs left for later slices.
The card's cases are in ``tests/test_torch_engine_cuda.py``.
"""

import os
import queue
import threading
import time
import importlib.util

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.datasets.iterators import bucket_for as jbucket_for
from deeplearning4j_tpu.datasets.iterators import bucket_sizes as jbucket_sizes
from deeplearning4j_tpu.models.zoo.transformer import gpt as jax_gpt
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.graph import \
    ComputationGraphConfiguration as JaxCGC
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.parallel import inference as jinf
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.datasets.iterators import bucket_for, bucket_sizes
from deeplearning4j_tpu_torch.models.zoo.transformer import gpt
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.generate import generate
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import inference as tinf
from deeplearning4j_tpu_torch.parallel.inference import (
    EngineShutdown,
    InferenceBackpressure,
    ParallelInference,
)
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

N_IN, N_OUT = 4, 3
TOL, TOL_REF = 1e-6, 1e-4
CPU2 = ["cpu", "cpu"]
VOCAB = 11
GPT_SIZE = dict(vocab_size=VOCAB, d_model=16, n_layers=2, num_heads=2,
                max_len=32)

_schema_spec = importlib.util.spec_from_file_location(
    "check_telemetry_schema",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "scripts", "check_telemetry_schema.py"))
schema = importlib.util.module_from_spec(_schema_spec)
_schema_spec.loader.exec_module(schema)


def _conf(NNC, Lmod):
    return (NNC.builder().seed(7).learning_rate(0.1).updater("sgd")
            .activation("tanh").list()
            .layer(Lmod.DenseLayer(n_in=N_IN, n_out=8))
            .layer(Lmod.OutputLayer(n_in=8, n_out=N_OUT, activation="softmax",
                                    loss_function="mcxent"))
            .build())


def _carry(tn, jn):
    params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
    return tn


@pytest.fixture(scope="module")
def nets():
    jn = JaxMLN(_conf(JaxNNC, JL)).init()
    tn = MultiLayerNetwork(_conf(NeuralNetConfiguration, L), device="cpu")
    return jn, _carry(tn, jn)


@pytest.fixture
def net(nets):
    return nets[1]


@pytest.fixture
def fresh_registry():
    prev = monitor.set_registry(monitor.MetricsRegistry())
    yield monitor.get_registry()
    monitor.set_registry(prev)


@pytest.fixture(scope="module")
def gpts():
    jn = jax_gpt(compute_dtype="float32", seed=0, **GPT_SIZE).init()
    tn = gpt(compute_dtype="float32", seed=0, device="cpu", **GPT_SIZE)
    return jn, _carry(tn, jn)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _spin(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.005)
    return True


def test_bucket_helpers_are_the_references():
    for n in (1, 8, 12, 33):
        assert bucket_sizes(n) == jbucket_sizes(n)
    for n in range(1, 11):
        assert bucket_for(n, (1, 2, 4, 8)) == jbucket_for(n, (1, 2, 4, 8))
    with pytest.raises(ValueError):
        bucket_sizes(0)


def test_concurrent_submit_matches_the_reference_engine(nets):
    """24 requests of 2-4 rows from 4 threads through two replicas: every
    caller gets its own rows, as the reference engine gives them."""
    jn, tn = nets
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((2 + i % 3, N_IN)).astype(np.float32)
          for i in range(24)]
    got = {}
    for name, eng in (
            ("ref", jinf.ParallelInference(jn, max_batch_size=8,
                                           max_latency_ms=2.0, replicas=2)),
            ("port", ParallelInference(tn, max_batch_size=8,
                                       max_latency_ms=2.0, devices=CPU2))):
        results = [None] * len(xs)

        def some(lo, hi, eng=eng, results=results):
            futs = [(j, eng.submit(xs[j])) for j in range(lo, hi)]
            for j, f in futs:
                results[j] = f.result(timeout=60)

        threads = [threading.Thread(target=some, args=(k, k + 6))
                   for k in range(0, 24, 6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert eng.stats()["requests"] == 24
        eng.shutdown()
        got[name] = results
    for x, r, ref in zip(xs, got["port"], got["ref"]):
        assert r.shape == (x.shape[0], N_OUT) and r.dtype == np.float32
        _close(r, ref, TOL_REF)
        _close(r, tn.output(x))


def test_singleton_coalescing_row_routing(net, nets):
    """Eight singletons in one latency window are one batch of eight,
    padded nowhere; the rows are those of ``output`` on the eight rows
    together, bit for bit, and the reference engine's."""
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((1, N_IN)).astype(np.float32) for _ in range(8)]
    eng = ParallelInference(net, max_batch_size=8, max_latency_ms=500.0,
                            devices=["cpu"], eager_when_idle=False)
    try:
        rows = [f.result(timeout=60) for f in [eng.submit(x) for x in xs]]
        np.testing.assert_array_equal(np.concatenate(rows),
                                      net.output(np.concatenate(xs)))
        assert eng.stats()["batches"] == 1
        assert eng.stats()["rows_padded"] == 0
    finally:
        eng.shutdown()
    _close(np.concatenate(rows),
           np.asarray(nets[0].output(np.concatenate(xs))), TOL_REF)


def test_eager_dispatch_when_idle(net):
    eng = ParallelInference(net, max_batch_size=64, max_latency_ms=500.0,
                            devices=["cpu"])
    try:
        eng.warmup([(N_IN,)])
        t0 = time.perf_counter()
        eng.output(np.ones((2, N_IN), np.float32), timeout=60)
        assert time.perf_counter() - t0 < 0.4  # never waited out 500 ms
    finally:
        eng.shutdown()


def test_max_latency_flush(net):
    eng = ParallelInference(net, max_batch_size=64, max_latency_ms=30.0,
                            devices=["cpu"], eager_when_idle=False)
    try:
        eng.warmup([(N_IN,)])
        t0 = time.perf_counter()
        eng.submit(np.ones((2, N_IN), np.float32)).result(timeout=60)
        elapsed = time.perf_counter() - t0
        assert 0.02 <= elapsed < 5.0  # held for the window, then flushed
        assert eng.stats()["rows_dispatched"] == 2
    finally:
        eng.shutdown()


def test_padding_to_bucket(net, nets):
    x = np.random.default_rng(2).standard_normal((3, N_IN)).astype(np.float32)
    eng = ParallelInference(net, max_batch_size=8, max_latency_ms=1.0,
                            devices=["cpu"])
    ref = jinf.ParallelInference(nets[0], max_batch_size=8,
                                 max_latency_ms=1.0, replicas=1)
    try:
        out = eng.submit(x).result(timeout=60)
        want = ref.submit(x).result(timeout=60)
        assert out.shape == (3, N_OUT)  # de-padded
        _close(out, want, TOL_REF)
        s, rs = eng.stats(), ref.stats()
        assert (s["rows_dispatched"], s["rows_padded"]) == (4, 1) == \
            (rs["rows_dispatched"], rs["rows_padded"])
        assert s["padded_ratio"] == rs["padded_ratio"] == 0.25
    finally:
        eng.shutdown()
        ref.shutdown()


def test_backpressure_reject_and_deferred_start(net):
    eng = ParallelInference(net, max_batch_size=4, max_latency_ms=1.0,
                            queue_capacity=2, reject_when_full=True,
                            devices=["cpu"], start=False)
    x = np.ones((1, N_IN), np.float32)
    f1, f2 = eng.submit(x), eng.submit(x)
    with pytest.raises(InferenceBackpressure):
        eng.submit(x)
    eng.start()
    np.testing.assert_array_equal(f1.result(timeout=60), f2.result(timeout=60))
    eng.shutdown()


def test_submit_rejects_bad_rank_and_closed(net):
    eng = ParallelInference(net, devices=["cpu"])
    with pytest.raises(ValueError, match="batch dimension"):
        eng.submit(np.zeros((N_IN,), np.float32))
    eng.shutdown()
    with pytest.raises(EngineShutdown):
        eng.submit(np.zeros((1, N_IN), np.float32))


def test_worker_error_propagates_to_futures(net):
    eng = ParallelInference(net, max_batch_size=4, max_latency_ms=1.0,
                            devices=["cpu"])
    fut = eng.submit(np.ones((2, N_IN + 3), np.float32))  # wrong width
    with pytest.raises(Exception):
        fut.result(timeout=60)
    # the replica returns to the pool at its probe; the engine serves on
    good = np.ones((2, N_IN), np.float32)
    np.testing.assert_array_equal(eng.output(good, timeout=60),
                                  net.output(good))
    with pytest.raises(Exception):
        eng.shutdown()  # re-raises the first worker error


def test_shutdown_drains_in_flight(net):
    eng = ParallelInference(net, max_batch_size=8, max_latency_ms=2.0,
                            devices=CPU2)
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((1 + i % 4, N_IN)).astype(np.float32)
          for i in range(32)]
    futs = [eng.submit(x) for x in xs]
    eng.shutdown()
    for x, f in zip(xs, futs):
        assert f.result(timeout=60).shape == (x.shape[0], N_OUT)
    assert eng.stats()["requests"] == eng.stats()["resolved"] == 32


def test_shutdown_no_drain_cancels_queued(net):
    eng = ParallelInference(net, queue_capacity=8, devices=["cpu"],
                            start=False)
    futs = [eng.submit(np.zeros((1, N_IN), np.float32)) for _ in range(3)]
    eng.shutdown(drain=False)
    for f in futs:
        with pytest.raises(RuntimeError, match="shut down"):
            f.result(timeout=5)


def test_warmup_makes_every_first_dispatch(net, fresh_registry):
    """warmup dispatches every (bucket x replica) signature once; a
    ragged request mix within the buckets afterwards makes no first
    dispatch (dl4j_jit_cache_miss_total stays), as the reference's
    warmup counts its compiles."""
    net.__dict__.pop("_dispatch_sigs", None)
    reg = fresh_registry
    eng = ParallelInference(net, max_batch_size=8, max_latency_ms=1.0,
                            devices=CPU2)
    try:
        compiled = eng.warmup([(N_IN,)])
        assert compiled == len(bucket_sizes(8)) * 2  # buckets x replicas
        warm = reg.family_total(monitor.JIT_CACHE_MISS_COUNTER)
        assert warm == compiled
        assert eng.warmup([(N_IN,)]) == 0
        rng = np.random.default_rng(4)
        for n in (1, 2, 3, 4, 5, 7, 8, 6, 1, 5):
            eng.output(rng.standard_normal((n, N_IN)).astype(np.float32),
                       timeout=60)
        assert reg.family_total(monitor.JIT_CACHE_MISS_COUNTER) == warm
        assert reg.family_total(monitor.INFER_REQUESTS_COUNTER) == 10
        assert reg.family_total(monitor.INFER_BATCHES_COUNTER) >= 1
        assert eng.stats()["warmed"]
    finally:
        eng.shutdown()


def test_engine_metrics_in_prometheus_exposition(net, fresh_registry):
    eng = ParallelInference(net, max_batch_size=4, max_latency_ms=1.0,
                            devices=["cpu"])
    try:
        eng.output(np.ones((3, N_IN), np.float32), timeout=60)
    finally:
        eng.shutdown()
    text = fresh_registry.prometheus_text()
    for name in ("dl4j_infer_requests_total", "dl4j_infer_batches_total",
                 "dl4j_infer_batch_size_bucket", "dl4j_infer_queue_depth",
                 "dl4j_infer_padded_ratio", "dl4j_infer_latency_ms_bucket"):
        assert name in text, name
    assert schema.validate_prometheus_text(text) == []
    assert schema.validate_known_metrics(text) == []


def test_moe_style_models_disable_coalescing(nets):
    """A net with cross-batch statistics dispatches each request alone,
    unpadded, in both packages."""
    jn = JaxMLN(_conf(JaxNNC, JL)).init()
    tn = _carry(MultiLayerNetwork(_conf(NeuralNetConfiguration, L),
                                  device="cpu"), jn)
    jn.impls[0].batch_statistics = True
    tn.impls[0].batch_statistics = True
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((3, N_IN)).astype(np.float32) for _ in range(2)]
    for eng in (ParallelInference(tn, max_batch_size=8, max_latency_ms=10.0,
                                  devices=["cpu"]),
                jinf.ParallelInference(jn, max_batch_size=8,
                                       max_latency_ms=10.0, replicas=1)):
        try:
            assert not eng.coalesce
            for f, x in zip([eng.submit(x) for x in xs], xs):
                out = f.result(timeout=60)
                assert out.shape == (3, N_OUT)
                _close(out, tn.output(x),
                       TOL if isinstance(eng, ParallelInference) else TOL_REF)
            s = eng.stats()
            assert s["batches"] == 2 and s["rows_padded"] == 0
        finally:
            eng.shutdown()


def _graph_conf(G, NNC, Lmod):
    base = NNC(seed=3, activation="tanh", learning_rate=0.1, updater="sgd")
    return (G.builder(base).add_inputs("in")
            .add_layer("h", Lmod.DenseLayer(n_in=N_IN, n_out=8), "in")
            .add_layer("out", Lmod.OutputLayer(n_in=8, n_out=N_OUT,
                                               activation="softmax",
                                               loss_function="mcxent"), "h")
            .set_outputs("out").build())


def test_computation_graph_engine():
    from deeplearning4j_tpu_torch.nn.graph import \
        ComputationGraphConfiguration
    jg = JaxCG(_graph_conf(JaxCGC, JaxNNC, JL)).init()
    tg = ComputationGraph(ComputationGraphConfiguration.from_json(
        _graph_conf(JaxCGC, JaxNNC, JL).to_json()), device="cpu")
    _carry(tg, jg)
    x = np.random.default_rng(6).standard_normal((4, N_IN)).astype(np.float32)
    fn = tg.infer_output_fn()
    np.testing.assert_array_equal(
        fn(tg.params, tg.states, tg._tensor(x), None).numpy(), tg.output(x))
    eng = ParallelInference(tg, max_batch_size=8, max_latency_ms=2.0,
                            devices=["cpu"])
    ref = jinf.ParallelInference(jg, max_batch_size=8, max_latency_ms=2.0,
                                 replicas=1)
    try:
        out = eng.output(x, timeout=60)
        np.testing.assert_array_equal(out, tg.output(x))
        _close(out, ref.output(x, timeout=60), TOL_REF)
    finally:
        eng.shutdown()
        ref.shutdown()


def test_infer_output_fn_is_outputs_program(net, nets):
    """``infer_output_fn`` is the program ``output`` runs; a replica's
    own copy of the parameters gives the same rows."""
    x = np.random.default_rng(7).standard_normal((5, N_IN)).astype(np.float32)
    fn = net.infer_output_fn()
    copy = {k: {n: t.clone() for n, t in p.items()}
            for k, p in net.params.items()}
    got = fn(copy, net.states, net._tensor(x), None).numpy()
    np.testing.assert_array_equal(got, net.output(x))
    _close(got, np.asarray(nets[0].infer_output_fn()(
        nets[0].params, nets[0].states, x, None)), TOL_REF)


class _Poison:
    """A poison hook: replica 0 fails every dispatch while ``sick``;
    replica 1 first waits (up to 10 s) until replica 0 failed twice, so
    that two batches submitted together split between the replicas and
    replica 0's fault is seen whatever the thread timing."""

    def __init__(self):
        self.sick = True
        self.failures = 0
        self.failed_twice = threading.Event()
        self.lock = threading.Lock()

    def __call__(self, idx, shape):
        if idx == 0 and self.sick:
            with self.lock:
                self.failures += 1
                if self.failures >= 2:
                    self.failed_twice.set()
            raise RuntimeError("injected fault on replica 0")
        if idx == 1:
            self.failed_twice.wait(10.0)


@pytest.mark.parametrize("package", ["port", "reference"])
def test_quarantine_redispatch_and_probe(nets, package, fresh_registry):
    """Replica 0 fails its batch and its retry: it is quarantined, its
    batch runs on replica 1 (both callers get their rows), the engine
    reports the degraded state; a probe while still sick keeps it out,
    one when well reinstates it. The reference engine, given the same
    hook, does the same."""
    jn, tn = nets
    hook = _Poison()
    knobs = dict(max_batch_size=2, max_latency_ms=1.0, poison_hook=hook,
                 probe_interval_ms=60_000.0)
    eng = (ParallelInference(tn, devices=CPU2, **knobs) if package == "port"
           else jinf.ParallelInference(jn, replicas=2, **knobs))
    tol = TOL if package == "port" else TOL_REF
    rng = np.random.default_rng(8)
    xs = [rng.standard_normal((2, N_IN)).astype(np.float32) for _ in range(2)]
    try:
        futs = [eng.submit(x) for x in xs]
        for x, f in zip(xs, futs):
            _close(f.result(timeout=60), tn.output(x), tol)
        s = eng.stats()
        assert s["quarantined"] == [0] and s["degraded"]
        assert s["healthy_replicas"] == 1
        assert s["faults"] == 2  # the try and its retry
        if package == "port":
            assert fresh_registry.get(
                monitor.FAULT_QUARANTINED_GAUGE).value == 1
        eng.probe_now()  # still sick: stays out
        assert _spin(lambda: hook.failures >= 3)
        time.sleep(0.05)
        assert eng.stats()["quarantined"] == [0]
        hook.sick = False
        eng.probe_now()
        assert _spin(lambda: not eng.stats()["quarantined"])
        assert not eng.stats()["degraded"]
        if package == "port":
            assert fresh_registry.get(
                monitor.FAULT_QUARANTINED_GAUGE).value == 0
        _close(eng.output(xs[0], timeout=60), tn.output(xs[0]), tol)
    finally:
        eng.shutdown()


def test_no_survivor_fails_the_batch(net):
    """Every replica sick: the batch's futures carry the fault (none
    strands) and shutdown re-raises it."""
    def always(idx, shape):
        raise RuntimeError(f"injected fault on replica {idx}")

    eng = ParallelInference(net, max_batch_size=2, max_latency_ms=1.0,
                            devices=CPU2, poison_hook=always,
                            probe_interval_ms=60_000.0)
    fut = eng.submit(np.ones((2, N_IN), np.float32))
    with pytest.raises(RuntimeError, match="injected"):
        fut.result(timeout=60)
    assert _spin(lambda: eng.stats()["resolved"] == 1)
    assert eng.stats()["quarantined"] == [0, 1]
    with pytest.raises(RuntimeError, match="injected"):
        eng.shutdown()


def test_concurrent_submitters_stress(net):
    """Twice as many submitting threads as cores, a short switch
    interval and two replicas: every caller gets its own rows, and the
    engine's counts (accepted, resolved, in flight) agree after the
    drain: a lost update would break them."""
    import sys

    n = 2 * len(os.sched_getaffinity(0))
    rng = np.random.default_rng(30)
    xs = [rng.standard_normal((1 + i % 5, N_IN)).astype(np.float32)
          for i in range(n)]
    got = [None] * n
    eng = ParallelInference(net, max_batch_size=8, max_latency_ms=1.0,
                            devices=CPU2)
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def call(i):
            for _ in range(3):
                got[i] = eng.submit(xs[i]).result(timeout=60)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
        assert eng.drain(timeout=60)
    finally:
        sys.setswitchinterval(saved)
        eng.shutdown(timeout=60)
    st = eng.stats()
    assert st["requests"] == st["resolved"] == 3 * n
    assert st["inflight"] == 0 and st["queue_depth"] == 0
    for x, r in zip(xs, got):
        _close(r, net.output(x))


def test_batch_queue_is_a_fifo_that_drains_before_its_stops():
    """Formed batches come out first in, first out; a stop pill comes
    out only once no batch is left, also where a batch (a redispatch)
    is put after it."""
    q = tinf._BatchQueue()
    for tag in range(3):
        q.put(tag)
    q.put(tinf._STOP)
    q.put(3)
    assert q.qsize() == 4
    assert [q.get() for _ in range(4)] == [0, 1, 2, 3]
    assert q.get() is tinf._STOP
    with pytest.raises(queue.Empty):
        q.get_nowait()
    got = []
    t = threading.Thread(target=lambda: got.append(q.get()))
    t.start()
    q.put(7)
    t.join(10)
    assert got == [7] and q.qsize() == 0


def test_context_manager_stats_and_drain(net):
    with ParallelInference(net, devices=["cpu"]) as eng:
        futs = [eng.submit(np.ones((1, N_IN), np.float32)) for _ in range(5)]
        assert eng.drain(timeout=60)
        assert all(f.done() for f in futs)
        s = eng.stats()
        assert s["requests"] == s["resolved"] == 5
        assert s["replicas"] == 1 and s["coalesce"]
        assert eng.timeseries is eng.timeseries
    with pytest.raises(EngineShutdown):
        eng.submit(np.ones((1, N_IN), np.float32))


def test_default_devices_are_cuda_never_silently_cpu(net):
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a card: the default is every CUDA "
                    "device")
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        ParallelInference(net)


# ------------------------------------------------- the char-RNN (3-D input)

def _char_conf(NNC, Lmod):
    return (NNC.builder().seed(5).learning_rate(0.01).updater("adam")
            .list()
            .layer(Lmod.GravesLSTM(n_in=8, n_out=16, activation="tanh"))
            .layer(Lmod.RnnOutputLayer(n_in=16, n_out=8, activation="softmax",
                                       loss_function="mcxent"))
            .build())


def test_char_rnn_through_submit_matches_the_reference():
    jn = JaxMLN(_char_conf(JaxNNC, JL)).init()
    tn = _carry(MultiLayerNetwork(_char_conf(NeuralNetConfiguration, L),
                                  device="cpu"), jn)
    rng = np.random.default_rng(9)
    xs = [np.eye(8, dtype=np.float32)[rng.integers(0, 8, (n, 6))]
          for n in (1, 3, 2)]
    eng = ParallelInference(tn, max_batch_size=8, max_latency_ms=500.0,
                            devices=["cpu"], eager_when_idle=False)
    try:
        futs = [eng.submit(x) for x in xs]
        for x, f in zip(xs, futs):
            out = f.result(timeout=60)
            assert out.shape == (x.shape[0], 6, 8)
            _close(out, np.asarray(jn.output(x)), TOL_REF)
            _close(out, tn.output(x))
        assert eng.stats()["batches"] == 1  # six rows, padded to eight
    finally:
        eng.shutdown()


# ------------------------------------------------------------ generation

def test_coalesced_generate_matches_solo_and_reference(gpts):
    """Four concurrent greedy requests of one prompt bucket: one batch,
    each request's tokens those of a solo ``generate`` and of the
    reference engine; a sampled request is its solo ``generate``'s."""
    jn, tn = gpts
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, VOCAB, (1, t)) for t in (5, 6, 7, 5)]
    eng = ParallelInference(tn, max_batch_size=8, max_latency_ms=500.0,
                            devices=["cpu"], eager_when_idle=False)
    ref = jinf.ParallelInference(jn, max_batch_size=8, max_latency_ms=50.0,
                                 replicas=1, eager_when_idle=False)
    try:
        futs = [eng.submit_generate(p, 6) for p in prompts]
        want = [ref.submit_generate(p, 6) for p in prompts]
        for p, f, w in zip(prompts, futs, want):
            got = f.result(timeout=60)
            np.testing.assert_array_equal(got, generate(tn, p, 6))
            np.testing.assert_array_equal(got, w.result(timeout=120))
        assert eng.stats()["batches"] == 1
        sampled = eng.generate(prompts[0], 6, temperature=0.7, seed=3,
                               timeout=60)
        np.testing.assert_array_equal(
            sampled, generate(tn, prompts[0], 6, temperature=0.7, seed=3))
    finally:
        eng.shutdown()
        ref.shutdown()


def test_warmup_generate_then_no_first_dispatch(gpts, fresh_registry):
    tn = gpts[1]
    tn.__dict__.pop("_dispatch_sigs", None)
    eng = ParallelInference(tn, max_batch_size=4, max_latency_ms=5.0,
                            devices=CPU2)
    try:
        assert eng.warmup_generate([5, 7], 6) > 0
        assert eng.warmup_generate([5, 7], 6) == 0
        miss = fresh_registry.family_total(monitor.JIT_CACHE_MISS_COUNTER)
        rng = np.random.default_rng(11)
        futs = [eng.submit_generate(rng.integers(0, VOCAB, (n, 6)), 6)
                for n in (1, 2, 1, 3)]
        for f in futs:
            f.result(timeout=60)
        assert fresh_registry.family_total(
            monitor.JIT_CACHE_MISS_COUNTER) == miss
        assert fresh_registry.family_total(
            monitor.DECODE_REQUESTS_COUNTER) == 4
    finally:
        eng.shutdown()


def test_whole_run_streaming_is_one_terminal_chunk(gpts, fresh_registry):
    tn = gpts[1]
    p = np.random.default_rng(12).integers(0, VOCAB, (1, 5))
    chunks = []
    eng = ParallelInference(tn, devices=["cpu"])
    try:
        f = eng.submit_generate(p, 8, on_tokens=lambda o, t: chunks.append(
            (o, t.tolist())))
        want = generate(tn, p, 8)
        np.testing.assert_array_equal(f.result(timeout=60), want)
        assert _spin(lambda: len(chunks) == 1)
        assert chunks[0] == (0, want[0, 5:].tolist())
        assert fresh_registry.family_total(monitor.STREAM_CHUNKS_COUNTER) == 1
        with pytest.raises(ValueError, match="continuous"):
            eng.submit_generate(p, 8, prefix=np.asarray([1, 2]))
        with pytest.raises(ValueError, match="per-stream"):
            eng.submit_generate(np.ones((2, 4), np.int64), 4,
                                on_tokens=print)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_continuous_engine_matches_the_reference_scheduler(gpts,
                                                           prefix_cache):
    """Six requests sharing an 8-token preamble through both continuous
    engines (4 slots, bursts of 4, blocks of 4), the first alone, the
    other five at once: the same greedy tokens as the reference's engine
    and as ``generate``; with the cache on, each of the five hits it (the
    first one's retirement filled it) and fewer prefill tokens are
    computed."""
    jn, tn = gpts
    rng = np.random.default_rng(13)
    pre = rng.integers(0, VOCAB, (1, 8))
    prompts = [np.concatenate([pre, rng.integers(0, VOCAB, (1, t))], axis=1)
               for t in (2, 3, 4, 1, 2, 3)]
    knobs = dict(continuous=True, decode_slots=4, decode_burst=4,
                 kv_block_size=4, prefix_cache=prefix_cache)
    outs, stats = [], []
    for eng in (ParallelInference(tn, devices=["cpu"], **knobs),
                jinf.ParallelInference(jn, replicas=1, **knobs)):
        try:
            got = [eng.submit_generate(prompts[0], 6).result(timeout=120)]
            got += [f.result(timeout=120) for f in
                    [eng.submit_generate(p, 6) for p in prompts[1:]]]
            assert eng.drain(timeout=60)
            outs.append(got)
            stats.append(eng.stats())
        finally:
            eng.shutdown()
    for p, a, b in zip(prompts, outs[0], outs[1]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, generate(tn, p, 6))
    port, ref = stats[0]["scheduler"], stats[1]["scheduler"]
    assert stats[0]["requests"] == stats[0]["resolved"] == 6
    if prefix_cache:
        assert (port["prefix_cache"]["hits"], port["prefix_cache"]["misses"]) \
            == (ref["prefix_cache"]["hits"], ref["prefix_cache"]["misses"]) \
            == (5, 1)
        assert port["prefix_cache"]["saved_prefill_tokens"] >= 5 * 8
        assert port["prefill_tokens_computed"] < sum(p.shape[1]
                                                     for p in prompts)
    else:
        assert port["prefill_tokens_computed"] == \
            ref["prefill_tokens_computed"] == sum(p.shape[1] for p in prompts)


def test_continuous_engine_streams_and_resumes(gpts, fresh_registry):
    tn = gpts[1]
    p = np.random.default_rng(14).integers(0, VOCAB, (1, 5))
    want = generate(tn, p, 8)
    eng = ParallelInference(tn, devices=["cpu"], continuous=True,
                            decode_slots=4, decode_burst=4, kv_block_size=4)
    try:
        chunks = []
        f = eng.submit_generate(p, 8, on_tokens=lambda o, t: chunks.append(
            (o, t.tolist())))
        np.testing.assert_array_equal(f.result(timeout=60), want)
        assert len(chunks) > 1 and chunks[0][0] == 0
        toks = []
        for off, ts in chunks:
            assert off == len(toks)
            toks.extend(ts)
        assert toks == want[0, 5:].tolist()
        resumed = []
        f2 = eng.submit_generate(p, 8, prefix=want[0, 5:8],
                                 on_tokens=lambda o, t: resumed.append(
                                     (o, t.tolist())))
        np.testing.assert_array_equal(f2.result(timeout=60), want)
        assert resumed[0][0] == 3
        assert sum((ts for _, ts in resumed), []) == want[0, 8:].tolist()
        assert fresh_registry.family_total(
            monitor.STREAM_CHUNKS_COUNTER) == len(chunks) + len(resumed)
        assert eng.drain(timeout=30)
        st = eng.stats()
        assert st["requests"] == st["resolved"] == 2
        assert st["scheduler"]["pool"]["blocks_free"] == \
            st["scheduler"]["pool"]["blocks_total"]
    finally:
        eng.shutdown()


def test_warmup_generate_continuous_with_cache(gpts, fresh_registry):
    """warmup_generate warms the scheduler's set, the prefix cache's
    block copy and tail-prefill ladders included: cached admissions then
    make no first dispatch."""
    tn = gpts[1]
    tn.__dict__.pop("_dispatch_sigs", None)
    eng = ParallelInference(tn, devices=["cpu"], continuous=True,
                            decode_slots=4, decode_burst=4, kv_block_size=4,
                            prefix_cache=True)
    try:
        assert eng.warmup_generate([4, 8], 8) > 0
        assert eng.stats()["scheduler"]["warmed"]
        miss0 = fresh_registry.family_total(monitor.JIT_CACHE_MISS_COUNTER)
        rng = np.random.default_rng(15)
        shared = rng.integers(0, VOCAB, (1, 5))
        p0 = np.concatenate([shared, rng.integers(0, VOCAB, (1, 3))], axis=1)
        eng.submit_generate(p0, 6, seed=0).result(60)
        futs = [eng.submit_generate(np.concatenate(
            [shared, rng.integers(0, VOCAB, (1, 3))], axis=1), 6, seed=i)
            for i in range(1, 4)]
        for f in futs:
            f.result(60)
        assert fresh_registry.family_total(
            monitor.JIT_CACHE_MISS_COUNTER) == miss0
        assert eng.stats()["scheduler"]["prefix_cache"]["hits"] >= 1
    finally:
        eng.shutdown()


# ------------------------------------------------- left for later slices

@pytest.mark.parametrize("kw, item", [
    (dict(registry=object()), "A10b"), (dict(max_sessions=8), "A10b"),
    (dict(speculative=True), "A10b"), (dict(draft_net=object()), "A10b"),
    (dict(kv_host_blocks=8), "A10b"), (dict(slice_plane=object()), "A9")])
def test_later_engine_knobs_raise(net, kw, item):
    with pytest.raises(NotImplementedError, match=item):
        ParallelInference(net, devices=["cpu"], **kw)


@pytest.mark.parametrize("call, item", [
    (lambda e: e.submit_generate(np.ones((1, 4), np.int64), 2,
                                 session="s"), "A10b"),
    (lambda e: e.submit_generate(np.ones((1, 4), np.int64), 2,
                                 hibernate=True), "A10b"),
    (lambda e: e.submit_generate(np.ones((1, 4), np.int64), 2,
                                 kv_state={}), "A11"),
    (lambda e: e.hibernate_export("s"), "A10b"),
    (lambda e: e.hibernate_import("s", [], 0, []), "A10b"),
    (lambda e: e.hibernate_release("s"), "A10b"),
    (lambda e: e.warmup_model("lm"), "A10b"),
    (lambda e: e.prefill_export(np.ones((1, 4), np.int64)), "A11"),
    (lambda e: e.warmup_prefill([4]), "A11"),
    (lambda e: e.release_session("s"), "A10b")])
def test_later_engine_calls_raise(gpts, call, item):
    eng = ParallelInference(gpts[1], devices=["cpu"], continuous=True,
                            decode_slots=4, decode_burst=4, kv_block_size=4)
    try:
        with pytest.raises(NotImplementedError, match=item):
            call(eng)
        assert eng.hibernated_count() == 0
        with pytest.raises(ValueError, match="registry"):
            eng.submit(np.ones((1, 4), np.float32), model="lm")
    finally:
        eng.shutdown()


def test_engine_knob_errors_are_the_references(net):
    for kw in (dict(prefix_cache=True), dict(kv_quant="int8"),
               dict(kv_bytes_budget=1 << 20)):
        with pytest.raises(ValueError, match="continuous=True"):
            ParallelInference(net, devices=["cpu"], **kw)
    with pytest.raises(ValueError, match="max_batch_size"):
        ParallelInference(net, devices=["cpu"], max_batch_size=0)
    with pytest.raises(ValueError, match="needs a net"):
        ParallelInference(devices=["cpu"])
