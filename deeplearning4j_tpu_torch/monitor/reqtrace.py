"""End-to-end request tracing for the serving plane.

Counterpart of ``deeplearning4j_tpu/monitor/reqtrace.py``. In the port
the decode scheduler (``serving/continuous.py``) roots a trace per
request; the router, wire and engine hops below come with ROADMAP
A10-A11. :mod:`tracing` gives *process-local* phase spans on one clock;
the serving system built since (router → wire → EngineWorker →
ParallelInference → ContinuousDecodeScheduler) crosses processes, so a
request's timeline needs the Dapper discipline: a **trace id** minted
at router admission, a **span stack** whose context PROPAGATES across
every hop (an optional ``trace`` field in ``serving/wire.py`` request
headers — ignored by older consumers, version-skew safe), and
**post-hoc span records** built from host-side timestamps the hot path
already takes, so tracing adds no device syncs and no dispatch-path
work beyond a few dict appends.

The pieces:

- :class:`TraceContext` — ``(trace_id, span_id)``, the unit that rides
  thread-locals in process (:func:`use_trace` / :func:`current_trace`)
  and the wire header across processes (:meth:`TraceContext.wire` /
  :func:`from_wire`);
- :class:`RequestTracer` — the bounded per-process collector: open
  spans (:func:`begin_trace` roots, :func:`start_span` children),
  post-hoc records (:func:`record_span` from timestamps already in
  hand), per-trace buffers with hard span caps, and a completed-trace
  ring. Every recorded span also feeds the
  ``dl4j_req_phase_ms{phase=<name>}`` histogram — the SLO-attribution
  half works even when nobody reads the raw spans;
- :class:`FlightRecorder` — the bounded ring of recent completed
  traces plus structured events (ejections, quarantines, rollbacks,
  slice death). ``dump()`` writes JSONL
  (``scripts/check_telemetry_schema.py`` validates it);
  :func:`flight_trigger` dumps automatically when a ``dump_dir`` is
  configured — the crash-cart an operator reads after an ejection or
  a chaos-drill invariant failure, and what ``UiServer
  /debug/traces`` serves live.

Sampling: ``enable_request_tracing(sample=...)`` admits a
low-discrepancy fraction of roots; an unsampled request costs one
counter increment and every downstream call no-ops on its ``None``
context. With tracing disabled entirely, every entry point returns
``None`` immediately.

Span record schema (one JSON object per span, ``type: "reqspan"``)::

    {"type": "reqspan", "trace": "…", "span": "<pid>-<n>",
     "parent": "<pid>-<m>" | null, "name": "dispatch",
     "ts_us": 123.4, "dur_us": 56.7, "pid": 4242, "tid": 1,
     "attrs": {...}}          # attrs optional

``ts_us`` is microseconds on THIS process's monotonic origin
(``tracing.now_us`` clock); cross-process merges therefore compare
timestamps only within one pid — exactly what the schema checker's
per-process monotonicity rule enforces.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.monitor.registry import get_registry
from deeplearning4j_tpu_torch.monitor.tracing import now_us, to_origin_us

REQ_PHASE_HISTOGRAM = "dl4j_req_phase_ms"
TRACE_SPANS_COUNTER = "dl4j_trace_spans_total"
TRACE_DROPPED_COUNTER = "dl4j_trace_dropped_total"
TRACE_ACTIVE_GAUGE = "dl4j_trace_active"
TRACE_FLIGHT_DUMPS_COUNTER = "dl4j_trace_flight_dumps_total"

_PHASE_HELP = ("Per-request phase durations from the request traces "
               "(TTFT/TPOT decomposition)")


class TraceContext:
    """One node of a request's span tree: enough to parent a child
    span from anywhere — another thread, another process."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def wire(self) -> Dict[str, str]:
        """The header-safe encoding (rides ``trace`` in wire requests;
        plain JSON strings, ignored by consumers that predate it)."""
        return {"id": self.trace_id, "span": self.span_id}

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id!r}, {self.span_id!r})"


def from_wire(obj: Any) -> Optional[TraceContext]:
    """Rebuild a propagated context from a wire header's ``trace``
    field; None for anything malformed (a bad trace field must never
    fail the request it rides on)."""
    if not isinstance(obj, dict):
        return None
    tid, sid = obj.get("id"), obj.get("span")
    if not isinstance(tid, str) or not isinstance(sid, str):
        return None
    return TraceContext(tid, sid)


class _OpenSpan:
    """A span whose id exists NOW (children can parent to it) but whose
    record lands when it closes. Context-manager friendly."""

    __slots__ = ("ctx", "name", "attrs", "_t0", "_tracer", "_closed")

    def __init__(self, tracer: "RequestTracer", ctx: TraceContext,
                 name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.ctx = ctx
        self.name = name
        self.attrs = dict(attrs)
        self._t0 = time.perf_counter()
        self._closed = False

    def close(self, **attrs) -> None:
        if self._closed:
            return
        self._closed = True
        if attrs:
            self.attrs.update(attrs)
        self._tracer._record(self.ctx.trace_id, self.ctx.span_id,
                             None, self.name, to_origin_us(self._t0),
                             (time.perf_counter() - self._t0) * 1e6,
                             self.attrs, parent_known=True)

    def __enter__(self) -> "_OpenSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(**({"error": exc_type.__name__} if exc_type else {}))


class RequestTracer:
    """Bounded per-process request-span collector.

    Knobs: ``sample`` admits that fraction of new roots
    (low-discrepancy, deterministic per process); ``max_traces`` bounds
    concurrently-open trace buffers (oldest evicted, counted dropped —
    a remote worker accumulating orphan buffers for traces whose roots
    live elsewhere is bounded by the same cap); ``max_spans_per_trace``
    hard-caps one trace's memory; ``completed_capacity`` bounds the
    finished-trace ring :meth:`completed_trace` serves."""

    def __init__(self, sample: float = 1.0, max_traces: int = 1024,
                 max_spans_per_trace: int = 512,
                 completed_capacity: int = 256):
        self.sample = min(1.0, max(0.0, float(sample)))
        self.max_traces = max(1, int(max_traces))
        self.max_spans = max(8, int(max_spans_per_trace))
        self.completed_capacity = max(1, int(completed_capacity))
        self._pid = os.getpid()
        self._lock = threading.Lock()
        self._ids = 0
        self._roots = 0
        self._open_parents: Dict[str, set] = {}
        self._traces: "OrderedDict[str, List[Dict]]" = OrderedDict()
        self._completed: "OrderedDict[str, Dict]" = OrderedDict()
        self.dropped = 0

    # ------------------------------------------------------------- ids

    def _next_id(self) -> str:
        with self._lock:
            self._ids += 1
            return f"{self._pid:x}-{self._ids:x}"

    def _sampled(self) -> bool:
        with self._lock:
            self._roots += 1
            n = self._roots
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        # golden-ratio low-discrepancy sequence: deterministic per
        # process, uniform at any rate, no RNG state to seed
        return (n * 0.6180339887498949) % 1.0 < self.sample

    # ---------------------------------------------------------- record

    def _record(self, trace_id: str, span_id: str,
                parent: Optional[str], name: str, ts_us: float,
                dur_us: float, attrs: Dict[str, Any],
                parent_known: bool = False) -> None:
        rec: Dict[str, Any] = {
            "type": "reqspan", "trace": trace_id, "span": span_id,
            "parent": parent, "name": name, "ts_us": round(ts_us, 3),
            "dur_us": round(max(0.0, dur_us), 3), "pid": self._pid,
            "tid": threading.get_ident()}
        if attrs:
            rec["attrs"] = attrs
        reg = get_registry()
        with self._lock:
            buf = self._traces.get(trace_id)
            if buf is None:
                if len(self._traces) >= self.max_traces:
                    _, evicted = self._traces.popitem(last=False)
                    self.dropped += len(evicted)
                buf = self._traces[trace_id] = []
            if len(buf) >= self.max_spans:
                self.dropped += 1
                reg.counter(TRACE_DROPPED_COUNTER,
                            "Request-trace spans dropped (bounded "
                            "buffers / evicted orphan traces)").inc()
                return
            if parent_known and rec["parent"] is None:
                # open spans learn their parent from the open-span
                # registry (the id was allocated before the record)
                rec["parent"] = self._open_parent(trace_id, span_id)
            buf.append(rec)
        reg.counter(TRACE_SPANS_COUNTER,
                    "Request-trace spans recorded").inc()
        try:
            reg.histogram(REQ_PHASE_HISTOGRAM, _PHASE_HELP,
                          phase=name).observe(rec["dur_us"] / 1e3)
        except Exception:
            pass  # telemetry must never break the serving loop

    def _open_parent(self, trace_id: str, span_id: str) -> Optional[str]:
        return self._parents.get((trace_id, span_id))

    # open-span parents: span ids exist before their record lands, so
    # the parent edge is remembered at start time and resolved at close
    @property
    def _parents(self) -> Dict:
        p = getattr(self, "_parent_map", None)
        if p is None:
            p = self._parent_map = {}
        return p

    # ------------------------------------------------------------- api

    def begin_trace(self, name: str = "request",
                    **attrs) -> Optional[_OpenSpan]:
        """Mint a new trace and open its root span; None when this
        request fell outside the sampling fraction."""
        if not self._sampled():
            return None
        trace_id = f"t{self._next_id()}"
        ctx = TraceContext(trace_id, self._next_id())
        get_registry().gauge(
            TRACE_ACTIVE_GAUGE,
            "Request traces currently open in this process"
        ).set(len(self._traces) + 1)
        return _OpenSpan(self, ctx, name, attrs)

    def start_span(self, name: str, parent: Optional[TraceContext],
                   **attrs) -> Optional[_OpenSpan]:
        """Open a child span (id usable as a parent immediately; the
        record lands on ``close``). No-op on a None parent."""
        if parent is None:
            return None
        ctx = TraceContext(parent.trace_id, self._next_id())
        with self._lock:
            self._parents[(ctx.trace_id, ctx.span_id)] = parent.span_id
            # keep the edge map bounded alongside the trace buffers
            if len(self._parents) > self.max_traces * 64:
                self._parent_map = dict(
                    list(self._parents.items())[-self.max_traces * 8:])
        return _OpenSpan(self, ctx, name, attrs)

    def record_span(self, parent: Optional[TraceContext], name: str,
                    t0_us: float, dur_us: float,
                    **attrs) -> Optional[TraceContext]:
        """Record a COMPLETED span from timestamps the caller already
        holds — the post-hoc path the dispatch loops use (no extra
        clock reads on the hot path). Returns the new span's context so
        later spans can parent to it."""
        if parent is None:
            return None
        ctx = TraceContext(parent.trace_id, self._next_id())
        self._record(parent.trace_id, ctx.span_id, parent.span_id,
                     name, t0_us, dur_us, attrs)
        return ctx

    def event(self, parent: Optional[TraceContext], name: str,
              **attrs) -> None:
        """Zero-duration annotation span (preemption, hedge, shed)."""
        if parent is None:
            return
        self._record(parent.trace_id, self._next_id(), parent.span_id,
                     name, now_us(), 0.0, attrs)

    def finish_trace(self, root: Optional[_OpenSpan],
                     **attrs) -> Optional[List[Dict[str, Any]]]:
        """Close the root span and seal the trace: its span list moves
        to the completed ring (and the flight recorder) and is
        returned for immediate attribution."""
        if root is None:
            return None
        root.close(**attrs)
        with self._lock:
            spans = self._traces.pop(root.ctx.trace_id, [])
            entry = self._completed[root.ctx.trace_id] = {
                "trace": root.ctx.trace_id, "root": root.ctx.span_id,
                "name": root.name, "spans": spans,
                "attrs": dict(root.attrs)}
            while len(self._completed) > self.completed_capacity:
                self._completed.popitem(last=False)
            for key in [k for k in self._parents
                        if k[0] == root.ctx.trace_id]:
                self._parents.pop(key, None)
            open_traces = len(self._traces)
        get_registry().gauge(
            TRACE_ACTIVE_GAUGE,
            "Request traces currently open in this process"
        ).set(open_traces)
        fr = _flight
        if fr is not None:
            fr.note_trace(entry)
        return spans

    # ------------------------------------------------------------- read

    def completed_trace(self, trace_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            entry = self._completed.get(trace_id)
            return None if entry is None else {
                **entry, "spans": list(entry["spans"])}

    def completed_traces(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{**e, "spans": list(e["spans"])}
                    for e in self._completed.values()]

    def open_spans(self, trace_id: str) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._traces.get(trace_id, []))


class FlightRecorder:
    """Bounded ring of recent completed traces + structured events —
    the post-incident evidence locker. ``dump_dir`` arms automatic
    JSONL dumps on :meth:`trigger` (endpoint ejection, chaos-drill
    invariant failure); without it, triggers only count."""

    def __init__(self, capacity_traces: int = 256,
                 capacity_events: int = 2048,
                 dump_dir: Optional[str] = None):
        self._traces: deque = deque(maxlen=max(1, int(capacity_traces)))
        self._events: deque = deque(maxlen=max(1, int(capacity_events)))
        self.dump_dir = dump_dir
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._dumps = 0

    def note_trace(self, entry: Dict[str, Any]) -> None:
        with self._lock:
            self._traces.append(entry)

    def note_event(self, kind: str, **attrs) -> None:
        """Structured non-request event: ejection, quarantine,
        rollback, wedge, slice death/rebuild, migration."""
        rec = {"type": "flight_event", "kind": str(kind),
               "ts_us": round(now_us(), 3), "pid": self._pid}
        if attrs:
            rec["attrs"] = {k: v for k, v in attrs.items()}
        with self._lock:
            self._events.append(rec)

    def records(self) -> List[Dict[str, Any]]:
        """Every ring entry as JSONL-ready dicts: events first (their
        own timeline), then one ``type: "trace"`` record per trace."""
        with self._lock:
            events = list(self._events)
            traces = list(self._traces)
        out: List[Dict[str, Any]] = list(events)
        for t in traces:
            out.append({"type": "trace", "trace": t["trace"],
                        "root": t["root"], "name": t["name"],
                        "attrs": t.get("attrs") or {},
                        "spans": list(t["spans"])})
        return out

    def dump(self, path: Optional[str] = None) -> str:
        """Write the rings as JSONL; returns the path written."""
        if path is None:
            base = self.dump_dir or "."
            os.makedirs(base, exist_ok=True)
            with self._lock:
                self._dumps += 1
                n = self._dumps
            path = os.path.join(
                base, f"flight-{self._pid}-{n:04d}.jsonl")
        with open(path, "w") as f:
            for rec in self.records():
                f.write(json.dumps(rec) + "\n")
        return path

    def trigger(self, reason: str, **attrs) -> Optional[str]:
        """An operator-significant condition fired: record it, count
        it, and dump the rings when a ``dump_dir`` is armed. Returns
        the dump path (None when dumping is not configured)."""
        self.note_event("trigger", reason=reason, **attrs)
        get_registry().counter(
            TRACE_FLIGHT_DUMPS_COUNTER,
            "Flight-recorder triggers (ejections, invariant failures); "
            "each dumps the trace/event rings when a dump_dir is armed",
            reason=str(reason)).inc()
        if self.dump_dir is None:
            return None
        try:
            return self.dump()
        except Exception:
            return None  # a full disk must not take the router down


# --------------------------------------------------------- module state

_active: Optional[RequestTracer] = None
_flight: Optional[FlightRecorder] = None
_state_lock = threading.Lock()
_tls = threading.local()
# sustained-SLO-burn auto-trigger: (threshold, window_s, cooldown_s)
# when armed via configure_flight_recorder(burn_threshold=...), plus
# the monotonic timestamp of the last slo_burn trigger (the cooldown)
_burn_cfg: Optional[Tuple[int, float, float]] = None
_burn_last: Optional[float] = None


def enable_request_tracing(sample: float = 1.0, max_traces: int = 1024,
                           max_spans_per_trace: int = 512,
                           completed_capacity: int = 256
                           ) -> RequestTracer:
    """Install the process-wide request tracer (replacing any previous
    one) and make sure a flight recorder exists to catch completions."""
    global _active
    tracer = RequestTracer(sample, max_traces, max_spans_per_trace,
                           completed_capacity)
    with _state_lock:
        _active = tracer
    flight_recorder()
    return tracer


def disable_request_tracing() -> Optional[RequestTracer]:
    global _active
    with _state_lock:
        old, _active = _active, None
    return old


def set_request_tracer(tracer: Optional[RequestTracer]
                       ) -> Optional[RequestTracer]:
    """Install (or restore) a specific tracer; returns the previous
    one — the save/restore seam drills and tests use."""
    global _active
    with _state_lock:
        old, _active = _active, tracer
    return old


def request_tracer() -> Optional[RequestTracer]:
    return _active


def flight_recorder() -> FlightRecorder:
    """The process-wide flight recorder (created on first use — events
    are recorded even while request tracing is off)."""
    global _flight
    with _state_lock:
        if _flight is None:
            _flight = FlightRecorder()
        return _flight


def configure_flight_recorder(dump_dir: Optional[str] = None,
                              capacity_traces: int = 256,
                              capacity_events: int = 2048,
                              burn_threshold: Optional[int] = None,
                              burn_window_s: float = 60.0,
                              burn_cooldown_s: float = 60.0
                              ) -> FlightRecorder:
    """Replace the process-wide flight recorder (arming ``dump_dir``
    makes every :func:`flight_trigger` dump JSONL there).

    ``burn_threshold`` arms the sustained-SLO-burn auto-trigger: when
    :func:`note_slo_burn` sees at least that many burned requests
    (missed/shed/failed) inside the trailing ``burn_window_s`` of the
    ``dl4j_ts_slo_burn`` time series, the recorder fires a
    ``slo_burn`` trigger (dumping the rings when ``dump_dir`` is
    armed), then holds for ``burn_cooldown_s`` so a sustained incident
    yields one dump per cooldown, not one per miss. ``None`` (the
    default) disables the auto-trigger."""
    global _flight, _burn_cfg, _burn_last
    with _state_lock:
        _flight = FlightRecorder(capacity_traces, capacity_events,
                                 dump_dir)
        if burn_threshold is None:
            _burn_cfg = None
        else:
            _burn_cfg = (max(1, int(burn_threshold)),
                         max(1e-9, float(burn_window_s)),
                         max(0.0, float(burn_cooldown_s)))
        _burn_last = None
        return _flight


def flight_event(kind: str, **attrs) -> None:
    flight_recorder().note_event(kind, **attrs)


def flight_trigger(reason: str, **attrs) -> Optional[str]:
    return flight_recorder().trigger(reason, **attrs)


def note_slo_burn(outcome: str, model: Optional[str] = None
                  ) -> Optional[str]:
    """One SLO-burning request outcome happened (the router calls this
    AFTER recording the ``dl4j_ts_slo_burn`` sample). When the burn
    auto-trigger is armed and the trailing-window burn count crosses
    the threshold outside the cooldown, fire the ``slo_burn`` flight
    trigger; returns the dump path when one was written."""
    cfg = _burn_cfg
    if cfg is None:
        return None
    threshold, window_s, cooldown_s = cfg
    from deeplearning4j_tpu_torch.monitor.timeseries import TS_SLO_BURN, ts_query
    q = ts_query(TS_SLO_BURN, window_s)
    burned = int(q["count"]) if q else 0
    if burned < threshold:
        return None
    global _burn_last
    now = time.monotonic()
    with _state_lock:
        if _burn_last is not None and now - _burn_last < cooldown_s:
            return None
        _burn_last = now
    return flight_trigger(
        "slo_burn", outcome=str(outcome),
        model=model if model is not None else "default",
        burned=burned, window_s=window_s, threshold=threshold)


# ------------------------------------------------- context propagation

class _UseTrace:
    __slots__ = ("ctx", "_prev")

    def __init__(self, ctx: Optional[TraceContext]):
        self.ctx = ctx
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = self.ctx
        return self.ctx

    def __exit__(self, exc_type, exc, tb):
        _tls.ctx = self._prev


def use_trace(ctx: Optional[TraceContext]) -> _UseTrace:
    """Install ``ctx`` as the calling thread's current trace context
    for the with-block — the OpenTelemetry-style implicit propagation
    that lets an engine behind ANY call path (local endpoint, wire
    worker) pick the context up at submit time without every SPI layer
    growing a ``trace=`` parameter."""
    return _UseTrace(ctx)


def current_trace() -> Optional[TraceContext]:
    if _active is None:
        return None
    return getattr(_tls, "ctx", None)


# ------------------------------------------------- convenience wrappers

def begin_trace(name: str = "request", **attrs) -> Optional[_OpenSpan]:
    t = _active
    return None if t is None else t.begin_trace(name, **attrs)


def start_span(name: str, parent: Optional[TraceContext],
               **attrs) -> Optional[_OpenSpan]:
    t = _active
    if t is None or parent is None:
        return None
    return t.start_span(name, parent, **attrs)


def record_span(parent: Optional[TraceContext], name: str,
                t0_us: float, dur_us: float,
                **attrs) -> Optional[TraceContext]:
    t = _active
    if t is None or parent is None:
        return None
    return t.record_span(parent, name, t0_us, dur_us, **attrs)


def trace_event(parent: Optional[TraceContext], name: str,
                **attrs) -> None:
    t = _active
    if t is not None and parent is not None:
        t.event(parent, name, **attrs)


def finish_trace(root: Optional[_OpenSpan],
                 **attrs) -> Optional[List[Dict[str, Any]]]:
    if root is None:
        return None
    # always finish against the tracer that opened the root — a tracer
    # swapped mid-request still seals its own in-flight traces
    return root._tracer.finish_trace(root, **attrs)
