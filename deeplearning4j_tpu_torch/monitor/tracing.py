"""Span-based phase tracing: one clock, JSONL events, Perfetto export.

Counterpart of ``deeplearning4j_tpu/monitor/tracing.py``. Every
host-side phase is a ``span("device_step")`` against one process-wide
monotonic origin (``_ORIGIN``, shared with
``optimize/training_stats.py``), so data load, steps, checkpoints and
evaluation compose into one timeline:

- every span closes into the registry histogram
  ``dl4j_phase_duration_ms{phase=...}`` (always on, microseconds a
  span);
- with a tracer enabled (``enable_tracing``), spans also append
  structured JSONL events (``scripts/check_telemetry_schema.py``
  validates the stream) and buffer for Chrome ``trace_event`` export,
  which Perfetto opens beside ``util/profiler.py``'s device traces.

**What a span times.** The port runs eagerly: a step's kernels are
queued on the card's stream and the host returns before they finish.
A span around a step (``compile``, ``device_step``, ``inference``)
therefore times the host's enqueue of that work, as the reference's
times its XLA dispatch; it includes the card's time only where the
path already waits on the card inside it (a score fetch, a burst's
token fetch). No span waits on the card itself, and tracing on or off
computes the same results.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.monitor.registry import get_registry

# The single process clock origin: every span/event timestamp is
# microseconds since this module first loaded. util/profiler.py device
# traces carry their own epoch; Perfetto aligns tracks per file.
_ORIGIN = time.perf_counter()

PHASE_HISTOGRAM = "dl4j_phase_duration_ms"
_PHASE_HELP = "Host-side phase durations by span name"


def now_us() -> float:
    """Microseconds since the process clock origin (one clock for every
    telemetry consumer in this process)."""
    return (time.perf_counter() - _ORIGIN) * 1e6


def to_origin_us(perf_t: float) -> float:
    """Convert a raw ``time.perf_counter()`` reading to microseconds on
    the process clock origin — lets callers that already hold host-side
    timestamps (request submit times, dispatch starts) emit spans
    post-hoc without re-reading the clock."""
    return (perf_t - _ORIGIN) * 1e6


class _Span:
    """Context manager for one phase occurrence. Reusable via ``span()``;
    cheap: two perf_counter reads + one histogram observe, plus a JSONL
    line when a tracer is active."""

    __slots__ = ("name", "attrs", "_t0", "_tracer")

    def __init__(self, name: str, tracer: Optional["PhaseTracer"],
                 attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self._tracer = tracer
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.perf_counter()
        dur_us = (t1 - self._t0) * 1e6
        if exc_type is not None:
            self.attrs = {**self.attrs, "error": exc_type.__name__}
        try:
            get_registry().histogram(
                PHASE_HISTOGRAM, _PHASE_HELP,
                phase=self.name).observe(dur_us / 1e3)
        except Exception:
            pass  # telemetry must never break the training loop
        if self._tracer is not None:
            self._tracer._record_span(
                self.name, (self._t0 - _ORIGIN) * 1e6, dur_us, self.attrs)


class PhaseTracer:
    """Collects span/event records; writes JSONL as they close and
    exports the buffered timeline as Chrome ``trace_event`` JSON."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 max_events: int = 1_000_000):
        self.jsonl_path = jsonl_path
        self.max_events = max_events
        self.dropped = 0
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._file = open(jsonl_path, "a") if jsonl_path else None
        self._pid = os.getpid()

    # ------------------------------------------------------------ record

    def _emit(self, record: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) < self.max_events:
                self._events.append(record)
            else:
                self.dropped += 1  # never silently pretend full coverage
            if self._file is not None:
                self._file.write(json.dumps(record) + "\n")
                self._file.flush()

    def _record_span(self, name: str, ts_us: float, dur_us: float,
                     attrs: Dict[str, Any]) -> None:
        rec = {"type": "span", "name": name, "ts_us": round(ts_us, 3),
               "dur_us": round(dur_us, 3), "pid": self._pid,
               "tid": threading.get_ident()}
        if attrs:
            rec["attrs"] = attrs
        self._emit(rec)

    def event(self, name: str, **attrs) -> None:
        """Instant event (NaN flag, averaging boundary, ...)."""
        rec = {"type": "event", "name": name, "ts_us": round(now_us(), 3),
               "pid": self._pid, "tid": threading.get_ident()}
        if attrs:
            rec["attrs"] = attrs
        self._emit(rec)

    # ------------------------------------------------------------ export

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome ``trace_event`` JSON object (Perfetto/chrome://tracing).
        Spans are complete events (ph=X), instant events ph=i."""
        trace: List[Dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": self._pid, "tid": 0,
             "args": {"name": "deeplearning4j_tpu_torch host"}}]
        for e in self.events():
            base = {"name": e["name"], "cat": "phase", "pid": e["pid"],
                    "tid": e["tid"], "ts": e["ts_us"],
                    "args": e.get("attrs", {})}
            if e["type"] == "span":
                trace.append({**base, "ph": "X", "dur": e["dur_us"]})
            else:
                trace.append({**base, "ph": "i", "s": "t"})
        return {"displayTimeUnit": "ms", "traceEvents": trace}

    def export_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


# ------------------------------------------------------------ module API

_active: Optional[PhaseTracer] = None
_active_lock = threading.Lock()
_NO_ATTRS: Dict[str, Any] = {}


def enable_tracing(jsonl_path: Optional[str] = None,
                   max_events: int = 1_000_000) -> PhaseTracer:
    """Install a process-wide tracer; returns it. Replaces (and closes)
    any previous tracer."""
    global _active
    tracer = PhaseTracer(jsonl_path, max_events=max_events)
    with _active_lock:
        old, _active = _active, tracer
    if old is not None:
        old.close()
    return tracer


def disable_tracing() -> Optional[PhaseTracer]:
    """Stop tracing; returns the (closed) tracer so callers can still
    export its buffered timeline."""
    global _active
    with _active_lock:
        old, _active = _active, None
    if old is not None:
        old.close()
    return old


def active_tracer() -> Optional[PhaseTracer]:
    return _active


def span(name: str, **attrs) -> _Span:
    """Time a host-side phase::

        with span("device_step", iteration=i):
            ...

    Always feeds ``dl4j_phase_duration_ms{phase=name}``; with tracing
    enabled, also emits a JSONL/Perfetto span. Exceptions propagate (the
    span closes with an ``error`` attr)."""
    return _Span(name, _active, attrs if attrs else _NO_ATTRS)


def mark(name: str, **attrs) -> None:
    """Instant event into the active tracer (no-op when tracing is off)."""
    t = _active
    if t is not None:
        t.event(name, **attrs)
