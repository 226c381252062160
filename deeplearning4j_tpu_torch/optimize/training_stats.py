"""Per-phase training timings.

Counterpart of ``deeplearning4j_tpu/optimize/training_stats.py``: time
named phases of a training loop (``with stats.time("step"): ...`` or
``add(phase, ms)``), aggregate them (count, total, mean, min, max),
keep a timeline, fold in another worker's stats (``merge``) and export
JSON or a Chrome ``trace_event`` view. The reference takes its time
origin from its ``monitor`` spans so that both timelines align; the
port's ``monitor`` waits for ROADMAP A12, so the origin is this
module's, taken at import.

Usage::

    stats = TrainingStats()
    with stats.time("step"):
        ...
    stats.summary()   # {"step": {"count": ..., "mean_ms": ...}, ...}
    stats.export_json(path)
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

_ORIGIN = time.perf_counter()


class TrainingStats:
    def __init__(self, keep_timeline: bool = True, max_events: int = 100_000):
        self.keep_timeline = keep_timeline
        self.max_events = max_events
        self._origin = _ORIGIN
        # phase -> [count, total_ms, min_ms, max_ms]
        self._agg: Dict[str, List[float]] = {}
        # (phase, start_ms_since_origin, duration_ms)
        self._events: List[Tuple[str, float, float]] = []

    def add(self, phase: str, duration_ms: float,
            start_ms: Optional[float] = None) -> None:
        agg = self._agg.get(phase)
        if agg is None:
            self._agg[phase] = [1, duration_ms, duration_ms, duration_ms]
        else:
            agg[0] += 1
            agg[1] += duration_ms
            agg[2] = min(agg[2], duration_ms)
            agg[3] = max(agg[3], duration_ms)
        if self.keep_timeline and len(self._events) < self.max_events:
            if start_ms is None:
                start_ms = (time.perf_counter() - self._origin) * 1e3 - duration_ms
            self._events.append((phase, start_ms, duration_ms))

    @contextmanager
    def time(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.add(phase, (t1 - t0) * 1e3,
                     start_ms=(t0 - self._origin) * 1e3)

    def phases(self) -> List[str]:
        return sorted(self._agg)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {phase: {"count": int(c), "total_ms": tot, "mean_ms": tot / c,
                        "min_ms": lo, "max_ms": hi}
                for phase, (c, tot, lo, hi) in sorted(self._agg.items())}

    def timeline(self) -> List[Dict[str, Any]]:
        return [{"phase": p, "start_ms": s, "duration_ms": d}
                for p, s, d in self._events]

    def to_dict(self) -> Dict[str, Any]:
        return {"summary": self.summary(), "timeline": self.timeline()}

    def export_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path

    def chrome_trace(self) -> Dict[str, Any]:
        """The phase timeline as Chrome ``trace_event`` JSON (Perfetto
        opens it)."""
        pid = os.getpid()
        events: List[Dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": "TrainingStats phases"}}]
        for p, s, d in self._events:
            events.append({"name": p, "cat": "phase", "ph": "X", "pid": pid,
                           "tid": 0, "ts": s * 1e3, "dur": d * 1e3,
                           "args": {}})
        return {"displayTimeUnit": "ms", "traceEvents": events}

    def export_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def merge(self, other: "TrainingStats", prefix: str = "") -> None:
        """Fold another process's or worker's stats in; ``prefix``
        names its phases apart (e.g. "worker3/")."""
        for phase, (c, tot, lo, hi) in other._agg.items():
            key = prefix + phase
            agg = self._agg.get(key)
            if agg is None:
                self._agg[key] = [c, tot, lo, hi]
            else:
                agg[0] += c
                agg[1] += tot
                agg[2] = min(agg[2], lo)
                agg[3] = max(agg[3], hi)
        if self.keep_timeline:
            for p, s, d in other._events:
                if len(self._events) >= self.max_events:
                    break
                self._events.append((prefix + p, s, d))

    def __repr__(self) -> str:
        rows = ", ".join(f"{p}: {v['count']}x mean {v['mean_ms']:.2f}ms"
                         for p, v in self.summary().items())
        return f"TrainingStats({rows})"
