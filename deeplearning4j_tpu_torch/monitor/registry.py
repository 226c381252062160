"""Process-wide metrics registry: counters, gauges, histograms.

Counterpart of ``deeplearning4j_tpu/monitor/registry.py``, with the same
names, kinds and output text: one process-wide sink every telemetry
producer (listeners, phase spans, watchdogs, the serving planes)
publishes into, rendered as the Prometheus text exposition format
(``prometheus_text``, what a ``/metrics`` endpoint serves) and as a
JSON snapshot. Label values are escaped as the format asks (backslash,
double quote, newline), HELP text as its own rule asks (backslash,
newline).

Every metric op is a dict lookup and a few float ops under a lock:
microseconds, safe inside the host's step loop. No background threads.
A gauge set from a tensor on the card keeps the tensor and reads it
when the gauge is read (an exposition, a snapshot), so setting it never
makes the host wait on the card.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# Bucket upper bounds (ms) for duration histograms: host-loop phases span
# ~0.1ms (no-op staging) to minutes (checkpoint of a sharded model).
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """HELP-text escaping per the text-format spec: only backslash and
    newline (quotes stay literal in HELP lines, unlike label values)."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Counter:
    """Monotonic counter."""

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value. A CUDA tensor is kept as it
    is and read at the first read of ``value``: the reader, not the
    setter, waits for the card."""

    def __init__(self):
        self._value = float("nan")

    def set(self, v) -> None:
        self._value = v if getattr(v, "is_cuda", False) else float(v)

    @property
    def value(self) -> float:
        v = self._value
        if not isinstance(v, float):
            v = self._value = float(v)
        return v


class Histogram:
    """Fixed-bucket streaming histogram (Prometheus cumulative-bucket
    semantics). Percentiles are linear interpolation inside the bucket —
    exact enough to attribute milliseconds, with O(1) memory."""

    def __init__(self, buckets: Optional[Sequence[float]] = None):
        bs = tuple(sorted(buckets if buckets is not None else DEFAULT_MS_BUCKETS))
        if not bs:
            raise ValueError("need at least one bucket bound")
        self.bounds: Tuple[float, ...] = bs
        self._counts = [0] * (len(bs) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._min = float("inf")
        self._max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            return
        # linear scan beats bisect for the short default bucket list
        i = 0
        for b in self.bounds:
            if v <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else float("nan")

    def cumulative_counts(self) -> List[int]:
        """Per-bound cumulative counts, +Inf last (Prometheus ``le`` view)."""
        with self._lock:
            out, acc = [], 0
            for c in self._counts:
                acc += c
                out.append(acc)
            return out

    def percentile(self, q: float) -> float:
        """Estimate the q-quantile (q in [0,1]) from the buckets."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(q)
        with self._lock:
            n = self._count
            if n == 0:
                return float("nan")
            target = q * n
            acc = 0.0
            lo = 0.0
            for i, c in enumerate(self._counts):
                hi = self.bounds[i] if i < len(self.bounds) else self._max
                if acc + c >= target and c > 0:
                    frac = (target - acc) / c
                    hi = min(hi, self._max)
                    lo = max(lo, self._min) if i == 0 else lo
                    return lo + frac * max(0.0, hi - lo)
                acc += c
                lo = hi
            return self._max

    def summary(self) -> Dict[str, float]:
        return {"count": self._count, "total": self._sum, "mean": self.mean,
                "min": self._min if self._count else float("nan"),
                "max": self._max if self._count else float("nan"),
                "p50": self.percentile(0.50), "p99": self.percentile(0.99)}


class _Family:
    def __init__(self, name: str, kind: str, help: str):
        self.name = name
        self.kind = kind
        self.help = help
        self.metrics: Dict[LabelKey, Any] = {}


class MetricsRegistry:
    """Name+labels → metric store, get-or-create, one exposition path.

    ``counter``/``gauge``/``histogram`` are idempotent: the first call
    registers the family (kind + help text), later calls return the same
    instance for the same labels. Re-registering a name under a
    different kind raises — one name, one meaning, every consumer.
    """

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()
        self._timeseries = None  # lazy TimeSeriesStore (see property)

    @property
    def timeseries(self):
        """The registry's windowed time-series store (lazy — the local
        import keeps monitor.registry importable before
        monitor.timeseries at package-init time). A fresh registry
        (``set_registry(MetricsRegistry())``) means a fresh store, so
        bench/test isolation covers the series too."""
        store = self._timeseries
        if store is None:
            from deeplearning4j_tpu_torch.monitor.timeseries import TimeSeriesStore
            with self._lock:
                if self._timeseries is None:
                    self._timeseries = TimeSeriesStore()
                store = self._timeseries
        return store

    # ------------------------------------------------------------ create

    def _get_or_create(self, name: str, kind: str, help: str,
                       labels: Dict[str, str], factory):
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(name, kind, help)
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"requested {kind}")
            if help and not fam.help:
                fam.help = help
            metric = fam.metrics.get(key)
            if metric is None:
                metric = fam.metrics[key] = factory()
            return metric

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get_or_create(name, "counter", help, labels, Counter)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get_or_create(name, "gauge", help, labels, Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        return self._get_or_create(name, "histogram", help, labels,
                                   lambda: Histogram(buckets))

    # ------------------------------------------------------------- read

    def get(self, name: str, **labels):
        fam = self._families.get(name)
        return fam.metrics.get(_label_key(labels)) if fam else None

    def family(self, name: str) -> Dict[LabelKey, Any]:
        fam = self._families.get(name)
        return dict(fam.metrics) if fam else {}

    def family_total(self, name: str) -> float:
        """Sum of a counter family across all label sets (0 if absent)."""
        return sum(m.value for m in self.family(name).values())

    def names(self) -> List[str]:
        return sorted(self._families)

    # -------------------------------------------------------- exposition

    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        out: List[str] = []
        with self._lock:
            fams = [(n, self._families[n]) for n in sorted(self._families)]
        for name, fam in fams:
            if fam.help:
                out.append(f"# HELP {name} {_escape_help(fam.help)}")
            out.append(f"# TYPE {name} {fam.kind}")
            for key, metric in sorted(fam.metrics.items()):
                base = dict(key)
                if fam.kind == "histogram":
                    cum = metric.cumulative_counts()
                    for bound, c in zip(list(metric.bounds) + ["+Inf"], cum):
                        lbl = _labels_str({**base, "le": bound if bound == "+Inf"
                                           else _fmt(float(bound))})
                        out.append(f"{name}_bucket{lbl} {c}")
                    lbl = _labels_str(base)
                    out.append(f"{name}_sum{lbl} {_fmt(metric.sum)}")
                    out.append(f"{name}_count{lbl} {metric.count}")
                else:
                    out.append(f"{name}{_labels_str(base)} {_fmt(metric.value)}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready view: {name: {kind, samples: [{labels, ...}]}}."""
        out: Dict[str, Any] = {}
        with self._lock:
            fams = list(self._families.items())
        for name, fam in fams:
            samples = []
            for key, metric in sorted(fam.metrics.items()):
                entry: Dict[str, Any] = {"labels": dict(key)}
                if fam.kind == "histogram":
                    entry.update(metric.summary())
                else:
                    entry["value"] = metric.value
                samples.append(entry)
            out[name] = {"kind": fam.kind, "help": fam.help, "samples": samples}
        return out

    def to_json(self) -> str:
        def clean(v):
            if isinstance(v, float) and not math.isfinite(v):
                return None
            if isinstance(v, dict):
                return {k: clean(x) for k, x in v.items()}
            if isinstance(v, list):
                return [clean(x) for x in v]
            return v
        return json.dumps(clean(self.snapshot()))


def _labels_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


# --------------------------------------------------------------- default

_default = MetricsRegistry()
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every in-tree producer publishes into."""
    return _default


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-wide registry (bench/test isolation); returns the
    previous one so callers can restore it."""
    global _default
    with _default_lock:
        old, _default = _default, registry
    return old
