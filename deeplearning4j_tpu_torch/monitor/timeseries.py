"""Windowed time-series telemetry — the fleet's short-term memory.

Counterpart of ``deeplearning4j_tpu/monitor/timeseries.py``, with the
same series names, tiers, alignment and queries.

The :mod:`registry` plane is point-in-time: every ``/metrics`` scrape
and ``stats()`` call answers "what is the value NOW", so nobody can ask
"what was KV-pool occupancy over the last five minutes" or "what is the
shed RATE this minute". This module adds the Monarch/Prometheus
in-memory time-series discipline on top of it: a bounded ring-buffer
store of **aligned, tiered windows** per metric, queryable by window
length, cheap enough to feed from the hot serving loops.

Design contract (what the determinism tests pin):

- **Aligned buckets.** A sample at time ``t`` lands in the tier-width
  bucket ``floor(t / width)`` — never a sliding window, so two
  processes with the same sample stream produce identical buckets.
- **Tiered downsampling.** Samples are recorded into the finest tier
  (1 s by default). When the clock passes a fine bucket's end, the
  closed bucket FOLDS into the covering bucket of every coarser tier
  (10 s, 60 s) — count/sum/min/max add, retained raw samples
  concatenate in arrival order (truncated at the per-bucket cap, a
  deterministic keep-the-earliest policy; the overflow is counted, not
  silently dropped). A coarse-tier query therefore equals the direct
  aggregation of the closed fine buckets it covers — the
  downsample-agreement property.
- **Deterministic retention.** Each tier keeps its newest ``retention``
  buckets; eviction is strictly oldest-first and happens only after
  folding, so a bucket's contribution to the coarser tiers is never
  lost to the ring.
- **Logical-clock testable.** The store takes an injectable ``clock``
  (defaults to ``time.monotonic``); under a logical clock every
  query is bit-deterministic.
- **Zero device syncs.** Values are host floats the callers already
  hold (slot counts, occupancy ratios, host-measured latencies).

``query(name, window)`` answers with ``{count, rate, mean, min, max,
p50, p99}`` over the aligned buckets covering the window, served from
the finest tier whose ring still spans it. ``snapshot`` is the JSON
view; engine/worker ``stats()`` payloads carry compact
per-endpoint summaries so ``InferenceRouter.fleet_snapshot()`` can
merge fleet-wide window answers from heartbeat-carried state alone.
"""

from __future__ import annotations

import math
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

# Series names the sampled-gauge hooks record (pinned alongside the
# registry families in scripts/check_telemetry_schema.py
# KNOWN_DL4J_METRICS — one name, one meaning, every consumer):
# scheduler burst boundaries
TS_SCHED_ACTIVE = "dl4j_ts_sched_active_rows"
TS_SCHED_QUEUED = "dl4j_ts_sched_queued_prefills"
TS_SCHED_POOL_OCCUPANCY = "dl4j_ts_sched_pool_occupancy"
TS_SCHED_PREFIX_HIT_RATE = "dl4j_ts_sched_prefix_hit_rate"
# router admission
TS_ROUTER_QUEUE_DEPTH = "dl4j_ts_router_queue_depth"
TS_ROUTER_ADMIT_ERROR = "dl4j_ts_router_admit_error_ms"
TS_ROUTER_SHED = "dl4j_ts_router_shed"
# engine dispatch
TS_ENGINE_FILL_RATIO = "dl4j_ts_engine_fill_ratio"
TS_ENGINE_JIT_MISS = "dl4j_ts_engine_jit_miss"
# SLO burn events (router _slo_burn; the flight recorder's burn-rate
# auto-trigger reads this series)
TS_SLO_BURN = "dl4j_ts_slo_burn"
# per-endpoint heartbeat-carried served-request rate
TS_WORKER_SERVED = "dl4j_ts_worker_served"

#: (bucket_width_s, retention_buckets) per tier, finest first. The
#: defaults keep 2 min at 1 s, 20 min at 10 s, 2 h at 60 s — a few
#: hundred small objects per live series, bounded by construction.
DEFAULT_TIERS: Tuple[Tuple[float, int], ...] = (
    (1.0, 120), (10.0, 120), (60.0, 120))

#: Raw samples retained per bucket for percentile queries. Keep-the-
#: earliest is deterministic (no reservoir RNG); the overflow count
#: rides along so a truncated percentile is visible as such.
DEFAULT_SAMPLES_PER_BUCKET = 256


class _Bucket:
    """One aligned window's aggregate + bounded raw samples."""

    __slots__ = ("count", "total", "vmin", "vmax", "samples", "dropped")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.samples: List[float] = []
        self.dropped = 0

    def add(self, v: float, cap: int) -> None:
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if len(self.samples) < cap:
            self.samples.append(v)
        else:
            self.dropped += 1

    def fold(self, other: "_Bucket", cap: int) -> None:
        """Merge ``other`` (a closed finer bucket) into this one —
        the downsample step. Deterministic: aggregates add, samples
        concatenate in fold order under the same cap."""
        self.count += other.count
        self.total += other.total
        if other.vmin < self.vmin:
            self.vmin = other.vmin
        if other.vmax > self.vmax:
            self.vmax = other.vmax
        room = cap - len(self.samples)
        if room >= len(other.samples):
            self.samples.extend(other.samples)
        else:
            if room > 0:
                self.samples.extend(other.samples[:room])
            self.dropped += len(other.samples) - max(0, room)
        self.dropped += other.dropped


def _percentile(sorted_samples: List[float], q: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation)."""
    if not sorted_samples:
        return math.nan
    rank = max(1, math.ceil(q * len(sorted_samples)))
    return sorted_samples[rank - 1]


class _Tier:
    __slots__ = ("width", "retention", "buckets")

    def __init__(self, width: float, retention: int):
        self.width = float(width)
        self.retention = max(1, int(retention))
        # aligned index -> _Bucket; insertion order == index order
        # (samples only arrive at a monotone clock)
        self.buckets: "OrderedDict[int, _Bucket]" = OrderedDict()

    def trim(self) -> None:
        while len(self.buckets) > self.retention:
            self.buckets.popitem(last=False)  # strictly oldest-first


class TimeSeries:
    """One metric's tiered ring — see the module docstring for the
    alignment/fold/retention contract. Not thread-safe on its own; the
    owning :class:`TimeSeriesStore` serializes access."""

    def __init__(self, name: str,
                 tiers: Tuple[Tuple[float, int], ...] = DEFAULT_TIERS,
                 samples_per_bucket: int = DEFAULT_SAMPLES_PER_BUCKET):
        self.name = name
        if not tiers:
            raise ValueError("need at least one tier")
        widths = [w for w, _ in tiers]
        if widths != sorted(widths):
            raise ValueError("tiers must be ordered finest-first")
        self.tiers = [_Tier(w, r) for w, r in tiers]
        self.cap = max(1, int(samples_per_bucket))
        self._open_idx: Optional[int] = None  # finest-tier open bucket

    # ------------------------------------------------------------ write

    def record(self, value: float, now: float) -> None:
        fine = self.tiers[0]
        idx = int(now // fine.width)
        self.advance(now)
        b = fine.buckets.get(idx)
        if b is None:
            b = fine.buckets[idx] = _Bucket()
            fine.trim()
        b.add(float(value), self.cap)
        self._open_idx = idx

    def advance(self, now: float) -> None:
        """Fold every finest-tier bucket the clock has passed into the
        covering bucket of each coarser tier (fold BEFORE evict — the
        ring can never lose a bucket's downsampled contribution)."""
        fine = self.tiers[0]
        cur = int(now // fine.width)
        if self._open_idx is None or self._open_idx >= cur:
            return
        closed = [i for i in fine.buckets if self._open_idx <= i < cur]
        for i in closed:
            b = fine.buckets[i]
            t_start = i * fine.width
            for tier in self.tiers[1:]:
                ci = int(t_start // tier.width)
                cb = tier.buckets.get(ci)
                if cb is None:
                    cb = tier.buckets[ci] = _Bucket()
                    tier.trim()
                cb.fold(b, self.cap)
        self._open_idx = cur

    # ------------------------------------------------------------- read

    def _pick_tier(self, window_s: float) -> _Tier:
        """Finest tier whose ring still spans the window (falls back to
        the coarsest for windows longer than every ring)."""
        for tier in self.tiers:
            if window_s <= tier.width * tier.retention:
                return tier
        return self.tiers[-1]

    def query(self, window_s: float, now: float) -> Dict[str, Any]:
        """Aggregate over the aligned buckets covering the last
        ``window_s`` seconds (the current open bucket included — the
        freshest aligned window, still deterministic per clock)."""
        window_s = float(window_s)
        if window_s <= 0:
            raise ValueError(f"window must be positive, got {window_s}")
        self.advance(now)
        tier = self._pick_tier(window_s)
        n_buckets = max(1, math.ceil(window_s / tier.width))
        lo = int(now // tier.width) - n_buckets + 1
        agg = _Bucket()
        covered = 0
        for i, b in tier.buckets.items():
            if i >= lo:
                agg.fold(b, self.cap)
                covered += 1
        if tier is self.tiers[0] and self._open_idx is not None \
                and self._open_idx >= lo:
            pass  # open bucket already lives in the finest ring
        elif tier is not self.tiers[0]:
            # the finest open bucket has not folded yet — include the
            # closed-but-unfolded remainder? No: folds are eager on
            # advance(), so only the OPEN finest bucket is missing.
            # Coarse queries trade sub-width recency for alignment.
            fine = self.tiers[0]
            if self._open_idx is not None:
                b = fine.buckets.get(self._open_idx)
                if b is not None and self._open_idx * fine.width \
                        >= lo * tier.width:
                    agg.fold(b, self.cap)
        samples = sorted(agg.samples)
        return {
            "window_s": window_s,
            "tier_s": tier.width,
            "buckets": covered,
            "count": agg.count,
            "rate": agg.count / window_s,
            "mean": (agg.total / agg.count) if agg.count else math.nan,
            "min": agg.vmin if agg.count else math.nan,
            "max": agg.vmax if agg.count else math.nan,
            "p50": _percentile(samples, 0.50),
            "p99": _percentile(samples, 0.99),
            "sampled": len(samples),
            "dropped_samples": agg.dropped,
        }

    def tier_view(self, tier_index: int) -> List[Dict[str, Any]]:
        """The raw ring of one tier (debug/eviction-order tests)."""
        tier = self.tiers[tier_index]
        return [{"index": i, "start_s": i * tier.width,
                 "count": b.count, "total": b.total,
                 "min": b.vmin if b.count else math.nan,
                 "max": b.vmax if b.count else math.nan}
                for i, b in tier.buckets.items()]


class TimeSeriesStore:
    """Bounded named-series collection behind :class:`MetricsRegistry`.

    ``record`` is the hot-path entry (dict lookup + a few float ops
    under a lock — the same budget as a registry counter);
    ``query``/``snapshot``/``summary`` are the read seams the UI
    endpoint, ``stats()`` payloads and the flight recorder's burn-rate
    trigger consume."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 tiers: Tuple[Tuple[float, int], ...] = DEFAULT_TIERS,
                 samples_per_bucket: int = DEFAULT_SAMPLES_PER_BUCKET,
                 max_series: int = 256):
        self._clock = clock if clock is not None else time.monotonic
        self._tiers = tuple((float(w), int(r)) for w, r in tiers)
        self._cap = int(samples_per_bucket)
        self._max_series = max(1, int(max_series))
        self._series: "OrderedDict[str, TimeSeries]" = OrderedDict()
        self._lock = threading.Lock()

    def now(self) -> float:
        return self._clock()

    # ------------------------------------------------------------ write

    def record(self, name: str, value: float) -> None:
        now = self._clock()
        with self._lock:
            s = self._series.get(name)
            if s is None:
                if len(self._series) >= self._max_series:
                    self._series.popitem(last=False)  # oldest-created
                s = self._series[name] = TimeSeries(
                    name, self._tiers, self._cap)
            s.record(value, now)

    # ------------------------------------------------------------- read

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def query(self, name: str, window_s: float) -> Optional[Dict[str, Any]]:
        """Windowed aggregate for one series; None when the series has
        never been recorded (absence is an answer, not an error)."""
        now = self._clock()
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return None
            return s.query(window_s, now)

    def snapshot(self, windows: Iterable[float] = (10.0, 60.0, 600.0)
                 ) -> Dict[str, Any]:
        """JSON-ready view: every series × every requested window —
        what ``UiServer /timeseries`` serves."""
        now = self._clock()
        out: Dict[str, Any] = {}
        with self._lock:
            for name in sorted(self._series):
                s = self._series[name]
                out[name] = {str(w): s.query(float(w), now)
                             for w in windows}
        return out

    def summary(self, names: Optional[Iterable[str]] = None,
                window_s: float = 60.0) -> Dict[str, Any]:
        """Compact per-endpoint payload carried in ``stats()`` (and so
        in fleet heartbeats): ``{series: {count, rate, mean, p99}}``
        over one window. Small enough to ride every heartbeat."""
        now = self._clock()
        out: Dict[str, Any] = {"window_s": float(window_s), "series": {}}
        with self._lock:
            picked = (sorted(self._series) if names is None
                      else [n for n in names if n in self._series])
            for name in picked:
                q = self._series[name].query(float(window_s), now)
                out["series"][name] = {
                    "count": q["count"], "rate": round(q["rate"], 6),
                    "mean": (None if math.isnan(q["mean"])
                             else round(q["mean"], 6)),
                    "p99": (None if math.isnan(q["p99"])
                            else round(q["p99"], 6))}
        return out

    def series(self, name: str) -> Optional[TimeSeries]:
        """Direct handle (tests/debug); None when absent."""
        with self._lock:
            return self._series.get(name)


def merge_summaries(summaries: Iterable[Dict[str, Any]]
                    ) -> Dict[str, Any]:
    """Fleet-wide window answer from per-endpoint ``summary()``
    payloads (heartbeat-carried): counts and rates ADD across
    endpoints, means combine count-weighted, p99 takes the max (an
    upper bound — the honest cross-endpoint merge without raw
    samples). What ``fleet_snapshot()['timeseries']`` reports."""
    merged: Dict[str, Dict[str, float]] = {}
    window = None
    for s in summaries:
        if not isinstance(s, dict) or "series" not in s:
            continue
        if window is None:
            window = s.get("window_s")
        for name, q in s["series"].items():
            m = merged.setdefault(
                name, {"count": 0, "rate": 0.0, "_wsum": 0.0,
                       "p99": None})
            m["count"] += int(q.get("count") or 0)
            m["rate"] += float(q.get("rate") or 0.0)
            if q.get("mean") is not None and q.get("count"):
                m["_wsum"] += float(q["mean"]) * int(q["count"])
            if q.get("p99") is not None:
                m["p99"] = (float(q["p99"]) if m["p99"] is None
                            else max(m["p99"], float(q["p99"])))
    out: Dict[str, Any] = {"window_s": window, "series": {}}
    for name in sorted(merged):
        m = merged[name]
        out["series"][name] = {
            "count": m["count"], "rate": round(m["rate"], 6),
            "mean": (round(m["_wsum"] / m["count"], 6) if m["count"]
                     else None),
            "p99": (None if m["p99"] is None else round(m["p99"], 6))}
    return out


# ------------------------------------------------------- module helpers
# (the hot-path entry points the hooks call: one enabled-flag branch,
# then a registry-store record — no allocation on the disabled path,
# which is what the bench overhead bar measures against)

_enabled = True


def set_timeseries_enabled(flag: bool) -> bool:
    """Globally enable/disable the sampled-gauge hooks (bench A/B seam
    for the observatory overhead bar); returns the previous state."""
    global _enabled
    old, _enabled = _enabled, bool(flag)
    return old


def timeseries_enabled() -> bool:
    return _enabled


def ts_record(name: str, value: float) -> None:
    """Record one host-side sample into the active registry's store —
    the sampled-gauge hook every serving plane calls. Never raises:
    telemetry must not take the serving loop down."""
    if not _enabled:
        return
    from deeplearning4j_tpu_torch.monitor.registry import get_registry
    try:
        get_registry().timeseries.record(name, value)
    except Exception:
        pass


def ts_query(name: str, window_s: float) -> Optional[Dict[str, Any]]:
    """Windowed aggregate from the active registry's store."""
    from deeplearning4j_tpu_torch.monitor.registry import get_registry
    return get_registry().timeseries.query(name, window_s)
