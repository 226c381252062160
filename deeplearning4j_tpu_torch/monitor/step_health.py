"""Step-health watchdog: NaN/Inf scores and slow-step outliers.

Counterpart of ``deeplearning4j_tpu/monitor/step_health.py``. The
watchdog rides the listener chain (the containers call listeners as
``cb(model, iteration, score)``), publishes into the process registry,
and flags:

- non-finite scores -> ``dl4j_nan_scores_total`` (and a trace event);
- slow-step outliers -> ``dl4j_slow_steps_total`` when a step exceeds
  ``slow_factor x`` the rolling median (and the rolling p99), over an
  exact ``window``-step deque.

It reads scores only as the listener chain delivers them: in ``fit``
that is the deferred ring's replay (``optimize/deferred.py``), host
floats from the ring's one batched fetch, so the watchdog never reads
the card itself. Its step durations are then the host's intervals
between those calls. Imports nothing of torch or the optimize package
(the listener protocol is duck-typed), so ``monitor`` stays a leaf.
"""

from __future__ import annotations

import logging
import math
import time
from collections import deque
from typing import Optional

from deeplearning4j_tpu_torch.monitor.registry import MetricsRegistry, get_registry
from deeplearning4j_tpu_torch.monitor.tracing import mark

logger = logging.getLogger("deeplearning4j_tpu_torch")

NAN_COUNTER = "dl4j_nan_scores_total"
SLOW_COUNTER = "dl4j_slow_steps_total"
SCORE_GAUGE = "dl4j_score"
STEP_HISTOGRAM = "dl4j_step_duration_ms"


class StepHealthWatchdog:
    """Attach via ``model.set_listeners(..., StepHealthWatchdog())`` (or
    ``ParallelWrapper`` hooks) — every ``iteration_done`` records one
    step."""

    def __init__(self, window: int = 256, slow_factor: float = 3.0,
                 min_samples: int = 20,
                 registry: Optional[MetricsRegistry] = None):
        self.window = max(8, window)
        self.slow_factor = slow_factor
        self.min_samples = max(2, min_samples)
        self._registry = registry
        self._durations: deque = deque(maxlen=self.window)
        self._last_time: Optional[float] = None
        self.nan_iterations: list = []
        self.slow_iterations: list = []

    @property
    def registry(self) -> MetricsRegistry:
        # late-bound so a bench/test registry swap is picked up
        return self._registry if self._registry is not None else get_registry()

    # listener protocol (optimize/listeners.py IterationListener shape)
    def __call__(self, model, iteration: int, score: float) -> None:
        self.iteration_done(model, iteration, score)

    def iteration_done(self, model, iteration: int, score: float) -> None:
        now = time.perf_counter()
        duration_ms = None
        if self._last_time is not None:
            duration_ms = (now - self._last_time) * 1e3
        self._last_time = now
        self.record(score, duration_ms, iteration=iteration)

    # ------------------------------------------------------------- core

    def record(self, score: float, duration_ms: Optional[float],
               iteration: int = -1) -> None:
        reg = self.registry
        score = float(score)
        if math.isfinite(score):
            reg.gauge(SCORE_GAUGE, "Latest training score").set(score)
        else:
            reg.counter(NAN_COUNTER,
                        "Iterations with a non-finite score").inc()
            self.nan_iterations.append(iteration)
            mark("nan_score", iteration=iteration, score=repr(score))
            logger.warning("step_health: non-finite score %s at iteration %d",
                           score, iteration)
        if duration_ms is None:
            return
        reg.histogram(STEP_HISTOGRAM, "Per-iteration host step duration"
                      ).observe(duration_ms)
        p50, p99 = self.percentiles()
        if (len(self._durations) >= self.min_samples
                and duration_ms > self.slow_factor * p50
                and duration_ms > p99):
            reg.counter(SLOW_COUNTER,
                        "Steps slower than slow_factor x rolling median"
                        ).inc()
            self.slow_iterations.append(iteration)
            mark("slow_step", iteration=iteration,
                 duration_ms=round(duration_ms, 3), p50_ms=round(p50, 3),
                 p99_ms=round(p99, 3))
            logger.warning(
                "step_health: slow step at iteration %d: %.1fms "
                "(rolling p50 %.1fms, p99 %.1fms)",
                iteration, duration_ms, p50, p99)
        self._durations.append(duration_ms)
        reg.gauge("dl4j_step_duration_p50_ms",
                  "Rolling median step duration").set(
            self._q(0.50) if self._durations else float("nan"))
        reg.gauge("dl4j_step_duration_p99_ms",
                  "Rolling p99 step duration").set(
            self._q(0.99) if self._durations else float("nan"))

    def _q(self, q: float) -> float:
        data = sorted(self._durations)
        if not data:
            return float("nan")
        idx = min(len(data) - 1, int(q * len(data)))
        return data[idx]

    def percentiles(self) -> tuple:
        """(rolling p50, rolling p99) over the last ``window`` steps."""
        return self._q(0.50), self._q(0.99)

    def healthy(self) -> bool:
        reg = self.registry
        return reg.family_total(NAN_COUNTER) == 0
