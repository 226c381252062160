"""Iteration listeners: training callbacks.

Counterpart of ``deeplearning4j_tpu/optimize/listeners.py``. The
container calls each listener as ``listener(model, iteration, score)``
after every step; the classes also answer to the reference's
``iteration_done``. Reading the score waits for the card, so listeners
that act every N iterations say so with ``frequency``.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.monitor import get_registry

logger = logging.getLogger("deeplearning4j_tpu_torch")


class IterationListener:
    def __call__(self, model, iteration: int, score: float):
        self.iteration_done(model, iteration, score)

    def iteration_done(self, model, iteration: int, score: float):
        raise NotImplementedError


class ScoreIterationListener(IterationListener):
    """Log the score every N iterations."""

    def __init__(self, print_iterations: int = 10):
        self.n = max(1, print_iterations)

    def iteration_done(self, model, iteration, score):
        if iteration % self.n == 0:
            logger.info("Score at iteration %d is %s", iteration, score)


class PerformanceListener(IterationListener):
    """Iterations/s (and examples/s where the model reports its
    ``last_batch_size``) between reports, kept on the listener and
    logged. The rates also publish into the metrics registry
    (``monitor``, or ``registry=``) as the ``dl4j_iterations_per_sec``
    and ``dl4j_examples_per_sec`` gauges, beside a
    ``dl4j_iterations_total`` counter of every iteration seen."""

    def __init__(self, frequency: int = 1, report_examples: bool = True,
                 registry=None):
        self.frequency = max(1, frequency)
        self.report_examples = report_examples
        self._registry = registry
        self._last_time: Optional[float] = None
        self._last_iter = 0
        self.last_iters_per_sec: float = float("nan")
        self.last_examples_per_sec: float = float("nan")

    def _reg(self):
        return self._registry if self._registry is not None else get_registry()

    def iteration_done(self, model, iteration, score):
        now = time.perf_counter()
        reg = self._reg()
        reg.counter("dl4j_iterations_total", "Training iterations seen").inc()
        if self._last_time is not None and iteration % self.frequency == 0:
            dt = now - self._last_time
            di = iteration - self._last_iter
            if dt > 0 and di > 0:
                self.last_iters_per_sec = di / dt
                reg.gauge("dl4j_iterations_per_sec",
                          "Training throughput").set(self.last_iters_per_sec)
                batch = getattr(model, "last_batch_size", None)
                if batch:
                    self.last_examples_per_sec = self.last_iters_per_sec * batch
                    reg.gauge("dl4j_examples_per_sec",
                              "Example throughput").set(
                        self.last_examples_per_sec)
                logger.info("iteration %d: %.2f iter/sec, score %s",
                            iteration, self.last_iters_per_sec, score)
        if iteration % self.frequency == 0:
            self._last_time = now
            self._last_iter = iteration


class CollectScoresIterationListener(IterationListener):
    """Record (iteration, score)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[Tuple[int, float]] = []

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, score))


class ParamAndGradientIterationListener(IterationListener):
    """Tab-separated per-parameter statistics, to a file or the log:
    each parameter's L2 norm and |change of the norm| since the last
    report (the reference's columns)."""

    def __init__(self, frequency: int = 1, path: str = None,
                 delimiter: str = "\t"):
        self.frequency = max(1, frequency)
        self.path = path
        self.delimiter = delimiter
        self._last_norms = None
        self._wrote_header = False

    def _emit(self, line: str):
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        else:
            logger.info("%s", line)

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency != 0 or model.params is None:
            return
        names = [(ln, pn) for ln in sorted(model.params)
                 for pn in sorted(model.params[ln])]
        vals = torch.stack([torch.linalg.vector_norm(model.params[ln][pn].float())
                            for ln, pn in names]).cpu().tolist() if names else []
        norms = {f"{ln}/{pn}": v for (ln, pn), v in zip(names, vals)}
        if not self._wrote_header:
            cols = [f"{k}:{kind}" for k in norms for kind in ("norm", "upd")]
            self._emit(self.delimiter.join(["iteration", "score"] + cols))
            self._wrote_header = True
        row = [str(iteration), f"{score:.6g}"]
        for k, v in norms.items():
            upd = (abs(v - self._last_norms[k])
                   if self._last_norms and k in self._last_norms
                   else float("nan"))
            row += [f"{v:.6g}", f"{upd:.6g}"]
        self._last_norms = norms
        self._emit(self.delimiter.join(row))
