"""Deferred device-to-host score fetches.

Counterpart of ``deeplearning4j_tpu/optimize/deferred.py``. Reading a
step's score on the host (``float(score)``) waits for the card to finish
that step, and the host then queues nothing until it has the value.
``fit`` keeps each step's score as a device scalar in a small ring and
fetches the pending ones in one ``torch.stack(...).cpu()`` only when

- a listener's declared frequency (``.frequency``, or ``.n`` on
  ``ScoreIterationListener``) says it acts at this iteration; a
  listener that declares none asks for every iteration;
- the ring reaches its capacity; or
- the ``fit`` call ends.

Listeners still receive every iteration's exact score, in order; the
calls arrive in bursts, so a listener that reads ``model.params`` during
a burst sees the parameters at the fetch, not at its iteration.

Each fetch runs inside a ``score_sync`` span (its ``count`` the scores
fetched) and ticks ``dl4j_score_sync_total`` once: the ring's fetch is
the only host wait on the card that either adds, and it was there
before them.

``host_step``/``set_host_step`` keep the reference's names. The
reference mirrors its device step counter on the host; the port's
``opt_state["step"]`` is a host int already, so they read and set it.

:func:`note_dispatch` keeps the reference's meaning: the first dispatch
of a (program kind, operand shapes, dtypes) signature. The reference
traces and compiles there; the port has no trace, but on the card that
dispatch is the one that builds kernels at first use and autotunes
cuBLAS and cuDNN for the new shapes. Callers label its span ``compile``
(later ones ``device_step`` or ``inference``) and every first-seen
signature ticks ``dl4j_jit_cache_miss_total``, so the span sequence
reads as the reference's, and shape bucketing's "one miss per bucket"
means what it does there. The signatures hold the reference's mesh
token slot as ``None`` until the port has a mesh (ROADMAP A9).
"""

from __future__ import annotations

import threading
from typing import List, Tuple

import torch

from deeplearning4j_tpu_torch.monitor import (
    JIT_CACHE_MISS_COUNTER,
    SCORE_SYNC_COUNTER,
    get_registry,
    span,
)


def host_step(model) -> int:
    """The model's step counter (a host int in the port: no sync)."""
    return int(model.opt_state["step"])


def set_host_step(model, value: int) -> None:
    """Set the model's step counter."""
    model.opt_state["step"] = int(value)


def listener_sync_period(cb) -> int:
    """How many iterations a listener tolerates between fetches: its
    declared frequency, else 1."""
    f = getattr(cb, "frequency", None)
    if f is None:
        f = getattr(cb, "n", None)
    try:
        f = int(f)
    except (TypeError, ValueError):
        return 1
    return max(1, f)


class DeferredScoreSync:
    """Ring of (iteration, device-scalar score) waiting to be fetched.

    ``push`` is called once per step with the step's score; ``flush``
    fetches every pending score in one stacked copy (one
    ``dl4j_score_sync_total`` tick), sets
    ``model._score`` to the last as a host float, and replays the
    listeners in iteration order. ``flushes`` counts the calls that
    fetched, ``flush_calls`` every call."""

    def __init__(self, model, capacity: int = 64):
        self.model = model
        self.capacity = max(1, capacity)
        self._pending: List[Tuple[int, torch.Tensor]] = []
        self.flushes = 0
        self.flush_calls = 0
        # another thread may flush while the training thread pushes: each
        # pending score is fetched and replayed exactly once
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._pending)

    def push(self, iteration: int, score) -> None:
        self._pending.append((iteration, score))
        m = self.model
        m._score = score  # a device scalar; score() fetches it on demand
        listeners = getattr(m, "listeners", None) or []
        due = any(iteration % listener_sync_period(cb) == 0
                  for cb in listeners)
        if due or len(self._pending) >= self.capacity:
            self.flush()

    def flush(self) -> None:
        with self._lock:
            self.flush_calls += 1
            if not self._pending:
                return
            pending, self._pending = self._pending, []
            self.flushes += 1
        with span("score_sync", count=len(pending)):
            vals = torch.stack([s for _, s in pending]).cpu().tolist()
        get_registry().counter(
            SCORE_SYNC_COUNTER,
            "Device->host score fetches (each is a chip round-trip)").inc()
        m = self.model
        m._score = float(vals[-1])
        listeners = list(getattr(m, "listeners", None) or [])
        for (it, _), v in zip(pending, vals):
            for cb in listeners:
                cb(m, it, float(v))


def score_sink(model) -> DeferredScoreSync:
    """The model's deferred-score ring, made on first use (one per
    model)."""
    s = model.__dict__.get("_deferred_scores")
    if s is None:
        s = model.__dict__["_deferred_scores"] = DeferredScoreSync(model)
    return s


def note_dispatch(model, sig) -> bool:
    """Record a dispatch signature (program kind + operand shapes and
    dtypes); True the first time it is seen (the caller labels that
    dispatch's span ``compile``), and each first-seen signature ticks
    ``dl4j_jit_cache_miss_total``. The set lives on the model and
    ``init()`` resets it, as the reference's jit cache."""
    seen = model.__dict__.setdefault("_dispatch_sigs", set())
    if sig in seen:
        return False
    seen.add(sig)
    get_registry().counter(
        JIT_CACHE_MISS_COUNTER,
        "Train-step dispatches that traced+compiled a fresh program").inc()
    return True
