"""Divergence rollback for a training loop.

Counterpart of ``deeplearning4j_tpu/optimize/supervisor.py``:

- before each guarded batch the supervisor snapshots the last good
  ``(params, opt_state, states)``;
- a NaN or infinite score after the step (or one above
  ``score_ceiling``) rolls back: the snapshot comes back, every learning
  rate is multiplied by ``lr_backoff`` (two rollbacks: backoff squared),
  the batch is skipped, and training goes on;
- after ``max_rollbacks`` rollbacks it gives up with
  :class:`TrainingDiverged`, whose ``report`` is a JSON-ready post-mortem
  (every rollback, the LR scale, the skipped batches).

With no fault a supervised run is bit for bit the unsupervised loop over
the same batches: a snapshot holds the trees' tensors by reference (new
dicts around them), which is exact because no op of a training step
writes a tensor in place (each step builds new ones); the dicts are
copied because truncated BPTT sets entries of the states dict. The
learning rates reach the updater through the containers' updater specs,
which they build at construction (``update_specs``), so a backoff
rebuilds them. The reference's ``DL4J_TPU_DISABLE_SUPERVISOR`` switch
is not ported (the env seams are left out); ``enabled=False`` makes a
pass-through. Each rollback ticks ``dl4j_fault_events_total{domain=
"training"}`` and ``dl4j_fault_rollbacks_total`` and marks
``training_rollback`` in the trace; giving up marks
``training_diverged``. Unlike the reference, a rollback does not empty
the model's dispatch signatures: its steps are the same eager code at
the new rates, with no program to build again.

With ``ResumableTrainer.fit(..., supervisor=...)`` the rollback and LR
state ride in the checkpoint's cursor.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.monitor import (
    FAULT_ROLLBACKS_COUNTER,
    get_registry,
    mark,
    record_fault,
)
from deeplearning4j_tpu_torch.nn.multilayer import _tree_copy, update_specs


class TrainingDiverged(RuntimeError):
    """Training could not be stabilized within ``max_rollbacks``;
    ``report`` is the JSON-serializable post-mortem."""

    def __init__(self, report: Dict[str, Any]):
        super().__init__(
            f"training diverged: {report['rollbacks']} rollbacks "
            f"(max {report['max_rollbacks']}); last score "
            f"{report['events'][-1]['score'] if report['events'] else 'n/a'}; "
            "see .report for the structured post-mortem")
        self.report = report


class TrainingSupervisor:
    """Guards a model's per-batch fit loop with rollback on divergence.

    Drive it with ``supervisor.fit(iterator, epochs=...)`` or batch by
    batch with ``supervisor.step(ds)`` (``ResumableTrainer``'s seam).
    ``check_every`` is how many batches pass between score checks (and
    snapshots); each check reads the step's score on the host."""

    def __init__(self, model, max_rollbacks: int = 3,
                 lr_backoff: float = 0.5, check_every: int = 1,
                 score_ceiling: Optional[float] = None,
                 enabled: Optional[bool] = None):
        if not 0.0 < lr_backoff < 1.0:
            raise ValueError(f"lr_backoff must be in (0, 1), got {lr_backoff}")
        self.model = model
        self.max_rollbacks = int(max_rollbacks)
        self.lr_backoff = float(lr_backoff)
        self.check_every = max(1, int(check_every))
        self.score_ceiling = score_ceiling
        self.enabled = True if enabled is None else bool(enabled)
        self.rollbacks = 0
        self.steps_done = 0
        self.batches_skipped: List[int] = []
        self.events: List[Dict[str, Any]] = []
        self._snap = None
        self._base_lrs: Optional[Dict[str, Any]] = None

    @property
    def lr_scale(self) -> float:
        return self.lr_backoff ** self.rollbacks

    def _impls(self):
        impls = self.model.impls
        return list(impls.values() if isinstance(impls, dict) else impls)

    def _apply_lr_scale(self) -> None:
        """Set every configured learning rate to its base times the
        cumulative backoff, and rebuild the model's updater specs, which
        hold the rates the step uses."""
        gc = self.model.gc
        confs = [i.conf for i in self._impls()]
        if self._base_lrs is None:
            self._base_lrs = {"global": gc.learning_rate,
                              "layers": [c.learning_rate for c in confs]}
        scale = self.lr_scale
        gc.learning_rate = self._base_lrs["global"] * scale
        for conf, base in zip(confs, self._base_lrs["layers"]):
            if base is not None:
                conf.learning_rate = base * scale
        self.model._specs = update_specs(gc, self._impls())

    def _take_snapshot(self) -> None:
        m = self.model
        self._snap = (_tree_copy(m.params), _tree_copy(m.opt_state),
                      _tree_copy(m.states))

    def _restore_snapshot(self) -> None:
        m = self.model
        params, opt_state, states = self._snap
        m.params = _tree_copy(params)
        m.opt_state = _tree_copy(opt_state)
        m.states = _tree_copy(states)

    def step(self, ds) -> bool:
        """Fit one batch under supervision: True when it took, False when
        a rollback skipped it. Raises :class:`TrainingDiverged` past
        ``max_rollbacks``."""
        if not self.enabled:
            self.model.fit(ds)
            self.steps_done += 1
            return True
        if self._snap is None or self.steps_done % self.check_every == 0:
            self._take_snapshot()
        self.model.fit(ds)
        self.steps_done += 1
        if self.steps_done % self.check_every != 0:
            return True
        score = float(self.model.score())
        if self._healthy(score):
            return True
        self._rollback(score)
        return False

    def _healthy(self, score: float) -> bool:
        if not math.isfinite(score):
            return False
        if self.score_ceiling is not None and score > self.score_ceiling:
            return False
        return True

    def _rollback(self, score: float) -> None:
        self.rollbacks += 1
        record_fault("training")
        get_registry().counter(
            FAULT_ROLLBACKS_COUNTER,
            "Divergence rollbacks performed by the training supervisor"
        ).inc()
        event = {"step": self.steps_done, "score": score,
                 "rollback": self.rollbacks, "lr_scale": None}
        self.batches_skipped.append(self.steps_done - 1)
        self._restore_snapshot()
        if self.rollbacks > self.max_rollbacks:
            event["action"] = "give_up"
            self.events.append(event)
            mark("training_diverged", rollbacks=self.rollbacks, score=score)
            raise TrainingDiverged(self.report())
        self._apply_lr_scale()
        event["lr_scale"] = self.lr_scale
        event["action"] = "rollback"
        self.events.append(event)
        mark("training_rollback", rollback=self.rollbacks, score=score,
             lr_scale=self.lr_scale)

    def fit(self, iterator, epochs: int = 1) -> Dict[str, Any]:
        """Supervised epochs over ``iterator``; returns :meth:`report`."""
        for _ in range(max(1, epochs)):
            iterator.reset()
            while iterator.has_next():
                self.step(iterator.next())
        return self.report()

    def report(self) -> Dict[str, Any]:
        return {
            "rollbacks": self.rollbacks,
            "max_rollbacks": self.max_rollbacks,
            "lr_scale": self.lr_scale,
            "steps_done": self.steps_done,
            "batches_skipped": list(self.batches_skipped),
            "events": list(self.events),
            "enabled": self.enabled,
        }

    def state(self) -> Dict[str, Any]:
        """The policy's state for a checkpoint's cursor. The learning
        rates before any backoff ride along: a checkpoint's config holds
        the scaled rates, so a resume that scaled them again would
        compound the backoff."""
        return {"rollbacks": self.rollbacks, "steps_done": self.steps_done,
                "batches_skipped": list(self.batches_skipped),
                "events": list(self.events),
                "base_lrs": self._base_lrs}

    def restore(self, state: Dict[str, Any]) -> None:
        self.rollbacks = int(state.get("rollbacks", 0))
        self.steps_done = int(state.get("steps_done", 0))
        self.batches_skipped = list(state.get("batches_skipped", []))
        self.events = list(state.get("events", []))
        self._base_lrs = state.get("base_lrs") or None
        self._snap = None
        if self.enabled and self.rollbacks > 0:
            self._apply_lr_scale()

    def to_json(self) -> str:
        return json.dumps(self.report())
