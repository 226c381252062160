"""Preemption-safe training: periodic checkpoints and an exact resume.

Counterpart of ``deeplearning4j_tpu/optimize/resumable.py``, with its
checkpoint unit: a directory ``checkpoint/`` holding ``model.zip`` (the
serializer's zip: config, parameters, updater state) and
``cursor.json`` (``steps_done``, ``epochs_done``, the iterator's
``state()`` and a supervisor's state), so a unit written by either
package resumes in the other.

- Every ``checkpoint_every`` steps and at each epoch's end the model and
  the cursor are written into a temporary directory, which is renamed
  into place as one unit: a preemption at any instant leaves the last
  complete unit, and the model and the cursor always come from the same
  step. While the new unit is installed the old one is kept as
  ``checkpoint.old``, which a resume falls back to.
- ``resume_or_start`` brings back the model (on the trainer's model's
  device) and rewinds the iterator; training goes on with the same step
  and updater schedule, so an iterator that replays the same stream
  makes the resumed run equal the uninterrupted one.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
from typing import Optional

from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator
from deeplearning4j_tpu_torch.util.model_serializer import (
    fsync_dir,
    restore_model,
    write_model,
)

logger = logging.getLogger("deeplearning4j_tpu_torch")

_UNIT = "checkpoint"
_TMP_PREFIX = ".ckpt_tmp_"
_MODEL = "model.zip"
_CURSOR = "cursor.json"


class ResumableTrainer:
    """Drives ``model.fit`` batch by batch with periodic atomic
    checkpoints of (model, data cursor, progress)."""

    def __init__(self, model, directory: str, checkpoint_every: int = 50):
        self.model = model
        self.directory = directory
        self.checkpoint_every = max(1, checkpoint_every)
        os.makedirs(directory, exist_ok=True)
        # temporary units left by a preempted run are never complete
        for name in os.listdir(directory):
            if name.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)
        self.steps_done = 0
        self.epochs_done = 0
        self._supervisor = None

    def _save(self, iterator) -> None:
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=_TMP_PREFIX)
        try:
            write_model(self.model, os.path.join(tmp, _MODEL))
            cursor = {"steps_done": self.steps_done,
                      "epochs_done": self.epochs_done}
            if hasattr(iterator, "state"):
                cursor["iterator"] = iterator.state()
            if self._supervisor is not None:
                cursor["supervisor"] = self._supervisor.state()
            # the cursor lands by its own temp file, fsync and replace, so
            # that it is never seen half written even inside the unit
            cursor_tmp = os.path.join(tmp, _CURSOR + ".tmp")
            with open(cursor_tmp, "w") as f:
                json.dump(cursor, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(cursor_tmp, os.path.join(tmp, _CURSOR))
            final = os.path.join(self.directory, _UNIT)
            old = final + ".old"
            # at every instant at least one complete unit is visible: the
            # old unit is removed only while the final one exists
            if os.path.isdir(final):
                shutil.rmtree(old, ignore_errors=True)
                os.rename(final, old)
            os.rename(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
            fsync_dir(self.directory)
        finally:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp, ignore_errors=True)

    def _unit_candidates(self) -> list:
        """The complete units, newest first: ``checkpoint``, then
        ``checkpoint.old`` (left only by a preemption between the two
        renames of an install)."""
        return [cand for cand in (os.path.join(self.directory, _UNIT),
                                  os.path.join(self.directory, _UNIT + ".old"))
                if (os.path.exists(os.path.join(cand, _MODEL))
                    and os.path.exists(os.path.join(cand, _CURSOR)))]

    def _unit_dir(self) -> Optional[str]:
        cands = self._unit_candidates()
        return cands[0] if cands else None

    def has_checkpoint(self) -> bool:
        return self._unit_dir() is not None

    def resume_or_start(self, iterator: Optional[DataSetIterator] = None,
                        supervisor=None):
        """Restore the model and the cursor where a checkpoint exists and
        return the (restored) model; ``iterator`` (with ``restore()``)
        is rewound to the saved position. An unreadable unit is skipped
        with a warning for the previous one, and with none left the run
        starts afresh. ``supervisor`` is rebound to the restored model
        and takes the saved rollback and LR state."""
        for unit in self._unit_candidates():
            try:
                model = restore_model(os.path.join(unit, _MODEL),
                                      device=self.model.device)
                with open(os.path.join(unit, _CURSOR)) as f:
                    cursor = json.load(f)
            except Exception as e:
                logger.warning(
                    "resume_or_start: checkpoint unit %s is unreadable "
                    "(%s: %s); falling back to the previous unit",
                    unit, type(e).__name__, e)
                continue
            self.model = model
            self.steps_done = int(cursor.get("steps_done", 0))
            self.epochs_done = int(cursor.get("epochs_done", 0))
            if iterator is not None and "iterator" in cursor:
                if not hasattr(iterator, "restore"):
                    raise ValueError(
                        "checkpoint carries a data cursor but this iterator "
                        f"({type(iterator).__name__}) has no restore(); "
                        "resuming without rewinding would silently re-train "
                        "already-consumed batches: pass the same resumable "
                        "iterator type used during training")
                iterator.restore(cursor["iterator"])
            if supervisor is not None:
                supervisor.model = self.model
                supervisor.restore(cursor.get("supervisor", {}))
            return self.model
        if self._unit_candidates() or os.path.isdir(
                os.path.join(self.directory, _UNIT)):
            logger.warning(
                "resume_or_start: no readable checkpoint unit under %s; "
                "starting fresh from step 0", self.directory)
        return self.model

    def fit(self, iterator: DataSetIterator, epochs: int = 1,
            max_steps: Optional[int] = None, supervisor=None) -> int:
        """Train until ``epochs`` are complete (counting those of earlier
        runs) or ``max_steps`` new batches were taken (a preemption's
        stand-in); checkpoints every ``checkpoint_every`` steps and at
        each epoch's end. Returns the batches taken in this call.
        ``supervisor`` guards each batch; its state rides in the
        cursor."""
        if supervisor is not None and supervisor.model is not self.model:
            raise ValueError(
                "supervisor guards a different model object; construct it "
                "over this trainer's model (or pass it through "
                "resume_or_start, which rebinds it to the restored model)")
        self._supervisor = supervisor
        consumed = 0
        while self.epochs_done < epochs:
            while iterator.has_next():
                if max_steps is not None and consumed >= max_steps:
                    self._save(iterator)
                    return consumed
                ds = iterator.next()
                if supervisor is not None:
                    supervisor.step(ds)
                else:
                    self.model.fit(ds)
                self.steps_done += 1
                consumed += 1
                if self.steps_done % self.checkpoint_every == 0:
                    self._save(iterator)
            self.epochs_done += 1
            iterator.reset()
            self._save(iterator)
        return consumed
