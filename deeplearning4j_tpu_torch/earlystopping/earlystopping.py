"""Early stopping: configuration, termination conditions, savers, trainer.

Counterpart of ``deeplearning4j_tpu/earlystopping/earlystopping.py``:
epoch and iteration termination conditions, the in-memory and on-disk
model savers, the held-out loss calculator, and the trainer that runs
train epoch -> score -> keep the best -> maybe stop, for both
containers. The reference's ``ShardedCheckpointSaver`` stores through
orbax and a device mesh, and waits with the mesh for ROADMAP A9.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional

from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator
from deeplearning4j_tpu_torch.util.device import DeviceLike


# ---------------------------------------------------------------- conditions

class EpochTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, last_score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score):
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs without (min-delta) improvement."""

    def __init__(self, max_epochs_without_improvement: int, min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self.best = float("inf")
        self.since = 0

    def initialize(self):
        self.best = float("inf")
        self.since = 0

    def terminate(self, epoch, score):
        if score < self.best - self.min_improvement:
            self.best = score
            self.since = 0
        else:
            self.since += 1
        return self.since >= self.patience


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self.start = time.time()

    def initialize(self):
        self.start = time.time()

    def terminate(self, last_score):
        return (time.time() - self.start) > self.max_seconds


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Terminate if score exceeds a bound (divergence guard)."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, last_score):
        return last_score > self.max_score or last_score != last_score  # NaN


# ------------------------------------------------------------------- savers

class InMemoryModelSaver:
    """Keeps the best model (a ``clone`` where the model has one) and
    the latest in memory."""

    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, model, score):
        self._best = (model.clone() if hasattr(model, "clone") else model, score)

    def save_latest_model(self, model, score):
        self._latest = (model, score)

    def get_best_model(self):
        return self._best[0] if self._best else None

    def get_latest_model(self):
        return self._latest[0] if self._latest else None


class LocalFileModelSaver:
    """Model zips on disk (``bestModel.zip``, ``latestModel.zip``),
    restored on ``device``, by default the device of the model saved
    last (the card where this saver has saved none)."""

    def __init__(self, directory: str, device: DeviceLike = None):
        self.dir = directory
        self.device = device
        self._saved_on = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, name):
        return os.path.join(self.dir, name)

    def _write(self, model, name):
        from deeplearning4j_tpu_torch.util.model_serializer import write_model
        write_model(model, self._path(name))
        self._saved_on = model.device

    def _read(self, name):
        from deeplearning4j_tpu_torch.util.model_serializer import restore_model
        device = self.device if self.device is not None else self._saved_on
        return restore_model(self._path(name), device=device)

    def save_best_model(self, model, score):
        self._write(model, "bestModel.zip")

    def save_latest_model(self, model, score):
        self._write(model, "latestModel.zip")

    def get_best_model(self):
        return self._read("bestModel.zip")

    def get_latest_model(self):
        return self._read("latestModel.zip")


# ---------------------------------------------------------- score calculators

class DataSetLossCalculator:
    """The loss over an iterator in eval mode: the mean over examples
    (each batch's score weighted by its size), or the weighted sum."""

    def __init__(self, iterator: DataSetIterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, model) -> float:
        total, n = 0.0, 0
        self.iterator.reset()
        for ds in self.iterator:
            total += model.score(ds) * ds.num_examples()
            n += ds.num_examples()
        return total / n if (self.average and n) else total


# -------------------------------------------------------------- configuration

@dataclasses.dataclass
class EarlyStoppingConfiguration:
    epoch_termination_conditions: List[EpochTerminationCondition] = dataclasses.field(default_factory=list)
    iteration_termination_conditions: List[IterationTerminationCondition] = dataclasses.field(default_factory=list)
    score_calculator: Optional[DataSetLossCalculator] = None
    model_saver: object = dataclasses.field(default_factory=InMemoryModelSaver)
    save_last_model: bool = False
    evaluate_every_n_epochs: int = 1


@dataclasses.dataclass
class EarlyStoppingResult:
    termination_reason: str
    termination_details: str
    total_epochs: int
    best_model_epoch: int
    best_model_score: float
    best_model: object


class EarlyStoppingTrainer:
    """Train epochs until a termination condition holds, scoring every
    ``evaluate_every_n_epochs`` and keeping the best model; for
    MultiLayerNetwork and ComputationGraph alike."""

    def __init__(self, config: EarlyStoppingConfiguration, model, train_iterator: DataSetIterator):
        self.config = config
        self.model = model
        self.iterator = train_iterator

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        for c in cfg.epoch_termination_conditions:
            c.initialize()
        for c in cfg.iteration_termination_conditions:
            c.initialize()
        best_score = float("inf")
        best_epoch = -1
        epoch = 0
        reason, details = "EpochTerminationCondition", ""
        while True:
            self.iterator.reset()
            stop_iter = False
            for ds in self.iterator:
                self.model.fit(ds)
                last = self.model.score()
                for c in cfg.iteration_termination_conditions:
                    if c.terminate(last):
                        reason = "IterationTerminationCondition"
                        details = type(c).__name__
                        stop_iter = True
                        break
                if stop_iter:
                    break
            if stop_iter:
                break
            # scored and saved every N epochs; the termination conditions
            # are read every epoch, so that MaxEpochs never overshoots
            if epoch % cfg.evaluate_every_n_epochs == 0:
                if cfg.score_calculator is not None:
                    score = cfg.score_calculator.calculate_score(self.model)
                else:
                    score = self.model.score()
                if score < best_score:
                    best_score = score
                    best_epoch = epoch
                    cfg.model_saver.save_best_model(self.model, score)
                if cfg.save_last_model:
                    cfg.model_saver.save_latest_model(self.model, score)
            terminated = False
            for c in cfg.epoch_termination_conditions:
                if c.terminate(epoch, score if epoch % cfg.evaluate_every_n_epochs == 0
                               else best_score):
                    reason = "EpochTerminationCondition"
                    details = type(c).__name__
                    terminated = True
                    break
            if terminated:
                break
            epoch += 1
        return EarlyStoppingResult(
            termination_reason=reason, termination_details=details,
            total_epochs=epoch + 1, best_model_epoch=best_epoch,
            best_model_score=best_score,
            best_model=cfg.model_saver.get_best_model() or self.model)
