"""Classification evaluation: confusion matrix, accuracy, precision,
recall and F1, and per-example metadata by confusion cell.

Counterpart of ``deeplearning4j_tpu/eval/evaluation.py``, the same code:
host-side numpy over accumulated confusion counts; the device runs only
the forward pass (``MultiLayerNetwork.evaluate``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class ConfusionMatrix:
    """Counts[actual][predicted] (``ConfusionMatrix.java``)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.counts = np.zeros((num_classes, num_classes), dtype=np.int64)

    def add(self, actual: int, predicted: int, count: int = 1):
        self.counts[actual, predicted] += count

    def add_batch(self, actual: np.ndarray, predicted: np.ndarray):
        np.add.at(self.counts, (actual, predicted), 1)

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.counts[actual, predicted])

    def __str__(self):
        return str(self.counts)


class Evaluation:
    """Accumulating classification evaluator.

    ``eval(labels, predictions)`` accepts one-hot (or probability) arrays
    of shape [b, C] or time-series [b, T, C] with an optional [b, T] mask
    (the reference reshapes time series to 2d + mask filter).
    """

    def __init__(self, num_classes: Optional[int] = None,
                 labels_list: Optional[Sequence[str]] = None):
        self.labels_list = list(labels_list) if labels_list else None
        if num_classes is None and labels_list is not None:
            num_classes = len(labels_list)
        self._n = num_classes
        self.confusion: Optional[ConfusionMatrix] = None
        self.record_meta: List[Any] = []
        self._meta_by_cell: Dict[tuple, list] = {}

    def _ensure(self, n: int):
        if self.confusion is None:
            self._n = self._n or n
            self.confusion = ConfusionMatrix(self._n)

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None,
             meta: Optional[Sequence[Any]] = None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        # sparse integer-id labels (ops/losses.py convention): one dim
        # fewer than predictions; negative ids = ignore-index
        sparse = labels.ndim == predictions.ndim - 1
        if predictions.ndim == 3:  # [b,t,c] time series -> flatten w/ mask
            b, t = predictions.shape[:2]
            keep = (np.asarray(mask).reshape(-1) > 0) if mask is not None \
                else np.ones(b * t, bool)
            predictions = predictions.reshape(-1, predictions.shape[-1])[keep]
            labels = (labels.reshape(-1)[keep] if sparse
                      else labels.reshape(-1, labels.shape[-1])[keep])
            if meta is not None:  # per-example meta -> per-kept-timestep
                meta = np.repeat(np.asarray(meta, dtype=object), t)[keep]
        self._ensure(predictions.shape[-1])
        if sparse:
            actual = labels.astype(np.int64)
            width = predictions.shape[-1]
            if actual.size and actual.max() >= width:
                bad = int(actual.max())
                raise ValueError(
                    f"sparse label id {bad} is out of range for predictions "
                    f"with {width} classes (valid ids: 0..{width - 1}; "
                    f"negative ids mean ignore-index). The training loss "
                    f"clamps out-of-range ids, but evaluation refuses them "
                    f"so a vocabulary/label mismatch is caught loudly.")
            valid = actual >= 0
            actual, predictions = actual[valid], predictions[valid]
            if meta is not None:
                meta = np.asarray(meta, dtype=object)[valid]
        else:
            actual = np.argmax(labels, axis=-1)
        pred = np.argmax(predictions, axis=-1)
        self.confusion.add_batch(actual, pred)
        if meta is not None:
            for a, p, m in zip(actual, pred, meta):
                self._meta_by_cell.setdefault((int(a), int(p)), []).append(m)

    # ---- metrics (ConfusionMatrix-derived, reference formulas) ----

    def _tp(self) -> np.ndarray:
        return np.diag(self.confusion.counts).astype(np.float64)

    def _fp(self) -> np.ndarray:
        return self.confusion.counts.sum(axis=0) - self._tp()

    def _fn(self) -> np.ndarray:
        return self.confusion.counts.sum(axis=1) - self._tp()

    def accuracy(self) -> float:
        c = self.confusion.counts
        total = c.sum()
        return float(np.diag(c).sum() / total) if total else 0.0

    def precision(self, cls: Optional[int] = None) -> float:
        tp, fp = self._tp(), self._fp()
        if cls is not None:
            d = tp[cls] + fp[cls]
            return float(tp[cls] / d) if d else 0.0
        # macro-average over classes that appear (reference behavior)
        with np.errstate(invalid="ignore", divide="ignore"):
            per = np.where(tp + fp > 0, tp / (tp + fp), np.nan)
        return float(np.nanmean(per))

    def recall(self, cls: Optional[int] = None) -> float:
        tp, fn = self._tp(), self._fn()
        if cls is not None:
            d = tp[cls] + fn[cls]
            return float(tp[cls] / d) if d else 0.0
        with np.errstate(invalid="ignore", divide="ignore"):
            per = np.where(tp + fn > 0, tp / (tp + fn), np.nan)
        return float(np.nanmean(per))

    def f1(self, cls: Optional[int] = None) -> float:
        p = self.precision(cls)
        r = self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0

    def false_positive_rate(self, cls: int) -> float:
        c = self.confusion.counts
        fp = c[:, cls].sum() - c[cls, cls]
        tn = c.sum() - c[cls, :].sum() - c[:, cls].sum() + c[cls, cls]
        return float(fp / (fp + tn)) if (fp + tn) else 0.0

    def get_meta(self, actual: int, predicted: int) -> list:
        """Per-example metadata attribution (``eval/meta/``)."""
        return self._meta_by_cell.get((actual, predicted), [])

    def stats(self) -> str:
        """Human-readable report (``Evaluation.stats()``)."""
        lines = [
            "==========================Scores========================================",
            f" Accuracy:  {self.accuracy():.4f}",
            f" Precision: {self.precision():.4f}",
            f" Recall:    {self.recall():.4f}",
            f" F1 Score:  {self.f1():.4f}",
            "========================================================================",
        ]
        return "\n".join(lines)
