"""Binary ROC and AUC over a fixed grid of thresholds.

Counterpart of ``deeplearning4j_tpu/eval/roc.py`` (the port's own copy;
numpy only): the counts of true and false positives at each of
``threshold_steps + 1`` thresholds accumulate over minibatches without
keeping the scores; ``get_roc_curve`` and the trapezoidal
``calculate_auc`` read them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class ROC:
    def __init__(self, threshold_steps: int = 100):
        self.steps = threshold_steps
        self.thresholds = np.linspace(0.0, 1.0, threshold_steps + 1)
        self.tp = np.zeros(threshold_steps + 1, np.int64)
        self.fp = np.zeros(threshold_steps + 1, np.int64)
        self.pos = 0
        self.neg = 0

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None):
        """labels: [b] {0,1} or [b,2] one-hot; predictions: P(class 1)
        as [b] or [b,2]."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 2:
            labels = labels[:, 1]
        if predictions.ndim == 2:
            predictions = predictions[:, 1]
        if mask is not None:
            keep = np.asarray(mask).reshape(-1) > 0
            labels, predictions = labels[keep], predictions[keep]
        pos = labels > 0.5
        self.pos += int(pos.sum())
        self.neg += int((~pos).sum())
        # predicted positive at threshold t: score >= t.
        # searchsorted(thresholds, p, 'right') counts the thresholds <= p,
        # the grid points at which this sample is predicted positive, and
        # a histogram's tail sums turn the counts into per-threshold totals
        def _accumulate(counts: np.ndarray, into: np.ndarray) -> None:
            hist = np.bincount(counts, minlength=self.steps + 2)
            tail = hist[::-1].cumsum()[::-1]  # tail[k] = #samples cnt>=k
            into += tail[1:]  # contributes at index i iff cnt >= i+1
        cnt = np.searchsorted(self.thresholds, predictions, side="right")
        # NaN sorts after every threshold, but `p >= t` holds for no
        # threshold: a NaN score is predicted positive nowhere
        cnt = np.where(np.isnan(predictions), 0, cnt)
        _accumulate(cnt[pos], self.tp)
        _accumulate(cnt[~pos], self.fp)

    def get_roc_curve(self) -> List[Tuple[float, float, float]]:
        """[(threshold, fpr, tpr)]"""
        out = []
        for i, t in enumerate(self.thresholds):
            tpr = self.tp[i] / self.pos if self.pos else 0.0
            fpr = self.fp[i] / self.neg if self.neg else 0.0
            out.append((float(t), float(fpr), float(tpr)))
        return out

    def calculate_auc(self) -> float:
        """Trapezoidal AUC over the threshold grid (``ROC.calculateAUC``)."""
        pts = sorted((fpr, tpr) for _, fpr, tpr in self.get_roc_curve())
        xs = np.array([0.0] + [p[0] for p in pts] + [1.0])
        ys = np.array([0.0] + [p[1] for p in pts] + [1.0])
        return float(np.trapezoid(ys, xs))
