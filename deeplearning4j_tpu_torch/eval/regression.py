"""Regression metrics per output column: MSE, MAE, RMSE, R² and
Pearson correlation.

Counterpart of ``deeplearning4j_tpu/eval/regression.py`` (the port's own
copy; numpy only): sufficient statistics per column accumulate in f64
over minibatches (time series flattened over the kept steps of a mask).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class RegressionEvaluation:
    def __init__(self, num_columns: Optional[int] = None,
                 column_names: Optional[Sequence[str]] = None):
        self.column_names = list(column_names) if column_names else None
        if num_columns is None and column_names is not None:
            num_columns = len(column_names)
        self._n = num_columns
        self._init_done = False

    def _ensure(self, n: int):
        if not self._init_done:
            self._n = self._n or n
            z = lambda: np.zeros(self._n, np.float64)
            self.count = z()
            self.sum_abs_err = z()
            self.sum_sq_err = z()
            self.sum_label = z()
            self.sum_label_sq = z()
            self.sum_pred = z()
            self.sum_pred_sq = z()
            self.sum_label_pred = z()
            self._init_done = True

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None):
        labels = np.asarray(labels, np.float64)
        predictions = np.asarray(predictions, np.float64)
        if labels.ndim == 3:
            keep = (np.asarray(mask).reshape(-1) > 0) if mask is not None \
                else np.ones(labels.shape[0] * labels.shape[1], bool)
            labels = labels.reshape(-1, labels.shape[-1])[keep]
            predictions = predictions.reshape(-1, predictions.shape[-1])[keep]
        self._ensure(labels.shape[-1])
        err = predictions - labels
        self.count += labels.shape[0]
        self.sum_abs_err += np.abs(err).sum(axis=0)
        self.sum_sq_err += (err ** 2).sum(axis=0)
        self.sum_label += labels.sum(axis=0)
        self.sum_label_sq += (labels ** 2).sum(axis=0)
        self.sum_pred += predictions.sum(axis=0)
        self.sum_pred_sq += (predictions ** 2).sum(axis=0)
        self.sum_label_pred += (labels * predictions).sum(axis=0)

    def mean_squared_error(self, col: int) -> float:
        return float(self.sum_sq_err[col] / self.count[col])

    def mean_absolute_error(self, col: int) -> float:
        return float(self.sum_abs_err[col] / self.count[col])

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def r_squared(self, col: int) -> float:
        n = self.count[col]
        ss_tot = self.sum_label_sq[col] - self.sum_label[col] ** 2 / n
        ss_res = self.sum_sq_err[col]
        return float(1.0 - ss_res / ss_tot) if ss_tot > 0 else 0.0

    def pearson_correlation(self, col: int) -> float:
        n = self.count[col]
        cov = self.sum_label_pred[col] - self.sum_label[col] * self.sum_pred[col] / n
        vl = self.sum_label_sq[col] - self.sum_label[col] ** 2 / n
        vp = self.sum_pred_sq[col] - self.sum_pred[col] ** 2 / n
        d = np.sqrt(vl * vp)
        return float(cov / d) if d > 0 else 0.0

    def stats(self) -> str:
        cols = range(self._n)
        lines = ["column  MSE        MAE        RMSE       R^2        corr"]
        for c in cols:
            name = self.column_names[c] if self.column_names else str(c)
            lines.append(f"{name:7s} {self.mean_squared_error(c):.4e} "
                         f"{self.mean_absolute_error(c):.4e} "
                         f"{self.root_mean_squared_error(c):.4e} "
                         f"{self.r_squared(c):.4f}    {self.pearson_correlation(c):.4f}")
        return "\n".join(lines)
