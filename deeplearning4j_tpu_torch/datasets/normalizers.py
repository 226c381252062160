"""Feature normalizers: standardize, min-max and image scaling.

Counterpart of ``deeplearning4j_tpu/datasets/normalizers.py``:
``NormalizerStandardize``, ``NormalizerMinMaxScaler`` and
``ImagePreProcessingScaler``. Each ``fit``s over a DataSet or an
iterator (one pass in float64; the timesteps a sequence's features mask
zeroes are left out), then ``transform``/``revert`` a DataSet's
features, and plugs into ``set_pre_processor`` (``pre_process`` is
``transform``). ``save``/``load`` write and read the statistics as the
reference's JSON, so a file saved by either package loads in the other.
"""

from __future__ import annotations

import json
from typing import Optional, Union

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator


def _with_features(ds: DataSet, x: np.ndarray) -> DataSet:
    return DataSet(x, ds.labels, ds.features_mask, ds.labels_mask)


class Normalizer:
    def fit(self, data: Union[DataSet, DataSetIterator]) -> "Normalizer":
        raise NotImplementedError

    def pre_process(self, ds: DataSet) -> DataSet:
        """The pre-processor seam: a fitted normalizer transforms every
        batch an iterator emits."""
        return self.transform(ds)

    def transform(self, ds: DataSet) -> DataSet:
        raise NotImplementedError

    def revert(self, ds: DataSet) -> DataSet:
        raise NotImplementedError

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self._state(), f)

    @classmethod
    def load(cls, path: str) -> "Normalizer":
        with open(path) as f:
            state = json.load(f)
        obj = cls.__new__(cls)
        obj._set_state(state)
        return obj

    @staticmethod
    def _moments(data):
        """(n, sum, sum of squares, min, max) per feature over every row
        (and unmasked timestep) of ``data``, in float64."""
        batches = [data] if isinstance(data, DataSet) else data
        n, s, ss, mn, mx = 0, None, None, None, None
        for ds in batches:
            x = np.asarray(ds.features, np.float64)
            x2 = x.reshape(-1, x.shape[-1])
            if ds.features_mask is not None and x.ndim == 3:
                x2 = x2[np.asarray(ds.features_mask, bool).reshape(-1)]
            if x2.shape[0] == 0:
                continue
            n += x2.shape[0]
            s = x2.sum(0) if s is None else s + x2.sum(0)
            ss = (x2 ** 2).sum(0) if ss is None else ss + (x2 ** 2).sum(0)
            bmn, bmx = x2.min(0), x2.max(0)
            mn = bmn if mn is None else np.minimum(mn, bmn)
            mx = bmx if mx is None else np.maximum(mx, bmx)
        return n, s, ss, mn, mx


class NormalizerStandardize(Normalizer):
    """Zero mean and unit variance per feature."""

    def __init__(self):
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    def fit(self, data):
        n, s, ss, _, _ = self._moments(data)
        self.mean = (s / n).astype(np.float32)
        var = ss / n - (s / n) ** 2
        self.std = np.sqrt(np.maximum(var, 1e-12)).astype(np.float32)
        return self

    def transform(self, ds: DataSet) -> DataSet:
        return _with_features(
            ds, (np.asarray(ds.features, np.float32) - self.mean) / self.std)

    def revert(self, ds: DataSet) -> DataSet:
        return _with_features(
            ds, np.asarray(ds.features, np.float32) * self.std + self.mean)

    def _state(self):
        return {"kind": "standardize", "mean": self.mean.tolist(),
                "std": self.std.tolist()}

    def _set_state(self, st):
        self.mean = np.asarray(st["mean"], np.float32)
        self.std = np.asarray(st["std"], np.float32)


class NormalizerMinMaxScaler(Normalizer):
    """Each feature scaled to [lo, hi]."""

    def __init__(self, lo: float = 0.0, hi: float = 1.0):
        self.lo, self.hi = lo, hi
        self.min: Optional[np.ndarray] = None
        self.max: Optional[np.ndarray] = None

    def fit(self, data):
        _, _, _, mn, mx = self._moments(data)
        self.min = mn.astype(np.float32)
        self.max = mx.astype(np.float32)
        return self

    def _scale(self):
        return np.maximum(self.max - self.min, 1e-12)

    def transform(self, ds: DataSet) -> DataSet:
        x = (np.asarray(ds.features, np.float32) - self.min) / self._scale()
        return _with_features(ds, x * (self.hi - self.lo) + self.lo)

    def revert(self, ds: DataSet) -> DataSet:
        x = (np.asarray(ds.features, np.float32) - self.lo) / (self.hi - self.lo)
        return _with_features(ds, x * self._scale() + self.min)

    def _state(self):
        return {"kind": "minmax", "lo": self.lo, "hi": self.hi,
                "min": self.min.tolist(), "max": self.max.tolist()}

    def _set_state(self, st):
        self.lo, self.hi = st["lo"], st["hi"]
        self.min = np.asarray(st["min"], np.float32)
        self.max = np.asarray(st["max"], np.float32)


class ImagePreProcessingScaler(Normalizer):
    """Pixels in [0, 255] scaled to [lo, hi]; nothing to fit."""

    def __init__(self, lo: float = 0.0, hi: float = 1.0):
        self.lo, self.hi = lo, hi

    def fit(self, data):
        return self

    def transform(self, ds: DataSet) -> DataSet:
        x = np.asarray(ds.features, np.float32) / 255.0
        return _with_features(ds, x * (self.hi - self.lo) + self.lo)

    def revert(self, ds: DataSet) -> DataSet:
        x = (np.asarray(ds.features, np.float32) - self.lo) / (self.hi - self.lo) * 255.0
        return _with_features(ds, x)

    def _state(self):
        return {"kind": "image", "lo": self.lo, "hi": self.hi}

    def _set_state(self, st):
        self.lo, self.hi = st["lo"], st["hi"]
