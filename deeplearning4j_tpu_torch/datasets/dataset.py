"""The DataSet and MultiDataSet containers.

Counterpart of ``deeplearning4j_tpu/datasets/dataset.py``: ``DataSet``
holds features, labels and the two optional masks, ``MultiDataSet`` a
list of each (the ComputationGraph's currency: features in the graph's
input order, labels in its output order), as numpy arrays on the host
(a batch staged by ``fit``'s feed pipeline holds tensors on the net's
device); ``fit``/``score`` move them to the net's device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class DataSet:
    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def split_test_and_train(self, n_train: int) -> Tuple["DataSet", "DataSet"]:
        """(the first ``n_train`` rows, the rest)."""
        return self[:n_train], self[n_train:]

    def shuffle(self, seed: Optional[int] = None) -> "DataSet":
        """The rows in the order of numpy ``default_rng(seed)``'s
        permutation, as the reference's."""
        return self[np.random.default_rng(seed).permutation(self.num_examples())]

    def __getitem__(self, idx) -> "DataSet":
        pick = lambda a: None if a is None else a[idx]  # noqa: E731
        return DataSet(self.features[idx], self.labels[idx],
                       pick(self.features_mask), pick(self.labels_mask))

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        """Consecutive minibatches of ``batch_size`` rows (the last may
        be short)."""
        n = self.num_examples()
        return [self[i:i + batch_size] for i in range(0, n, batch_size)]

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        """The rows of ``datasets`` in order; a mask is kept where the
        first DataSet has one."""
        cat = lambda key: (None if getattr(datasets[0], key) is None  # noqa: E731
                           else np.concatenate([getattr(d, key) for d in datasets]))
        return DataSet(cat("features"), cat("labels"), cat("features_mask"),
                       cat("labels_mask"))


@dataclasses.dataclass
class MultiDataSet:
    """Multi-input/multi-output sample batch."""

    features: List[np.ndarray]
    labels: List[np.ndarray]
    features_masks: Optional[List[Optional[np.ndarray]]] = None
    labels_masks: Optional[List[Optional[np.ndarray]]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])

    def __getitem__(self, idx) -> "MultiDataSet":
        pick = lambda arrs: None if arrs is None else [  # noqa: E731
            None if a is None else a[idx] for a in arrs]
        return MultiDataSet([f[idx] for f in self.features],
                            [y[idx] for y in self.labels],
                            pick(self.features_masks), pick(self.labels_masks))

    def batch_by(self, batch_size: int) -> List["MultiDataSet"]:
        n = self.num_examples()
        return [self[i:i + batch_size] for i in range(0, n, batch_size)]

    def shuffle(self, seed: Optional[int] = None) -> "MultiDataSet":
        """The rows in the order of numpy ``default_rng(seed)``'s
        permutation, as the reference's."""
        return self[np.random.default_rng(seed).permutation(self.num_examples())]
