"""The DataSet container.

Counterpart of ``deeplearning4j_tpu/datasets/dataset.py`` ``DataSet``:
features, labels and the two optional masks, as numpy arrays on the
host; ``fit``/``score`` move them to the net's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class DataSet:
    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def shuffle(self, seed: Optional[int] = None) -> "DataSet":
        """The rows in the order of numpy ``default_rng(seed)``'s
        permutation, as the reference's."""
        return self[np.random.default_rng(seed).permutation(self.num_examples())]

    def __getitem__(self, idx) -> "DataSet":
        pick = lambda a: None if a is None else a[idx]  # noqa: E731
        return DataSet(self.features[idx], self.labels[idx],
                       pick(self.features_mask), pick(self.labels_mask))
