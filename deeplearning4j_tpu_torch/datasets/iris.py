"""The Iris data set and its iterator.

Counterpart of ``deeplearning4j_tpu/datasets/iris.py``, which reads
scikit-learn's copy of the 150 rows; the port carries its own copy of
that file (``iris.csv`` beside this module: a header row, then four
features and the class id per row), so it needs neither scikit-learn
nor a download. Features are min-max scaled to [0, 1], labels one-hot
(3 classes).
"""

from __future__ import annotations

import os

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator

IRIS_CSV = os.path.join(os.path.dirname(os.path.abspath(__file__)), "iris.csv")


def iris_rows():
    """(features [150, 4] float64, class ids [150] int64), as stored."""
    rows = np.loadtxt(IRIS_CSV, delimiter=",", skiprows=1)
    return rows[:, :4], rows[:, 4].astype(np.int64)


def load_iris_dataset(normalize: bool = True,
                      shuffle_seed: int | None = None) -> DataSet:
    x, target = iris_rows()
    if normalize:
        x = (x - x.min(axis=0)) / (x.max(axis=0) - x.min(axis=0))
    ds = DataSet(x, np.eye(3, dtype=np.float64)[target])
    return ds if shuffle_seed is None else ds.shuffle(shuffle_seed)


class IrisDataSetIterator(ListDataSetIterator):
    """``IrisDataSetIterator(batch, numExamples)``."""

    def __init__(self, batch: int = 150, num_examples: int = 150, seed: int = 6):
        super().__init__(load_iris_dataset(shuffle_seed=seed)[:num_examples],
                         batch)
