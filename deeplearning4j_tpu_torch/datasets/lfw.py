"""LFW (Labeled Faces in the Wild): the image-tree loader, the synthetic
fallback and the iterator.

Counterpart of ``deeplearning4j_tpu/datasets/lfw.py``. A directory per
person, found on the reference's paths, is read through
``ImageRecordReader`` (PIL); without one the loader builds, with a
warning, the reference's deterministic synthetic faces: the same arrays
from the same seed. Nothing is downloaded.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.datavec.iterator import RecordReaderDataSetIterator
from deeplearning4j_tpu_torch.datavec.records import ImageRecordReader

_LFW_DIRS = [
    os.path.expanduser("~/.deeplearning4j_tpu/lfw"),
    "/root/data/lfw",
    "/tmp/lfw",
]


def _find_dir() -> Optional[str]:
    for d in _LFW_DIRS:
        if os.path.isdir(d) and any(
                os.path.isdir(os.path.join(d, s)) for s in os.listdir(d)):
            return d
    return None


def _synthetic_lfw(n: int, num_people: int, size: Tuple[int, int],
                   seed: int) -> DataSet:
    """Each person a smooth prototype (a quarter of the size, upsampled
    4x) plus noise; features in [0, 1], labels one-hot."""
    rng = np.random.default_rng(seed)
    h, w = size
    labels = rng.integers(0, num_people, n)
    protos = rng.normal(128, 30, (num_people, h // 4, w // 4, 3))
    x = np.empty((n, h, w, 3), np.float32)
    for i, lab in enumerate(labels):
        up = np.kron(protos[lab], np.ones((4, 4, 1)))
        x[i] = np.clip(up + rng.normal(0, 20, (h, w, 3)), 0, 255)
    y = np.eye(num_people, dtype=np.float32)[labels]
    return DataSet(x / 255.0, y)


def load_lfw(num_examples: Optional[int] = None,
             image_size: Tuple[int, int] = (64, 64), seed: int = 123) -> DataSet:
    """Features [n, h, w, 3] in [0, 1]; labels one-hot over people."""
    d = _find_dir()
    if d is None:
        logging.getLogger("deeplearning4j_tpu_torch").warning(
            "LFW image tree not found in %s: using SYNTHETIC faces. "
            "Throughput numbers are valid; accuracy claims are NOT.", _LFW_DIRS)
        return _synthetic_lfw(num_examples or 1024, 16, image_size, seed)
    h, w = image_size
    reader = ImageRecordReader(h, w, channels=3, root_dir=d)
    n = reader.num_records() if num_examples is None else min(
        num_examples, reader.num_records())
    ds = RecordReaderDataSetIterator(reader, n, num_classes=len(reader.labels)).next()
    return DataSet(ds.features / 255.0, ds.labels)


class LFWDataSetIterator(ListDataSetIterator):
    """Minibatches of ``load_lfw``."""

    def __init__(self, batch: int, num_examples: int = 1024,
                 image_size: Tuple[int, int] = (64, 64), shuffle: bool = False,
                 seed: int = 123):
        super().__init__(load_lfw(num_examples, image_size, seed), batch,
                         shuffle=shuffle, seed=seed)
