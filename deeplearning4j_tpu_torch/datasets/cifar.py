"""CIFAR-10: the binary-format reader, the synthetic fallback and the
iterator.

Counterpart of ``deeplearning4j_tpu/datasets/cifar.py``. The loader
reads the ``cifar-10-batches-bin`` files (1 label byte and 3072 CHW
pixel bytes per record) from the reference's directories where they are
present, and otherwise builds, with a warning, the reference's
deterministic synthetic set of the same shapes: the same arrays from the
same seed. Nothing is downloaded.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator

_CIFAR_DIRS = [
    os.path.expanduser("~/.deeplearning4j_tpu/cifar10"),
    "/root/data/cifar10",
    "/tmp/cifar-10-batches-bin",
]
_TRAIN_FILES = [f"data_batch_{i}.bin" for i in range(1, 6)]
_TEST_FILES = ["test_batch.bin"]
NUM_CLASSES = 10


def _find_dir() -> Optional[str]:
    for d in _CIFAR_DIRS:
        if os.path.isdir(d) and os.path.exists(os.path.join(d, _TRAIN_FILES[0])):
            return d
    return None


def _read_bin(path: str) -> tuple:
    """(uint8 NHWC images, int64 labels) of one binary file."""
    raw = np.fromfile(path, np.uint8).reshape(-1, 3073)
    labels = raw[:, 0].astype(np.int64)
    images = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return images, labels


def _synthetic_cifar(n: int, seed: int) -> tuple:
    """(uint8 [n, 32, 32, 3] images, labels): each class a smooth 8 x 8
    prototype upsampled 4x, plus noise."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, NUM_CLASSES, n)
    protos = rng.normal(128, 40, (NUM_CLASSES, 8, 8, 3))
    images = np.empty((n, 32, 32, 3), np.uint8)
    for i, lab in enumerate(labels):
        up = np.kron(protos[lab], np.ones((4, 4, 1)))
        noise = rng.normal(0, 25, (32, 32, 3))
        images[i] = np.clip(up + noise, 0, 255).astype(np.uint8)
    return images, labels


def load_cifar10(train: bool = True, num_examples: Optional[int] = None,
                 seed: int = 123) -> DataSet:
    """Features [n, 32, 32, 3] scaled to [0, 1]; labels one-hot [n, 10]."""
    d = _find_dir()
    if d is not None:
        parts = [_read_bin(os.path.join(d, f))
                 for f in (_TRAIN_FILES if train else _TEST_FILES)]
        images = np.concatenate([p[0] for p in parts])
        labels = np.concatenate([p[1] for p in parts])
    else:
        logging.getLogger("deeplearning4j_tpu_torch").warning(
            "CIFAR-10 binaries not found in %s: using SYNTHETIC images. "
            "Throughput numbers are valid; accuracy claims are NOT.",
            _CIFAR_DIRS)
        n = num_examples or (50000 if train else 10000)
        images, labels = _synthetic_cifar(n, seed + (0 if train else 1))
    if num_examples is not None:
        images, labels = images[:num_examples], labels[:num_examples]
    x = images.astype(np.float32) / 255.0
    y = np.eye(NUM_CLASSES, dtype=np.float32)[labels]
    return DataSet(x, y)


class CifarDataSetIterator(ListDataSetIterator):
    """Minibatches of ``load_cifar10``."""

    def __init__(self, batch: int, num_examples: int = 50000, train: bool = True,
                 shuffle: bool = False, seed: int = 123):
        super().__init__(load_cifar10(train, num_examples, seed), batch,
                         shuffle=shuffle, seed=seed)
