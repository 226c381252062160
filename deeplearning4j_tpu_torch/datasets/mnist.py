"""MNIST: an IDX-format reader, the synthetic fallback and the iterator.

Counterpart of ``deeplearning4j_tpu/datasets/mnist.py``. The loader
reads the four IDX files where they are present (the same directories
as the reference) and otherwise builds the reference's deterministic
synthetic set: class-conditional gaussian blobs with noise, the same
arrays from the same seed (both draw from numpy's ``default_rng``).
Nothing is downloaded.
"""

from __future__ import annotations

import gzip
import logging
import os
import struct
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator

_MNIST_DIRS = [
    os.path.expanduser("~/.deeplearning4j_tpu/mnist"),
    "/root/data/mnist",
    "/tmp/mnist",
]

# IDX type codes; the payload is big-endian
_IDX_DTYPES = {0x08: np.dtype(np.uint8), 0x09: np.dtype(np.int8),
               0x0B: np.dtype(">i2"), 0x0C: np.dtype(">i4"),
               0x0D: np.dtype(">f4"), 0x0E: np.dtype(">f8")}


def read_idx(path: str) -> np.ndarray:
    """An IDX file (gzipped when its name ends in ``.gz``) as an array in
    native byte order; an uncompressed one through the native reader
    (``native.idx_read``) where the library is available."""
    from deeplearning4j_tpu_torch.native import idx_read
    arr = idx_read(path)
    if arr is not None:
        return arr
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    zeros, dtype_code, ndim = struct.unpack(">HBB", data[:4])
    if zeros != 0 or dtype_code not in _IDX_DTYPES:
        raise ValueError(f"bad IDX magic in {path}")
    dims = struct.unpack(f">{ndim}I", data[4:4 + 4 * ndim])
    dt = _IDX_DTYPES[dtype_code]
    arr = np.frombuffer(data, dt, offset=4 + 4 * ndim).reshape(dims)
    return arr.astype(dt.newbyteorder("=")) if dt.byteorder == ">" else arr


def _find_idx(name: str) -> Optional[str]:
    for d in _MNIST_DIRS:
        for suffix in ("", ".gz"):
            p = os.path.join(d, name + suffix)
            if os.path.exists(p):
                return p
    return None


def _synthetic_mnist(n: int, seed: int, train: bool
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """MNIST-shaped uint8 images [n, 28, 28] and int labels [n]: each
    class a gaussian blob at its own place, plus noise."""
    rng = np.random.default_rng(seed + (0 if train else 1))
    labels = rng.integers(0, 10, n)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    cx = 6 + 2.0 * (labels % 5)
    cy = 7 + 9.0 * (labels // 5)
    d2 = (xx[None] - cx[:, None, None]) ** 2 + (yy[None] - cy[:, None, None]) ** 2
    img = np.exp(-d2 / (2 * 4.0)) * 255.0
    img += rng.normal(0, 16.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8), labels


def load_mnist(train: bool = True, num_examples: Optional[int] = None,
               seed: int = 123) -> DataSet:
    """Features [n, 784] scaled to [0, 1]; labels one-hot [n, 10]."""
    img_name = "train-images-idx3-ubyte" if train else "t10k-images-idx3-ubyte"
    lbl_name = "train-labels-idx1-ubyte" if train else "t10k-labels-idx1-ubyte"
    img_path, lbl_path = _find_idx(img_name), _find_idx(lbl_name)
    if img_path and lbl_path:
        images, labels = read_idx(img_path), read_idx(lbl_path)
    else:
        logging.getLogger("deeplearning4j_tpu_torch").warning(
            "MNIST IDX files not found in %s: using SYNTHETIC class-"
            "conditional blobs. Throughput numbers are valid; accuracy "
            "claims on this data are NOT.", _MNIST_DIRS)
        n = num_examples or (60000 if train else 10000)
        images, labels = _synthetic_mnist(n, seed, train)
    if num_examples is not None:
        images, labels = images[:num_examples], labels[:num_examples]
    x = images.reshape(len(images), -1).astype(np.float32) / 255.0
    y = np.eye(10, dtype=np.float32)[labels]
    return DataSet(x, y)


class MnistDataSetIterator(ListDataSetIterator):
    """Minibatches of ``load_mnist``."""

    def __init__(self, batch: int, num_examples: int = 60000, train: bool = True,
                 shuffle: bool = False, seed: int = 123):
        super().__init__(load_mnist(train, num_examples, seed), batch,
                         shuffle=shuffle, seed=seed)
