"""Minibatch assembly on the host by the native thread pool.

Counterpart of ``deeplearning4j_tpu/datasets/native_batcher.py``: the
batch-assembly half of the native IO library (``native/io_kernels.cpp``;
its parsing half reads CSV and IDX). ``gather_rows`` takes rows by index
(a shuffled minibatch), optionally fused with per-column
standardization, and ``one_hot`` expands integer labels, each in C++
worker threads through ctypes, or in NumPy where the library is not
available, with the same results bit for bit. ``NativeBatchIterator``
serves shuffled minibatches assembled so; ``fit``'s feed pipeline runs
it on its host thread while the card runs the step before.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator, _ListBatchCore

_FP = ctypes.POINTER(ctypes.c_float)
_LP = ctypes.POINTER(ctypes.c_int64)


def _bind(lib) -> bool:
    """Declare the batch kernels' signatures once; False for a library
    without them."""
    if hasattr(lib, "_batcher_bound"):
        return True
    try:
        lib.dl4j_gather_rows.argtypes = [_FP, ctypes.c_int64, ctypes.c_int64,
                                         _LP, ctypes.c_int64, _FP, ctypes.c_int]
        lib.dl4j_gather_rows.restype = ctypes.c_int64
        lib.dl4j_gather_normalize.argtypes = [_FP, ctypes.c_int64,
                                              ctypes.c_int64, _LP,
                                              ctypes.c_int64, _FP, _FP, _FP,
                                              ctypes.c_int]
        lib.dl4j_gather_normalize.restype = ctypes.c_int64
        lib.dl4j_onehot.argtypes = [_LP, ctypes.c_int64, ctypes.c_int64, _FP,
                                    ctypes.c_int]
        lib.dl4j_onehot.restype = ctypes.c_int64
    except AttributeError:
        return False
    lib._batcher_bound = True
    return True


def _lib():
    lib = native.get_lib()
    return lib if lib is not None and _bind(lib) else None


def _as_f32_2d(a: np.ndarray) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """A C-contiguous float32 [rows, elements] view, and the trailing
    shape to give the batch back."""
    a = np.ascontiguousarray(a, np.float32)
    return a.reshape(a.shape[0], -1), a.shape[1:]


def gather_rows(src: np.ndarray, idx: np.ndarray,
                mean: Optional[np.ndarray] = None,
                std: Optional[np.ndarray] = None,
                threads: int = 0) -> np.ndarray:
    """``out[i] = src[idx[i]]`` as float32, standardized by ``(x - mean)
    / std`` per column (a zero std reads 1) when both are given. An
    index out of range raises ``IndexError``."""
    if (mean is None) != (std is None):
        raise ValueError("pass BOTH mean and std (or neither)")
    flat, tail = _as_f32_2d(src)
    idx = np.ascontiguousarray(idx, np.int64)
    lib = _lib()
    if lib is not None:
        out = np.empty((len(idx), flat.shape[1]), np.float32)
        if mean is None:
            rc = lib.dl4j_gather_rows(
                flat.ctypes.data_as(_FP), flat.shape[0], flat.shape[1],
                idx.ctypes.data_as(_LP), len(idx), out.ctypes.data_as(_FP),
                threads)
        else:
            m = np.ascontiguousarray(np.broadcast_to(
                np.asarray(mean, np.float32).reshape(-1), flat.shape[1:]))
            sd = np.ascontiguousarray(np.broadcast_to(
                np.asarray(std, np.float32).reshape(-1), flat.shape[1:]))
            rc = lib.dl4j_gather_normalize(
                flat.ctypes.data_as(_FP), flat.shape[0], flat.shape[1],
                idx.ctypes.data_as(_LP), len(idx), m.ctypes.data_as(_FP),
                sd.ctypes.data_as(_FP), out.ctypes.data_as(_FP), threads)
        if rc == -2:
            raise IndexError(f"gather index out of range [0, {flat.shape[0]})")
        if rc != 0:
            raise RuntimeError(f"native gather failed rc={rc}")
        return out.reshape((len(idx),) + tail)
    if idx.size and (idx.min() < 0 or idx.max() >= flat.shape[0]):
        raise IndexError(f"gather index out of range [0, {flat.shape[0]})")
    out = flat[idx]
    if mean is not None:
        sd = np.asarray(std, np.float32).reshape(-1)
        sd = np.where(sd != 0.0, sd, np.float32(1.0))
        out = (out - np.asarray(mean, np.float32).reshape(-1)) / sd
    return out.astype(np.float32).reshape((len(idx),) + tail)


def one_hot(labels: np.ndarray, num_classes: int,
            threads: int = 0) -> np.ndarray:
    """Integer ids [n] (or [n, 1]) as float32 one-hot rows [n,
    num_classes]; an id out of range raises ``IndexError``, another
    shape ``ValueError``."""
    labels = np.ascontiguousarray(labels, np.int64)
    if labels.ndim == 2 and labels.shape[1] == 1:
        labels = labels[:, 0]
    if labels.ndim != 1:
        raise ValueError(f"labels must be [n] or [n, 1], got {labels.shape}")
    lib = _lib()
    if lib is not None:
        out = np.empty((len(labels), num_classes), np.float32)
        rc = lib.dl4j_onehot(labels.ctypes.data_as(_LP), len(labels),
                             num_classes, out.ctypes.data_as(_FP), threads)
        if rc == -2:
            raise IndexError(f"label id out of range [0, {num_classes})")
        if rc != 0:
            raise RuntimeError(f"native one_hot failed rc={rc}")
        return out
    if labels.size and (labels.min() < 0 or labels.max() >= num_classes):
        raise IndexError(f"label id out of range [0, {num_classes})")
    return np.eye(num_classes, dtype=np.float32)[labels]


class _NativePayload:
    """``_ListBatchCore``'s payload: one DataSet per index batch, made by
    ``gather_rows`` and ``one_hot``."""

    def __init__(self, it: "NativeBatchIterator"):
        self._it = it

    def num_examples(self) -> int:
        return len(self._it.x)

    def __getitem__(self, idx) -> DataSet:
        it = self._it
        idx = np.ascontiguousarray(idx, np.int64)
        xb = gather_rows(it.x, idx, it.mean, it.std, it.threads)
        if it._int_labels:
            ids = it.y[idx]
            yb = (one_hot(ids, it.num_classes, it.threads)
                  if it.num_classes else ids.astype(np.float32))
        else:
            yb = gather_rows(it.y, idx, threads=it.threads)
        return DataSet(xb, yb)


class NativeBatchIterator(_ListBatchCore, DataSetIterator):
    """Shuffled minibatches assembled by the native thread pool.

    ``features``: [n, ...] floats; ``labels``: [n, ...] floats, or [n]
    integer class ids (one-hot when ``num_classes`` is given, else
    passed as float ids). ``normalize=True`` takes each column's mean and
    std over the features once and fuses the standardization into the
    gather. The order and epochs are ``_ListBatchCore``'s."""

    def __init__(self, features: np.ndarray, labels: np.ndarray,
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 normalize: bool = False, num_classes: Optional[int] = None,
                 threads: int = 0):
        self.x = np.ascontiguousarray(features, np.float32)
        self._int_labels = np.issubdtype(np.asarray(labels).dtype, np.integer)
        self.y = np.ascontiguousarray(
            labels, np.int64 if self._int_labels else np.float32)
        if len(self.x) != len(self.y):
            raise ValueError(f"features/labels length mismatch: "
                             f"{len(self.x)} vs {len(self.y)}")
        self.num_classes = num_classes
        self.threads = threads
        if normalize:
            flat = self.x.reshape(len(self.x), -1)
            self.mean, self.std = flat.mean(axis=0), flat.std(axis=0)
        else:
            self.mean = self.std = None
        super().__init__(_NativePayload(self), batch_size, shuffle, seed)
