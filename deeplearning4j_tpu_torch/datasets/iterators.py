"""Minibatch iteration and shape bucketing.

Counterpart of ``deeplearning4j_tpu/datasets/iterators.py``: the
pre-processor seam (``DataSetPreProcessor``, ``CombinedPreProcessor``),
the ``DataSetIterator`` protocol (``has_next``/``next``/``reset``/
``batch``, ``for`` from a reset) with ``ListDataSetIterator`` over an
in-memory DataSet (the last minibatch may be short; a shuffled one
draws an order at construction and one per reset, the reference's
orders), the ComputationGraph's ``MultiDataSetIterator`` contract with
``ListMultiDataSetIterator``, and the port's own copy of
``bucket_sizes``/``bucket_for`` for the serving path. The async,
device-feed and shape-bucketing iterators wait for ROADMAP Queue A8:
``fit`` feeds the short tail as it is, which gives the loss the
reference's padded tail gives (``ops/losses.py`` ``_masked_mean``).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet


class DataSetPreProcessor:
    """A minibatch pre-processor: mutates the DataSet in place or
    returns a replacement (normalizers implement this too)."""

    def pre_process(self, ds: DataSet):
        raise NotImplementedError


class CombinedPreProcessor(DataSetPreProcessor):
    """Applies the given pre-processors in order; each may mutate in
    place (returning None) or return a replacement DataSet."""

    def __init__(self, *pre_processors):
        self._pps = list(pre_processors)

    def pre_process(self, ds: DataSet):
        for pp in self._pps:
            out = pp.pre_process(ds)
            if out is not None:
                ds = out
        return ds


class _PreProcessorSeam:
    """``set_pre_processor``, shared by the DataSet and MultiDataSet
    iterator bases: ``pp.pre_process(ds)`` runs on every batch the
    iterator emits (mutate in place or return a replacement)."""

    _pre_processor = None

    def set_pre_processor(self, pp) -> None:
        self._pre_processor = pp

    def pre_processor(self):
        return self._pre_processor

    def _apply_pp(self, ds):
        pp = self._pre_processor
        if pp is None:
            return ds
        out = pp.pre_process(ds)
        return ds if out is None else out


class DataSetIterator(_PreProcessorSeam):
    """Iterator over minibatch DataSets: ``has_next``/``next``/``reset``/
    ``batch``/``total_examples``/``set_pre_processor``; iterating it
    with ``for`` starts from a reset."""

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        return self.next()

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self) -> DataSet:
        """Every emitted batch passes through the pre-processor:
        subclasses implement ``_next_impl``."""
        return self._apply_pp(self._next_impl())

    def _next_impl(self) -> DataSet:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def batch(self) -> int:
        raise NotImplementedError


class _ListBatchCore:
    """Minibatches of ``batch_size`` rows of an in-memory dataset (any
    payload with ``num_examples()`` and ``__getitem__``), in order, or
    with ``shuffle`` in the order of numpy ``default_rng(seed + k)`` at
    the k-th reset, the construction's being the first; the last one may
    be short."""

    def __init__(self, data, batch_size: int = 32, shuffle: bool = False,
                 seed: int = 0):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self._data = data
        self._batch = batch_size
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._pos = 0
        self._order = np.arange(data.num_examples())
        self.reset()

    def reset(self) -> None:
        self._pos = 0
        if self._shuffle:
            rng = np.random.default_rng(self._seed + self._epoch)
            self._order = rng.permutation(self._data.num_examples())
            self._epoch += 1

    def has_next(self) -> bool:
        return self._pos < self._data.num_examples()

    def _next_impl(self):
        idx = self._order[self._pos:self._pos + self._batch]
        self._pos += self._batch
        return self._data[idx]

    def batch(self) -> int:
        return self._batch

    def total_examples(self) -> int:
        return self._data.num_examples()


class ListDataSetIterator(_ListBatchCore, DataSetIterator):
    """Minibatches of an in-memory DataSet (``_ListBatchCore``)."""


class MultiDataSetIterator(_PreProcessorSeam):
    """Iterator over MultiDataSet minibatches: ``has_next``/``next``/
    ``reset``/``batch``, iteration from a reset, and
    ``set_pre_processor``."""

    def __iter__(self) -> "MultiDataSetIterator":
        self.reset()
        return self

    def __next__(self) -> MultiDataSet:
        if not self.has_next():
            raise StopIteration
        return self.next()

    def next(self) -> MultiDataSet:
        return self._apply_pp(self._next_impl())

    def has_next(self) -> bool:
        raise NotImplementedError

    def _next_impl(self) -> MultiDataSet:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def batch(self) -> int:
        raise NotImplementedError


class ListMultiDataSetIterator(_ListBatchCore, MultiDataSetIterator):
    """Minibatches of an in-memory MultiDataSet (``_ListBatchCore``)."""


def bucket_sizes(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to (and always including) ``max_batch``."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out: List[int] = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; an oversized n passes through unpadded."""
    for b in buckets:
        if n <= b:
            return b
    return n
