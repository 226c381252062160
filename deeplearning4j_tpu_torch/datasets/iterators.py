"""Minibatch iteration and shape bucketing.

Counterpart of ``deeplearning4j_tpu/datasets/iterators.py``:
``ListDataSetIterator`` (minibatches of an in-memory DataSet; the last
one may be short), the ComputationGraph's ``MultiDataSetIterator``
contract with ``ListMultiDataSetIterator`` over an in-memory
MultiDataSet, and the port's own copy of ``bucket_sizes``/
``bucket_for`` for the serving path. The async, device-feed and
shape-bucketing iterators wait for ROADMAP Queue A9: ``fit`` feeds the
short tail as it is, which gives the loss the reference's padded tail
gives (``ops/losses.py`` ``_masked_mean``).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet


class ListDataSetIterator:
    """Minibatches of ``batch_size`` rows of an in-memory DataSet, in
    order, or with ``shuffle`` in a new order each pass (numpy
    ``default_rng(seed + pass)``, the reference's orders); the last one
    may be short."""

    def __init__(self, data: DataSet, batch_size: int = 32,
                 shuffle: bool = False, seed: int = 0):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self._data = data
        self._batch = batch_size
        self._shuffle = shuffle
        self._seed = seed
        # the reference draws one order at construction, then one per pass
        self._epoch = 1 if shuffle else 0

    def __iter__(self) -> Iterator[DataSet]:
        n = self._data.num_examples()
        if not self._shuffle:
            return (self._data[i:i + self._batch]
                    for i in range(0, n, self._batch))
        order = np.random.default_rng(self._seed + self._epoch).permutation(n)
        self._epoch += 1
        return (self._data[order[i:i + self._batch]]
                for i in range(0, n, self._batch))

    def batch(self) -> int:
        return self._batch


class MultiDataSetIterator:
    """Iterator over MultiDataSet minibatches: ``has_next``/``next``/
    ``reset``/``batch``, iteration from a reset, and
    ``set_pre_processor`` (``pp.pre_process(mds)`` runs on every batch
    emitted; it mutates in place or returns a replacement)."""

    _pre_processor = None

    def __iter__(self) -> "MultiDataSetIterator":
        self.reset()
        return self

    def __next__(self) -> MultiDataSet:
        if not self.has_next():
            raise StopIteration
        return self.next()

    def set_pre_processor(self, pp) -> None:
        self._pre_processor = pp

    def pre_processor(self):
        return self._pre_processor

    def next(self) -> MultiDataSet:
        mds = self._next_impl()
        if self._pre_processor is None:
            return mds
        out = self._pre_processor.pre_process(mds)
        return mds if out is None else out

    def has_next(self) -> bool:
        raise NotImplementedError

    def _next_impl(self) -> MultiDataSet:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def batch(self) -> int:
        raise NotImplementedError


class ListMultiDataSetIterator(MultiDataSetIterator):
    """Minibatches of ``batch_size`` rows of an in-memory MultiDataSet,
    in order, or with ``shuffle`` in a new order at every reset (numpy
    ``default_rng(seed + reset count)``, the reference's orders); the
    last one may be short."""

    def __init__(self, data: MultiDataSet, batch_size: int = 32,
                 shuffle: bool = False, seed: int = 0):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self._data = data
        self._batch = batch_size
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._order: Optional[np.ndarray] = np.arange(data.num_examples())
        self.reset()

    def reset(self) -> None:
        self._pos = 0
        if self._shuffle:
            rng = np.random.default_rng(self._seed + self._epoch)
            self._order = rng.permutation(self._data.num_examples())
            self._epoch += 1

    def has_next(self) -> bool:
        return self._pos < self._data.num_examples()

    def _next_impl(self) -> MultiDataSet:
        idx = self._order[self._pos:self._pos + self._batch]
        self._pos += self._batch
        return self._data[idx]

    def batch(self) -> int:
        return self._batch

    def total_examples(self) -> int:
        return self._data.num_examples()


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
