"""Minibatch iteration and shape bucketing.

Counterpart of ``deeplearning4j_tpu/datasets/iterators.py``:
``ListDataSetIterator`` (minibatches of an in-memory DataSet; the last
one may be short) and the port's own copy of ``bucket_sizes``/
``bucket_for`` for the serving path. The async, device-feed and
shape-bucketing iterators wait for ROADMAP Queue A9: ``fit`` feeds the
short tail as it is, which gives the loss the reference's padded tail
gives (``ops/losses.py`` ``_masked_mean``).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


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
