"""Minibatch iteration, the feed pipeline and the iterator family.

Counterpart of ``deeplearning4j_tpu/datasets/iterators.py``: the
pre-processor seam (``DataSetPreProcessor``, ``CombinedPreProcessor``),
the ``DataSetIterator`` protocol (``has_next``/``next``/``reset``/
``batch``, ``for`` from a reset) with ``ListDataSetIterator`` over an
in-memory DataSet (the last minibatch may be short; a shuffled one
draws an order at construction and one per reset, the reference's
orders), the ComputationGraph's ``MultiDataSetIterator`` contract with
``ListMultiDataSetIterator``, and the feed pipeline that both
containers' ``fit`` wraps an iterator in:

- ``ShapeBucketingIterator`` pads a short tail to the canonical batch
  with a labels mask (the masked mean divides by the real rows, and the
  padded rows back-propagate zeros);
- ``AsyncDataSetIterator`` prepares batches on the host in a background
  thread;
- ``DeviceFeedIterator`` stages batch N+1 on the device (its ``place``
  callable, on its own thread) while step N runs. A staged batch from
  ``datasets/staging.py`` carries the event of its copy: the iterator
  hands it over only after the consumer's stream waits on that event.

The bucketing counts each padded tail in
``dl4j_feed_padded_batches_total``, and the device feed sets
``dl4j_feed_queue_depth`` to the batches staged and waiting at each
pull (``monitor``), as the reference does.

The two threaded stages keep the reference's contracts: a worker's
exception is re-raised on the consumer, the end-of-stream sentinel is
always delivered, ``close()`` after a worker's death neither hangs nor
re-raises, ``reset`` mid-epoch stops the worker without draining the
source, and ``__del__`` releases an abandoned worker. Also here:
``MultipleEpochsIterator``, ``SamplingDataSetIterator``,
``ExistingDataSetIterator``, ``ReconstructionDataSetIterator``,
``IteratorDataSetIterator``, ``MovingWindowDataSetIterator`` and
``bucket_sizes``/``bucket_for`` for the serving path. The reference's
``DL4J_TPU_DISABLE_FEED_PIPELINE`` switch is not ported: only ``fit``'s
``feed_pipeline=`` argument turns the pipeline off.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.staging import claim
from deeplearning4j_tpu_torch.monitor import (
    FEED_PADDED_BATCHES_COUNTER,
    FEED_QUEUE_DEPTH_GAUGE,
    get_registry,
)


def feed_pipeline_enabled(flag: Optional[bool] = None) -> bool:
    """``fit(..., feed_pipeline=...)``: on unless given False."""
    return True if flag is None else bool(flag)


def _queue_get_alive(q: "queue.Queue", thread, sentinel):
    """A blocking pull that cannot hang on a dead producer: when the
    worker died (or a concurrent ``close()`` stopped it) without
    delivering its sentinel, the sentinel is returned instead."""
    while True:
        try:
            return q.get(timeout=0.25)
        except queue.Empty:
            if thread is None or not thread.is_alive():
                return sentinel


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

    def async_supported(self) -> bool:
        return True


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


def _put(q: "queue.Queue", stop: threading.Event, item) -> None:
    """Put, retrying while the queue is full, until ``stop`` is set."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return
        except queue.Full:
            continue


def _run_worker(wrapped, prepare, q, stop, error, sentinel):
    """A worker stage's thread. It holds no reference to its stage, so an
    abandoned stage is collected and its ``__del__`` stops the thread."""
    try:
        while not stop.is_set() and wrapped.has_next():
            item = wrapped.next()
            _put(q, stop, item if prepare is None else prepare(item))
    except BaseException as e:  # re-raised on the consumer thread
        error.append(e)
    finally:
        # the sentinel must reach the consumer, with the same stop-aware
        # retry as the data (a put_nowait would drop it whenever the
        # queue is still full at the end)
        _put(q, stop, sentinel)


class _WorkerStage(DataSetIterator):
    """A background thread that pulls from ``wrapped``, applies
    ``prepare`` (None: nothing) and puts the results into a bounded
    queue; the consumer takes them with ``has_next``/``next``.
    Payload-agnostic (DataSet or MultiDataSet). The thread starts at the
    first pull; ``reset`` stops it (without draining the source) and the
    next pull resets the source and starts a new one."""

    _SENTINEL = object()

    def __init__(self, wrapped, queue_size: int, prepare=None):
        self._wrapped = wrapped
        self._queue_size = queue_size
        self._prepare = prepare
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._peeked: Optional[object] = None
        self._exhausted = False
        self._needs_reset = False
        self._errors: List[BaseException] = []

    def _start(self):
        if self._needs_reset:
            self._wrapped.reset()
            self._needs_reset = False
        self._errors = []
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=self._queue_size)
        self._thread = threading.Thread(
            target=_run_worker, daemon=True,
            args=(self._wrapped, self._prepare, self._queue, self._stop,
                  self._errors, self._SENTINEL))
        self._thread.start()

    def reset(self):
        if self._thread is not None and self._thread.is_alive():
            self._stop.set()  # the worker exits without draining the source
            self._thread.join(timeout=5)
        self._thread = None
        self._peeked = None
        self._exhausted = False
        self._needs_reset = True
        # an abandoned worker's undelivered error is dropped: close()
        # after an error must not re-raise on the next use
        self._errors = []

    def close(self) -> None:
        """Stop the worker without replaying the source (a ``fit`` that
        raised must not leave a producer spinning on a full queue)."""
        self.reset()

    def __del__(self):
        # the backstop for an abandoned iterator: release the worker from
        # its put loop (no join: a finalizer never blocks)
        try:
            self._stop.set()
        except Exception:
            pass

    def _depth_gauge(self, depth: int) -> None:
        """The device feed sets ``dl4j_feed_queue_depth``; the host
        prefetch does not (the reference's gauge is the feed's)."""

    def has_next(self):
        if self._peeked is not None:
            return True
        if self._exhausted:
            return False
        if self._thread is None:
            self._start()
        item = _queue_get_alive(self._queue, self._thread, self._SENTINEL)
        self._depth_gauge(self._queue.qsize())
        if item is self._SENTINEL:
            self._exhausted = True
            if self._errors:
                raise self._errors.pop()
            return False
        self._peeked = item
        return True

    def _next_impl(self):
        if not self.has_next():
            raise StopIteration
        item, self._peeked = self._peeked, None
        return item

    def set_pre_processor(self, pp) -> None:
        # the pre-processor runs on the worker thread, where batches are made
        self._wrapped.set_pre_processor(pp)

    def pre_processor(self):
        return self._wrapped.pre_processor()

    def batch(self):
        return self._wrapped.batch()


class AsyncDataSetIterator(_WorkerStage):
    """Background prefetch: a worker thread pulls from the wrapped
    iterator into a bounded queue of ``queue_size``, so that batch
    preparation on the host overlaps the device's step. ``fit`` wraps
    its iterator in one when ``async_supported()``."""

    def __init__(self, wrapped: DataSetIterator, queue_size: int = 4):
        super().__init__(wrapped, queue_size)


class DeviceFeedIterator(_WorkerStage):
    """The device-staging stage: while step N runs, a background thread
    stages batch N+1 on the device through ``place(batch) -> staged
    batch`` (default identity; the containers pass ``_stage_ds`` /
    ``_stage_mds``) into a buffer of ``depth`` batches (2 double-buffers,
    3 triple-buffers). Each batch is handed over through
    ``staging.claim``: the consumer's current stream waits on the
    event of the batch's copy and owns its tensors from then on."""

    def __init__(self, wrapped, depth: int = 2, place=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        super().__init__(wrapped, depth, place)

    def _next_impl(self):
        return claim(super()._next_impl())

    def _depth_gauge(self, depth: int) -> None:
        # late-bound: a registry swapped in for a run is the one set
        get_registry().gauge(
            FEED_QUEUE_DEPTH_GAUGE,
            "Batches staged on device awaiting the step loop").set(depth)

    def async_supported(self) -> bool:
        return False  # already a background stage: never wrapped twice


# ------------------------------------------------------ shape bucketing

def _ones_label_mask(labels, n_valid: int, n_total: int):
    """A labels mask marking the first ``n_valid`` of ``n_total`` rows:
    [n_total] for per-example labels, [n_total, T] for per-timestep
    ([b, T, nOut] dense or [b, T] integer-id) labels. A float32 numpy
    array, or a float32 tensor on the labels' device for a tensor."""
    if isinstance(labels, torch.Tensor):
        ints = not (labels.is_floating_point() or labels.is_complex())
    else:
        labels = np.asarray(labels)
        ints = np.issubdtype(labels.dtype, np.integer)
    if labels.ndim >= 3 or (labels.ndim == 2 and ints):
        shape = (n_total, labels.shape[1])
    else:
        shape = (n_total,)
    if isinstance(labels, torch.Tensor):
        m = torch.zeros(shape, dtype=torch.float32, device=labels.device)
    else:
        m = np.zeros(shape, np.float32)
    m[:n_valid] = 1.0
    return m


def pad_rows(a, pad: int):
    """``pad`` zero rows appended along axis 0 (of a numpy array, or of
    a tensor on its own device)."""
    if pad <= 0:
        return a
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
    return np.concatenate(
        [a, np.zeros((pad,) + a.shape[1:], dtype=a.dtype)], axis=0)



def _host(a):
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


class ShapeBucketingIterator(DataSetIterator):
    """Pads a short batch with zero rows up to the canonical batch size
    (``batch_size``, else the wrapped iterator's ``batch()``, else the
    first batch's size) and adds a labels mask that keeps the padded
    rows out of the loss: the masked mean divides by the real rows, and
    a padded row back-propagates exact zeros. Full batches pass through
    untouched, as do batches that already carry a mask or have no
    labels. Exact only for layers that treat examples independently:
    the containers skip this wrapper for nets with batch statistics
    (``LayerImpl.batch_statistics``: BN's batch moments, the MoE's
    load-balancing loss). Payload-agnostic (DataSet or MultiDataSet)."""

    def __init__(self, wrapped, batch_size: Optional[int] = None):
        self._wrapped = wrapped
        b = batch_size if batch_size is not None else wrapped.batch()
        self._canon: Optional[int] = b if b and b > 0 else None

    def _count_padded(self) -> None:
        get_registry().counter(
            FEED_PADDED_BATCHES_COUNTER,
            "Ragged tail batches padded to the canonical shape").inc()

    def _target(self, n: int) -> int:
        if self._canon is None:
            self._canon = n
        return self._canon

    def _bucket_ds(self, ds: DataSet) -> DataSet:
        if (ds.features_mask is not None or ds.labels_mask is not None
                or ds.labels is None):
            return ds
        n = ds.num_examples()
        target = self._target(n)
        if n >= target:
            return ds
        self._count_padded()
        labels = _host(ds.labels)
        return DataSet(pad_rows(_host(ds.features), target - n),
                       pad_rows(labels, target - n), None,
                       _ones_label_mask(labels, n, target))

    def _bucket_mds(self, mds: MultiDataSet) -> MultiDataSet:
        if any(m is not None for m in (mds.features_masks or [])) or \
                any(m is not None for m in (mds.labels_masks or [])):
            return mds
        n = mds.num_examples()
        target = self._target(n)
        if n >= target:
            return mds
        self._count_padded()
        labels = [_host(y) for y in mds.labels]
        pad = target - n
        return MultiDataSet(
            features=[pad_rows(_host(f), pad) for f in mds.features],
            labels=[pad_rows(y, pad) for y in labels],
            labels_masks=[_ones_label_mask(y, n, target) for y in labels])

    def _next_impl(self):
        b = self._wrapped.next()
        if isinstance(b, MultiDataSet):
            return self._bucket_mds(b)
        if isinstance(b, DataSet):
            return self._bucket_ds(b)
        return b

    def reset(self):
        self._wrapped.reset()

    def has_next(self):
        return self._wrapped.has_next()

    def batch(self):
        return self._wrapped.batch()

    def async_supported(self) -> bool:
        return self._wrapped.async_supported()

    def set_pre_processor(self, pp) -> None:
        self._wrapped.set_pre_processor(pp)  # the real rows only

    def pre_processor(self):
        return self._wrapped.pre_processor()


class MultipleEpochsIterator(DataSetIterator):
    """Replays the wrapped iterator ``epochs`` times."""

    def __init__(self, epochs: int, wrapped: DataSetIterator):
        self._epochs = epochs
        self._wrapped = wrapped
        self._epoch = 0

    def reset(self):
        self._epoch = 0
        self._wrapped.reset()

    def has_next(self):
        if self._wrapped.has_next():
            return True
        if self._epoch + 1 < self._epochs:
            self._epoch += 1
            self._wrapped.reset()
            return self._wrapped.has_next()
        return False

    def _next_impl(self):
        if not self.has_next():
            raise StopIteration
        return self._wrapped.next()

    def set_pre_processor(self, pp) -> None:
        self._wrapped.set_pre_processor(pp)

    def pre_processor(self):
        return self._wrapped.pre_processor()

    def batch(self):
        return self._wrapped.batch()


class SamplingDataSetIterator(DataSetIterator):
    """``total_batches`` minibatches of rows drawn with replacement by
    numpy ``default_rng(seed)`` (the reference's draws)."""

    def __init__(self, data: DataSet, batch_size: int, total_batches: int,
                 seed: int = 0):
        self._data = data
        self._batch = batch_size
        self._total = total_batches
        self._rng = np.random.default_rng(seed)
        self._count = 0

    def reset(self):
        self._count = 0

    def has_next(self):
        return self._count < self._total

    def _next_impl(self):
        self._count += 1
        idx = self._rng.integers(0, self._data.num_examples(), self._batch)
        return self._data[idx]

    def batch(self):
        return self._batch


def _resettable_iter(source, cls_name: str):
    """A fresh iterator over a sequence, or over what a zero-arg factory
    returns; a one-shot iterator is refused (reset could not replay it)."""
    src = source() if callable(source) else source
    it = iter(src)
    if it is src and not callable(source):
        raise TypeError(
            f"{cls_name} got a one-shot iterator/generator; reset() could "
            "not replay it: pass a list or a zero-arg factory "
            "(lambda: make_batches()) instead")
    return it


class ExistingDataSetIterator(DataSetIterator):
    """The DataSets of a sequence, or of a zero-arg factory called at
    each reset, as they are; ``batch()`` is -1 (unknown). With a
    pre-processor the batches are copies, so that one that mutates in
    place does not compound over epochs."""

    def __init__(self, datasets):
        self._source = datasets
        self._it = None
        self._peek = None
        self.reset()

    def reset(self):
        self._it = _resettable_iter(self._source, type(self).__name__)
        self._peek = None

    def has_next(self):
        if self._peek is None:
            self._peek = next(self._it, None)
        return self._peek is not None

    def _next_impl(self):
        if not self.has_next():
            raise StopIteration
        ds, self._peek = self._peek, None
        if self._pre_processor is not None:
            cp = lambda a: None if a is None else np.array(a)  # noqa: E731
            ds = DataSet(cp(ds.features), cp(ds.labels),
                         cp(ds.features_mask), cp(ds.labels_mask))
        return ds

    def batch(self):
        return -1


class ReconstructionDataSetIterator(DataSetIterator):
    """(features, features) pairs of the wrapped iterator's batches, the
    AutoEncoder and RBM feed."""

    def __init__(self, wrapped: DataSetIterator):
        self._wrapped = wrapped

    def reset(self):
        self._wrapped.reset()

    def has_next(self):
        return self._wrapped.has_next()

    def _next_impl(self):
        ds = self._wrapped.next()
        return DataSet(ds.features, ds.features,
                       ds.features_mask, ds.features_mask)

    def batch(self):
        return self._wrapped.batch()


class IteratorDataSetIterator(DataSetIterator):
    """Minibatches of ``batch_size`` from a source of single-example
    DataSets (a sequence or a zero-arg factory); the last may be short.
    Where only some examples carry a mask, the others' is ones."""

    _END = object()  # a None element of the source raises, not truncates

    def __init__(self, examples, batch_size: int):
        self._source = examples
        self._batch = batch_size
        self._it = None
        self._buf: List[DataSet] = []
        self.reset()

    def reset(self):
        self._it = _resettable_iter(self._source, type(self).__name__)
        self._buf = []

    def _fill(self):
        while len(self._buf) < self._batch:
            nxt = next(self._it, self._END)
            if nxt is self._END:
                break
            if nxt is None:
                raise ValueError(
                    "IteratorDataSetIterator source yielded None (bad "
                    "record?): filter such entries out before batching")
            self._buf.append(nxt)

    def has_next(self):
        self._fill()
        return bool(self._buf)

    @staticmethod
    def _cat_masks(masks, shapes):
        if all(m is None for m in masks):
            return None
        return np.concatenate(
            [np.ones(shape, np.float32) if m is None else np.asarray(m)
             for m, shape in zip(masks, shapes)], axis=0)

    def _next_impl(self):
        self._fill()
        if not self._buf:
            raise StopIteration
        chunk, self._buf = self._buf, []
        n_labeled = sum(d.labels is not None for d in chunk)
        if 0 < n_labeled < len(chunk):
            raise ValueError(
                "IteratorDataSetIterator chunk mixes labeled and "
                f"unlabeled examples ({n_labeled}/{len(chunk)} have "
                "labels): a merged batch cannot represent both; split "
                "the stream or drop/fill the missing labels upstream")
        feats = np.concatenate([np.atleast_2d(d.features) for d in chunk], axis=0)
        labels = (None if n_labeled == 0 else np.concatenate(
            [np.atleast_2d(d.labels) for d in chunk], axis=0))
        fmask = self._cat_masks(
            [d.features_mask for d in chunk],
            [np.asarray(d.features).shape[:-1] for d in chunk])
        lmask = self._cat_masks(
            [d.labels_mask for d in chunk],
            [np.asarray(d.labels).shape[:-1] if d.labels is not None else (1,)
             for d in chunk])
        return DataSet(feats, labels, fmask, lmask)

    def batch(self):
        return self._batch


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

    def async_supported(self) -> bool:
        return True


class ListMultiDataSetIterator(_ListBatchCore, MultiDataSetIterator):
    """Minibatches of an in-memory MultiDataSet (``_ListBatchCore``)."""


def wrap_feed(data, pipeline: bool, pad_tail: bool, place):
    """The containers' ``fit`` feed over ``data`` (an iterator, or any
    other iterable of batches, taken as an ``ExistingDataSetIterator``),
    as the reference wraps it: ``ShapeBucketingIterator`` when the
    pipeline is on and ``pad_tail`` (no batch statistics), then
    ``AsyncDataSetIterator`` when ``async_supported()``, then
    ``DeviceFeedIterator(place=place)`` when the pipeline is on. Returns
    (the iterator to train from, its threaded stages, to close)."""
    it = data if hasattr(data, "has_next") else ExistingDataSetIterator(
        data if isinstance(data, (list, tuple)) else list(data))
    threads = []
    if pipeline and pad_tail:
        it = ShapeBucketingIterator(it)
    if it.async_supported():
        it = AsyncDataSetIterator(it)
        threads.append(it)
    if pipeline:
        it = DeviceFeedIterator(it, place=place)
        threads.append(it)
    return it, threads


def _moving_window_matrix(arr: np.ndarray, window_rows: int,
                          window_cols: int, rotate: int = 0) -> np.ndarray:
    """Every dense [window_rows, window_cols] sub-window of a 2-D array
    (stride 1), each rotated by 90 degrees ``rotate`` times:
    [n_windows, wr, wc]."""
    a = np.asarray(arr)
    r, c = a.shape
    wr, wc = window_rows, window_cols
    if wr > r or wc > c:
        raise ValueError(f"window {wr}x{wc} larger than matrix {r}x{c}")
    out = np.lib.stride_tricks.sliding_window_view(a, (wr, wc)).reshape(
        -1, wr, wc).copy()
    if rotate:
        out = np.rot90(out, k=rotate, axes=(1, 2)).copy()
    return out


class MovingWindowDataSetIterator(DataSetIterator):
    """Every example expanded into all its dense [window_rows,
    window_cols] sub-windows (stride 1; with ``rotations`` each also
    rotated by 90, 180 and 270 degrees), each flattened and keeping the
    example's label, in minibatches of ``batch_size``. ``features`` are
    [n, rows, cols], or flat [n, rows * cols] with ``rows``/``cols``
    given. The originals are not appended, and windows are made one
    example at a time."""

    def __init__(self, data: DataSet, window_rows: int, window_cols: int,
                 batch_size: int = 32, rotations: bool = True,
                 rows: Optional[int] = None, cols: Optional[int] = None,
                 shuffle: bool = False, seed: int = 0):
        if data.labels is None:
            raise ValueError(
                "MovingWindowDataSetIterator needs labeled data (every "
                "window inherits its example's label); for unlabeled "
                "reconstruction feeds wrap with "
                "ReconstructionDataSetIterator first")
        x = np.asarray(data.features)
        if x.ndim == 2:
            if not rows or not cols:
                raise ValueError("flat features need rows=/cols=")
            if x.shape[1] != rows * cols:
                raise ValueError(
                    f"flat feature width {x.shape[1]} != rows*cols "
                    f"({rows}*{cols}={rows * cols}): reshaping would "
                    "silently merge/split examples")
            x = x.reshape(-1, rows, cols)
        self._x = x
        self._y = np.asarray(data.labels)
        self._wr, self._wc = window_rows, window_cols
        self._rots = (0, 1, 2, 3) if rotations else (0,)
        self._batch = batch_size
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self.reset()

    def reset(self):
        self._order = np.arange(self._x.shape[0])
        if self._shuffle:
            rng = np.random.default_rng(self._seed + self._epoch)
            self._order = rng.permutation(self._x.shape[0])
            self._epoch += 1
        self._cursor = 0
        self._buf_x: List[np.ndarray] = []
        self._buf_y: List[np.ndarray] = []
        self._buffered = 0

    def _expand_next_example(self) -> bool:
        if self._cursor >= self._x.shape[0]:
            return False
        i = int(self._order[self._cursor])
        self._cursor += 1
        for rot in self._rots:
            w = _moving_window_matrix(self._x[i], self._wr, self._wc, rot)
            self._buf_x.append(w.reshape(w.shape[0], -1).astype(np.float32))
            self._buf_y.append(np.repeat(self._y[i:i + 1], w.shape[0], 0))
            self._buffered += w.shape[0]
        return True

    def has_next(self):
        while self._buffered < self._batch:
            if not self._expand_next_example():
                break
        return self._buffered > 0

    def _next_impl(self):
        if not self.has_next():
            raise StopIteration
        xs = np.concatenate(self._buf_x, axis=0)
        ys = np.concatenate(self._buf_y, axis=0).astype(np.float32)
        take = min(self._batch, xs.shape[0])
        self._buf_x = [xs[take:]] if take < xs.shape[0] else []
        self._buf_y = [ys[take:]] if take < ys.shape[0] else []
        self._buffered = xs.shape[0] - take
        return DataSet(xs[:take], ys[:take])

    def batch(self):
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
