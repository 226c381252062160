"""Staging a batch on the device from the feed's worker thread.

The port's counterpart of the reference's ``jnp.asarray`` staging in the
containers' ``_stage_ds``/``_stage_mds``. ``DeviceStager``'s
``stage_ds`` and ``stage_mds`` run on ``DeviceFeedIterator``'s thread:

- on the CPU it makes plain tensors in the parameters' dtype;
- on the card, inside the device's context and on a side stream the
  stager owns, it copies each array's bytes in the source dtype from
  pinned host memory with ``non_blocking=True``, casts to the
  parameters' dtype on the card, and records an event on that stream.
  The staged batch carries the event and its tensors.

``claim`` runs on the consumer's thread (``DeviceFeedIterator.next``):
the consumer's current stream waits on the event, and each staged
tensor is marked used on that stream (``record_stream``), so that the
caching allocator does not hand its memory to another tensor while the
step still reads it.

The pinned buffers come from PyTorch's caching host allocator
(``Tensor.pin_memory``). A non-blocking copy out of pinned memory records
an event on the copy's stream, and the allocator does not reuse the
block until that event has fired, so a buffer is never refilled while
its copy is in flight.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet

# the numpy dtypes ``torch.from_numpy`` takes; others go through float64
_FROM_NUMPY = {np.dtype(t) for t in (np.float64, np.float32, np.float16,
                                     np.int64, np.int32, np.int16, np.int8,
                                     np.uint8, np.bool_)}


def _host_tensor(a) -> torch.Tensor:
    """A CPU tensor of ``a``'s values in its own dtype (no copy where
    numpy's layout allows)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype not in _FROM_NUMPY:
        a = a.astype(np.float64)
    return torch.from_numpy(np.ascontiguousarray(a))


class _Staged:
    """What ``claim`` needs of a staged batch: the copies' event and the
    tensors they made."""

    __slots__ = ("event", "tensors")

    def __init__(self, event, tensors):
        self.event, self.tensors = event, tensors


class DeviceStager:
    """Moves batches to ``device`` in ``dtype`` (see the module
    docstring): host arrays are copied, tensors already on the device
    are only cast. One per ``fit`` call; its side stream is made at the
    first batch staged on the card. ``copies`` counts the host-to-device
    copies made and ``nbytes`` their bytes (in the source dtype)."""

    def __init__(self, device: torch.device, dtype: torch.dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self.stream: Optional["torch.cuda.Stream"] = None
        self.copies = 0
        self.nbytes = 0

    def _stage(self, arrays: Sequence, batch_of):
        """``batch_of(tensors)``, the arrays (None kept) staged."""
        if self.device.type != "cuda":
            return batch_of([None if a is None else _host_tensor(a).to(
                device=self.device, dtype=self.dtype) for a in arrays])
        with torch.cuda.device(self.device):
            if self.stream is None:
                self.stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self.stream):
                out = []
                for a in arrays:
                    if a is None:
                        out.append(None)
                        continue
                    t = _host_tensor(a)
                    if t.device.type == "cpu":
                        self.copies += 1
                        self.nbytes += t.numel() * t.element_size()
                        t = t.pin_memory().to(self.device, non_blocking=True)
                    out.append(t.to(self.dtype))  # the cast, on the card
                event = torch.cuda.Event()
                event.record(self.stream)
        batch = batch_of(out)
        batch._staged = _Staged(event, [t for t in out if t is not None])
        return batch

    def stage_ds(self, ds: DataSet) -> DataSet:
        return self._stage(
            [ds.features, ds.labels, ds.features_mask, ds.labels_mask],
            lambda t: DataSet(*t))

    def stage_mds(self, mds: MultiDataSet) -> MultiDataSet:
        """Every array of ``mds``, its lists' structure kept."""
        lists = [mds.features, mds.labels, mds.features_masks, mds.labels_masks]
        flat = [a for arrs in lists for a in (arrs or [])]

        def rebuild(tensors):
            it, out = iter(tensors), []
            for arrs in lists:
                out.append(None if arrs is None else [next(it) for _ in arrs])
            return MultiDataSet(*out)

        return self._stage(flat, rebuild)


def stager_of(net) -> DeviceStager:
    """The net's stager for its device and parameters' dtype (made at
    the first batch, again after either changes)."""
    s = net.__dict__.get("_feed_stager")
    if s is None or s.device != net.device or s.dtype != net._dtype:
        s = net.__dict__["_feed_stager"] = DeviceStager(net.device, net._dtype)
    return s


def claim(batch):
    """On the consumer's thread: make the current stream wait for the
    staged batch's copies and own its tensors. Any other batch passes
    as it is."""
    staged = getattr(batch, "_staged", None)
    if staged is None:
        return batch
    del batch._staged
    if staged.tensors:
        stream = torch.cuda.current_stream(staged.tensors[0].device)
        stream.wait_event(staged.event)
        for t in staged.tensors:
            t.record_stream(stream)
    return batch
