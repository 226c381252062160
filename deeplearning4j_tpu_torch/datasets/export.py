"""Disk-staged DataSet export and resumable file-backed iteration.

Counterpart of ``deeplearning4j_tpu/datasets/export.py``, with its
on-disk layout: one directory of ``batch_{i:06d}.npz`` files (numpy's
zip container, members ``features``, ``labels`` and the optional
``features_mask``/``labels_mask``) beside a ``manifest.json``
(``{"format": "dl4j_tpu_dataset_export_v1", "num_batches",
"num_examples", "batch_size"}``). ``export_dataset`` re-batches a stream
to a uniform size and writes it; ``ExportedDataSetIterator`` reads one
batch into host memory at a time, optionally in a new order of the
files each epoch, and is resumable: ``state()`` is the reference's
cursor dict and ``restore()`` takes it, so a directory and a cursor
written by either package read in the other.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Iterator, List, Optional, Union

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator

_MANIFEST = "manifest.json"


def _batches_from(source, batch_size: Optional[int]) -> Iterator[DataSet]:
    """Uniform re-batching: a remainder is carried across the input
    DataSets, so that every exported file but the last holds exactly
    ``batch_size`` examples."""
    if isinstance(source, DataSet):
        source = [source]
    if batch_size is None:
        yield from source
        return
    hx: List[np.ndarray] = []
    hy: List[np.ndarray] = []
    held = 0
    for ds in source:
        if ds.features_mask is not None or ds.labels_mask is not None:
            raise ValueError("export re-batching does not support masked "
                             "DataSets; export with batch_size=None")
        x = np.asarray(ds.features)
        y = np.asarray(ds.labels)
        hx.append(x)
        hy.append(y)
        held += len(x)
        while held >= batch_size:
            bx = np.concatenate(hx) if len(hx) > 1 else hx[0]
            by = np.concatenate(hy) if len(hy) > 1 else hy[0]
            yield DataSet(bx[:batch_size], by[:batch_size])
            hx, hy = [bx[batch_size:]], [by[batch_size:]]
            held -= batch_size
    if held:
        yield DataSet(np.concatenate(hx) if len(hx) > 1 else hx[0],
                      np.concatenate(hy) if len(hy) > 1 else hy[0])


def export_dataset(source: Union[DataSet, Iterable[DataSet]], directory: str,
                   batch_size: Optional[int] = None) -> int:
    """Write ``source`` (one DataSet to split, or any iterable of
    DataSets, read one at a time) to ``directory`` as
    ``batch_{i:06d}.npz`` files and the manifest, after removing the
    batch files of an earlier export there; returns the number of files
    written."""
    os.makedirs(directory, exist_ok=True)
    for f in os.listdir(directory):
        if f.endswith(".npz") and f.startswith("batch_"):
            os.remove(os.path.join(directory, f))
    count = 0
    examples = 0
    for ds in _batches_from(source, batch_size):
        arrays = {"features": np.asarray(ds.features),
                  "labels": np.asarray(ds.labels)}
        if ds.features_mask is not None:
            arrays["features_mask"] = np.asarray(ds.features_mask)
        if ds.labels_mask is not None:
            arrays["labels_mask"] = np.asarray(ds.labels_mask)
        np.savez(os.path.join(directory, f"batch_{count:06d}.npz"), **arrays)
        examples += len(arrays["features"])
        count += 1
    with open(os.path.join(directory, _MANIFEST), "w") as f:
        json.dump({"format": "dl4j_tpu_dataset_export_v1",
                   "num_batches": count, "num_examples": examples,
                   "batch_size": batch_size}, f)
    return count


class ExportedDataSetIterator(DataSetIterator):
    """Iterates a directory written by :func:`export_dataset` (or a
    directory of bare ``.npz`` files), one batch in host memory at a
    time; with ``shuffle`` the files' order is drawn anew each epoch
    (numpy ``default_rng(seed + epoch)``), the contents stay as
    exported. Resumable through ``state()``/``restore()``."""

    def __init__(self, directory: str, shuffle: bool = False, seed: int = 0):
        self.directory = directory
        manifest_path = os.path.join(directory, _MANIFEST)
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                self.manifest = json.load(f)
        else:
            self.manifest = {}
        self.files = sorted(f for f in os.listdir(directory)
                            if f.endswith(".npz"))
        if not self.files:
            raise FileNotFoundError(f"no exported batches in {directory}")
        want = self.manifest.get("num_batches")
        if want is not None and len(self.files) != want:
            raise ValueError(
                f"{directory} holds {len(self.files)} .npz files but the "
                f"manifest says {want}: stale or missing batches")
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        self._order = self._make_order()
        self._i = 0

    def _make_order(self) -> List[int]:
        order = list(range(len(self.files)))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        return order

    def reset(self) -> None:
        self._epoch += 1
        self._order = self._make_order()
        self._i = 0

    def has_next(self) -> bool:
        return self._i < len(self._order)

    def _next_impl(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        path = os.path.join(self.directory, self.files[self._order[self._i]])
        self._i += 1
        with np.load(path) as z:
            return DataSet(
                z["features"], z["labels"],
                z["features_mask"] if "features_mask" in z else None,
                z["labels_mask"] if "labels_mask" in z else None)

    def batch(self) -> int:
        bs = self.manifest.get("batch_size")
        if bs:
            return bs
        with np.load(os.path.join(self.directory, self.files[0])) as z:
            return len(z["features"])

    def total_examples(self) -> Optional[int]:
        return self.manifest.get("num_examples")

    def state(self) -> dict:
        """The cursor (epoch and position), JSON-serializable."""
        return {"epoch": self._epoch, "position": self._i,
                "shuffle": self.shuffle, "seed": self.seed}

    def restore(self, state: dict) -> "ExportedDataSetIterator":
        if state.get("shuffle", self.shuffle) != self.shuffle or \
                state.get("seed", self.seed) != self.seed:
            raise ValueError("cannot restore: shuffle/seed mismatch with "
                             "the saved cursor")
        self._epoch = int(state["epoch"])
        self._order = self._make_order()
        self._i = int(state["position"])
        return self
