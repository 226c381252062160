"""RecordReader to DataSet and MultiDataSet iterators.

Counterpart of ``deeplearning4j_tpu/datavec/iterator.py``:
``RecordReaderDataSetIterator`` (one reader; a label column one-hot over
``num_classes``, string labels mapped in sorted order, or passed through
for ``regression``; ``label_index=None`` for unlabeled features, which
then stand for the labels too), ``SequenceRecordReaderDataSetIterator``
(a features and a labels sequence reader, padded to the batch's longest
sequence with masks, aligned at the start or at the end) and
``RecordReaderMultiDataSetIterator`` (named readers composed into the
inputs and one-hot outputs of a ComputationGraph's MultiDataSet).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator, MultiDataSetIterator
from deeplearning4j_tpu_torch.datavec.records import ImageRecordReader, RecordReader


def _one_hot(idx: int, n: int) -> np.ndarray:
    v = np.zeros((n,), np.float32)
    v[int(idx)] = 1.0
    return v


class RecordReaderDataSetIterator(DataSetIterator):
    """Single record reader → DataSet minibatches.

    ``label_index`` marks the label column (classification with
    ``num_classes``, or regression when ``regression=True``);
    ``label_index=None`` yields unlabeled features (labels == features,
    the reference's unsupervised convention for pretrain feeds).
    For ``ImageRecordReader`` records ([array, label]) the array is the
    feature block.
    """

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: Optional[int] = -1,
                 num_classes: Optional[int] = None,
                 regression: bool = False,
                 labels: Optional[Sequence[str]] = None):
        self.reader = reader
        self._batch = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self._label_map: Dict[str, int] = {}
        if labels is not None:
            # explicit canonical label list (cross-split contract)
            self._label_map = {s: i for i, s in enumerate(labels)}
        elif (not regression and label_index is not None
                and not isinstance(reader, ImageRecordReader)):
            # canonical (sorted) string-label map, like the reference's
            # label list: first-encounter order would make the class
            # indices depend on record order and differ across splits
            strings = set()
            self.reader.reset()
            for rec in self.reader:
                vals = list(rec)
                li = label_index if label_index >= 0 else len(vals) + label_index
                if isinstance(vals[li], str):
                    strings.add(vals[li])
            self._label_map = {s: i for i, s in enumerate(sorted(strings))}
            if (strings and num_classes is not None
                    and len(self._label_map) != num_classes):
                raise ValueError(
                    f"this split contains {len(self._label_map)} distinct "
                    f"string labels ({sorted(strings)}) but num_classes="
                    f"{num_classes}; indices would disagree across splits — "
                    f"pass labels=<canonical list> to pin the mapping")
        self.reader.reset()

    def reset(self):
        self.reader.reset()

    def has_next(self):
        return self.reader.has_next()

    def batch(self):
        return self._batch

    def _split(self, rec) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        if isinstance(self.reader, ImageRecordReader) or (
                len(rec) == 2 and isinstance(rec[0], np.ndarray) and rec[0].ndim >= 2):
            arr, label = rec
            x = np.asarray(arr, np.float32)
            if self.label_index is None:
                return x, None
            if self.regression:
                return x, np.asarray([label], np.float32)
            return x, _one_hot(label, self.num_classes or len(self.reader.labels))
        vals = list(rec)
        if self.label_index is None:
            return np.asarray(vals, np.float32), None
        li = self.label_index if self.label_index >= 0 else len(vals) + self.label_index
        label = vals.pop(li)
        x = np.asarray(vals, np.float32)
        if self.regression:
            return x, np.asarray([float(label)], np.float32)
        if self.num_classes is None:
            raise ValueError("classification needs num_classes")
        return x, _one_hot(float(label) if not isinstance(label, str) else
                           self._label_to_index(label), self.num_classes)

    def _label_to_index(self, label: str) -> int:
        if label not in self._label_map:
            raise ValueError(f"unseen string label {label!r}; known: "
                             f"{sorted(self._label_map)}")
        return self._label_map[label]

    def _next_impl(self) -> DataSet:
        xs, ys = [], []
        while self.reader.has_next() and len(xs) < self._batch:
            x, y = self._split(self.reader.next_record())
            xs.append(x)
            ys.append(y)
        feats = np.stack(xs)
        labels = feats if ys[0] is None else np.stack(ys)
        return DataSet(feats, labels)


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Aligned feature + label sequence readers → padded, masked
    sequence DataSets (``SequenceRecordReaderDataSetIterator.java``).

    ``align="start"`` (default) left-aligns sequences, zero-padding and
    masking the tail (DL4J ALIGN_START); ``align="end"`` right-aligns so
    every sequence's last real timestep sits at index T-1 (DL4J
    ALIGN_END — the sequence-to-last-step convention)."""

    def __init__(self, features_reader: RecordReader,
                 labels_reader: Optional[RecordReader], batch_size: int,
                 num_classes: Optional[int] = None, regression: bool = False,
                 align: str = "start"):
        if align not in ("start", "end"):
            raise ValueError(f"align must be 'start' or 'end', got {align!r}")
        self.fr = features_reader
        self.lr = labels_reader
        self._batch = batch_size
        self.num_classes = num_classes
        self.regression = regression
        self.align = align

    def reset(self):
        self.fr.reset()
        if self.lr is not None:
            self.lr.reset()

    def has_next(self):
        return self.fr.has_next()

    def batch(self):
        return self._batch

    def _next_impl(self) -> DataSet:
        fseqs, lseqs = [], []
        while self.fr.has_next() and len(fseqs) < self._batch:
            f = np.asarray(self.fr.next_record(), np.float32)
            fseqs.append(f)
            if self.lr is not None:
                l = np.asarray(self.lr.next_record(), np.float32)
                if not self.regression:
                    if self.num_classes is None:
                        raise ValueError("classification needs num_classes")
                    l = np.eye(self.num_classes, dtype=np.float32)[
                        l.astype(int).ravel()]
                lseqs.append(l)
        T = max(s.shape[0] for s in fseqs)
        b = len(fseqs)

        def pack(seqs, width):
            arr = np.zeros((b, T, width), np.float32)
            mask = np.zeros((b, T), np.float32)
            for i, s in enumerate(seqs):
                if self.align == "end":
                    arr[i, T - s.shape[0]:] = s
                    mask[i, T - s.shape[0]:] = 1.0
                else:
                    arr[i, :s.shape[0]] = s
                    mask[i, :s.shape[0]] = 1.0
            return arr, mask

        x, mask = pack(fseqs, fseqs[0].shape[-1])
        if self.lr is None:
            return DataSet(x, x, features_mask=mask, labels_mask=mask)
        y, lmask = pack(lseqs, lseqs[0].shape[-1])
        return DataSet(x, y, features_mask=mask, labels_mask=lmask)


class RecordReaderMultiDataSetIterator(MultiDataSetIterator):
    """Named readers → MultiDataSet (``RecordReaderMultiDataSetIterator``
    builder semantics): each input/output selects a reader and either a
    column range ("all features") or a one-hot label column."""

    def __init__(self, batch_size: int):
        self._batch = batch_size
        self._readers: Dict[str, RecordReader] = {}
        self._inputs: List[Tuple[str, Optional[int], Optional[int]]] = []
        self._outputs: List[Tuple[str, int, int]] = []

    def add_reader(self, name: str, reader: RecordReader):
        self._readers[name] = reader
        return self

    def add_input(self, reader_name: str, col_from: Optional[int] = None,
                  col_to: Optional[int] = None):
        self._inputs.append((reader_name, col_from, col_to))
        return self

    def add_output_one_hot(self, reader_name: str, column: int, num_classes: int):
        self._outputs.append((reader_name, column, num_classes))
        return self

    def reset(self):
        for r in self._readers.values():
            r.reset()

    def has_next(self):
        return all(r.has_next() for r in self._readers.values())

    def batch(self):
        return self._batch

    def _next_impl(self) -> MultiDataSet:
        rows: Dict[str, List[List[float]]] = {n: [] for n in self._readers}
        count = 0
        while self.has_next() and count < self._batch:
            for n, r in self._readers.items():
                rows[n].append(list(r.next_record()))
            count += 1
        feats = []
        for name, c0, c1 in self._inputs:
            arr = np.asarray([[float(v) for v in row] for row in rows[name]],
                             np.float32)
            feats.append(arr[:, c0:c1] if c0 is not None or c1 is not None else arr)
        labels = []
        for name, col, ncls in self._outputs:
            idx = np.asarray([float(row[col]) for row in rows[name]]).astype(int)
            labels.append(np.eye(ncls, dtype=np.float32)[idx])
        return MultiDataSet(features=feats, labels=labels)
