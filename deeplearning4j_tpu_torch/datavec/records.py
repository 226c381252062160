"""The RecordReader protocol and its CSV, sequence, line and image readers.

Counterpart of ``deeplearning4j_tpu/datavec/records.py``: a reader
yields records, a record being a list of values (floats where they
parse, strings otherwise), or a [t, f] float array for a sequence
reader. ``CSVRecordReader`` reads one record per row,
``LineRecordReader`` one per raw line, ``CSVSequenceRecordReader`` one
sequence per file (its rows the timesteps; comma-delimited files are
parsed by ``native.csv_read_floats``, strictly), and
``ImageRecordReader`` [h, w, c] float images in [0, 255] from a
directory per label, decoded by PIL, which it imports at its first
image. Readers run on the host, behind the feed pipeline's threads.
"""

from __future__ import annotations

import csv
import io
import os
from typing import List, Optional, Sequence

import numpy as np


class RecordReader:
    """``RecordReader`` contract: initialize(source) → iterate records."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next_record(self):
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        if not self.has_next():
            raise StopIteration
        return self.next_record()


class CSVRecordReader(RecordReader):
    """``CSVRecordReader`` — one record per CSV row; values parsed to
    float when possible, else kept as strings (label columns)."""

    def __init__(self, path_or_lines, skip_lines: int = 0, delimiter: str = ","):
        if isinstance(path_or_lines, (list, tuple)):
            self._lines = [l for l in path_or_lines]
        else:
            with open(path_or_lines, newline="") as f:
                self._lines = f.read().splitlines()
        self._skip = skip_lines
        self._delim = delimiter
        self._rows: List[List[object]] = []
        for line in self._lines[skip_lines:]:
            if not line.strip():
                continue
            row = next(csv.reader(io.StringIO(line), delimiter=delimiter))
            self._rows.append([self._parse(v) for v in row])
        self._pos = 0

    @staticmethod
    def _parse(v: str):
        try:
            return float(v)
        except ValueError:
            return v.strip()

    def has_next(self):
        return self._pos < len(self._rows)

    def next_record(self):
        r = self._rows[self._pos]
        self._pos += 1
        return list(r)

    def reset(self):
        self._pos = 0

    def num_records(self) -> int:
        return len(self._rows)


class LineRecordReader(RecordReader):
    """``LineRecordReader`` — one record per raw text line."""

    def __init__(self, path_or_lines):
        if isinstance(path_or_lines, (list, tuple)):
            self._lines = list(path_or_lines)
        else:
            with open(path_or_lines) as f:
                self._lines = f.read().splitlines()
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._lines)

    def next_record(self):
        line = self._lines[self._pos]
        self._pos += 1
        return [line]

    def reset(self):
        self._pos = 0


class CSVSequenceRecordReader(RecordReader):
    """``CSVSequenceRecordReader`` — one sequence per CSV FILE (the
    reference's convention): each file's rows are the timesteps."""

    def __init__(self, paths: Sequence[str], skip_lines: int = 0,
                 delimiter: str = ","):
        self._paths = list(paths)
        self._skip = skip_lines
        self._delim = delimiter
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._paths)

    def next_record(self) -> np.ndarray:
        """Returns the [t, f] float array for one sequence. Numeric CSVs
        are parsed by the native multithreaded reader when available
        (comma-delimited only; other delimiters take the python path)."""
        path = self._paths[self._pos]
        self._pos += 1
        if self._delim == ",":
            from deeplearning4j_tpu_torch.native import csv_read_floats
            try:
                # strict: a mis-pointed or string-labelled file fails
                # loudly instead of training on zero-filled features
                return csv_read_floats(path, skip_rows=self._skip, strict=True)
            except IOError:
                pass
        reader = CSVRecordReader(path, self._skip, self._delim)
        rows = [r for r in reader]
        return np.asarray(rows, np.float32)

    def reset(self):
        self._pos = 0

    def num_records(self) -> int:
        return len(self._paths)


class ImageRecordReader(RecordReader):
    """``ImageRecordReader`` — images from a directory-per-label tree
    (``parent/<label>/<file>``), decoded to [h, w, c] float NHWC in
    [0, 255] like the reference's native image loader; resized to
    (height, width)."""

    EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif")

    def __init__(self, height: int, width: int, channels: int = 3,
                 root_dir: Optional[str] = None,
                 paths_and_labels: Optional[Sequence] = None):
        self.h, self.w, self.c = height, width, channels
        items: List = []
        if root_dir is not None:
            for label in sorted(os.listdir(root_dir)):
                d = os.path.join(root_dir, label)
                if not os.path.isdir(d):
                    continue
                for fn in sorted(os.listdir(d)):
                    if fn.lower().endswith(self.EXTS):
                        items.append((os.path.join(d, fn), label))
        if paths_and_labels:
            items.extend(paths_and_labels)
        self._items = items
        self.labels = sorted({lab for _, lab in items})
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._items)

    def next_record(self):
        """Returns [image_array, label_index]."""
        path, label = self._items[self._pos]
        self._pos += 1
        from PIL import Image
        img = Image.open(path)
        img = img.convert("L" if self.c == 1 else "RGB")
        img = img.resize((self.w, self.h))
        arr = np.asarray(img, np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return [arr, self.labels.index(label)]

    def reset(self):
        self._pos = 0

    def num_records(self) -> int:
        return len(self._items)
