"""ctypes bindings for the native IO kernels, with NumPy fallbacks.

Counterpart of ``deeplearning4j_tpu/native/__init__.py``. The port
keeps its own copy of the C++ source (``io_kernels.cpp`` beside this
module); ``get_lib`` builds it with ``g++`` at its first call, never at
import, into ``_build/`` beside it (rebuilt when the source is newer),
and loads it. Where no toolchain is present, or the build fails,
``get_lib`` returns None and every function here and in
``datasets/native_batcher.py`` computes the same result in NumPy: the
reference's contract for host IO.

- ``csv_read_floats(path, skip_rows, threads, strict)``: a numeric CSV
  file as float32 [rows, cols], parsed by a thread pool;
- ``idx_read(path)``: an uncompressed IDX file (MNIST's format) in
  native byte order, or None for the caller's own parser.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_log = logging.getLogger("deeplearning4j_tpu_torch")

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "io_kernels.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
LIB = os.path.join(BUILD_DIR, "libdl4jtorch_io.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_IDX_DTYPES = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.dtype(">i2"),
               0x0C: np.dtype(">i4"), 0x0D: np.dtype(">f4"), 0x0E: np.dtype(">f8")}


def _build() -> bool:
    """Compile the source into ``LIB`` (through a file of this process's
    own, renamed into place, so that concurrent processes never load a
    half-written library)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17",
           "-o", tmp, SRC]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=240)
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        _log.info("native io build unavailable (%s); using the NumPy fallback", e)
        return False
    if proc.returncode != 0:
        _log.warning("native io build failed, using the NumPy fallback:\n%s",
                     proc.stderr[-1000:])
        return False
    os.replace(tmp, LIB)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built at the first call if needed; None where
    it cannot be built or loaded (the NumPy fallbacks run then)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(LIB) or (
                os.path.getmtime(SRC) > os.path.getmtime(LIB)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(LIB)
        except OSError as e:
            _log.warning("native io load failed (%s); NumPy fallback", e)
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.dl4j_csv_shape.argtypes = [ctypes.c_char_p, ctypes.c_int64, i64p, i64p]
        lib.dl4j_csv_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                       ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        lib.dl4j_csv_parse.restype = ctypes.c_int64
        lib.dl4j_idx_header.argtypes = [ctypes.c_char_p,
                                        ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_int), i64p]
        lib.dl4j_idx_read.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int64]
        _lib = lib
        return _lib


def _bad_cells(bad: int, path: str):
    return ValueError(f"{bad} non-numeric cell(s) in {path}; "
                      f"use strict=False to zero-fill them")


def csv_read_floats(path: str, skip_rows: int = 0, threads: int = 0,
                    strict: bool = False) -> np.ndarray:
    """A numeric CSV file as float32 [rows, cols], by the native parser
    (``threads`` workers, 0 for the machine's count) or its NumPy
    fallback, with the same semantics: ``skip_rows`` counts physical
    lines, whitespace-only lines are dropped, cells may be quoted, and a
    non-numeric cell reads 0.0, unless ``strict``, which raises."""
    lib = get_lib()
    if lib is None:
        return _csv_read_floats_py(path, skip_rows, strict)
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.dl4j_csv_shape(path.encode(), skip_rows,
                            ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise IOError(f"csv shape scan failed rc={rc}: {path}")
    out = np.empty((rows.value, cols.value), np.float32)
    bad = lib.dl4j_csv_parse(
        path.encode(), skip_rows,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rows.value, cols.value, threads)
    if bad < 0:
        raise IOError(f"csv parse failed rc={bad}: {path}")
    if strict and bad > 0:
        raise _bad_cells(bad, path)
    return out


def _csv_read_floats_py(path: str, skip_rows: int,
                        strict: bool = False) -> np.ndarray:
    rows, bad = [], 0
    with open(path) as f:
        for i, line in enumerate(f):
            if i < skip_rows or not line.strip():
                continue
            vals = []
            for cell in line.rstrip("\n").split(","):
                cell = cell.strip().strip('"')
                try:
                    vals.append(float(cell))
                except ValueError:
                    vals.append(0.0)
                    bad += 1
            rows.append(vals)
    if strict and bad > 0:
        raise _bad_cells(bad, path)
    return np.asarray(rows, np.float32)


def idx_read(path: str) -> Optional[np.ndarray]:
    """An uncompressed IDX file read natively, in native byte order; None
    (for the caller's own parser) for a ``.gz`` file, without the
    library, or where the header does not parse."""
    lib = get_lib()
    if lib is None or path.endswith(".gz"):
        return None
    dtype, ndim = ctypes.c_int(), ctypes.c_int()
    dims = (ctypes.c_int64 * 8)()
    if lib.dl4j_idx_header(path.encode(), ctypes.byref(dtype),
                           ctypes.byref(ndim), dims) != 0:
        return None
    np_dtype = _IDX_DTYPES.get(dtype.value)
    if np_dtype is None:
        return None
    shape = tuple(dims[i] for i in range(ndim.value))
    nbytes = int(np.prod(shape)) * np.dtype(np_dtype).itemsize
    out = np.empty(nbytes, np.uint8)
    if lib.dl4j_idx_read(path.encode(),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                         nbytes) != 0:
        return None
    arr = out.view(np_dtype).reshape(shape)
    if np.dtype(np_dtype).byteorder == ">":
        arr = arr.astype(np.dtype(np_dtype).newbyteorder("="))
    return arr
