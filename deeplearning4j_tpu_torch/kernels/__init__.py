"""The port's hand-written CUDA kernels, built from this directory at
first use.

Each ``<name>.cu`` exposes plain C functions and includes no PyTorch
header (only CUDA's and this directory's ``.cuh`` files), so ``nvcc``
takes seconds. :func:`load` compiles one source for
``sm_90a`` into ``_build/lib<name>.so`` and opens it with ``ctypes``;
:func:`build` starts one ``nvcc`` per source, all at once, and waits for
them. A build that fails raises: there is no fallback to the plain
PyTorch versions on a CUDA device.

``LAUNCHES`` counts kernel launches by kernel name. Each wrapper adds
one where it launches its kernel and nowhere else, so a caller can reset
it, drive a path, and see which kernels the path really ran.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
from typing import Dict, Iterable

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("flash_fwd", "flash_bwd", "lstm_fwd", "lstm_bwd")
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES: "collections.Counter[str]" = collections.Counter()

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def source_path(name: str) -> str:
    return os.path.join(_HERE, name + ".cu")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = path if path and os.path.exists(path) else shutil.which("nvcc")
    if not path:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (CUDA_HOME or nvcc on PATH)")
    return path


def _newest_source(name: str) -> float:
    """The latest modification time of ``name``'s source and the shared
    headers it may include."""
    headers = [os.path.join(_HERE, f) for f in os.listdir(_HERE)
               if f.endswith(".cuh")]
    return max(os.path.getmtime(p) for p in [source_path(name), *headers])


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile each source in ``names`` with its own ``nvcc`` process,
    all started together, into ``_build/``. Returns the compiler's
    report (``-Xptxas -v``: registers, shared memory, spills) per source;
    a failed compile raises with its output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        tmp = f"{_lib_path(name)}.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, _lib_path(name))  # readers never see a partial file
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """Open the kernel library ``name``, building it first when it is
    missing or older than its source (once per process)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if (not os.path.exists(path)
                or os.path.getmtime(path) < _newest_source(name)):
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(path)
    return lib
