"""The port's hand-written CUDA kernels, built from this directory at
first use.

Each ``<name>.cu`` exposes plain C functions and includes no PyTorch
header, so ``nvcc`` takes seconds. :func:`load` compiles one source with
``torch.utils.cpp_extension.load`` for ``sm_90a`` into ``_build/`` and
opens the shared library with ``ctypes``. A build that fails raises:
there is no fallback to the plain PyTorch versions on a CUDA device.

``LAUNCHES`` counts kernel launches by kernel name. Each wrapper adds
one where it launches its kernel and nowhere else, so a caller can reset
it, drive a path, and see which kernels the path really ran.
"""

from __future__ import annotations

import collections
import ctypes
import os

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES: "collections.Counter[str]" = collections.Counter()

_LIBS: dict = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def source_path(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), name + ".cu")


def load(name: str) -> ctypes.CDLL:
    """Build (once per process) and open the kernel library ``name``."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    from torch.utils.cpp_extension import load as cpp_load

    os.makedirs(BUILD_DIR, exist_ok=True)
    module = f"dl4j_{name}"
    cpp_load(name=module, sources=[source_path(name)],
             extra_cuda_cflags=CUDA_FLAGS, build_directory=BUILD_DIR,
             is_python_module=False, verbose=False)
    lib = ctypes.CDLL(os.path.join(BUILD_DIR, module + ".so"))
    _LIBS[name] = lib
    return lib
