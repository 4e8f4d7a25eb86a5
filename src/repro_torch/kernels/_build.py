"""Build and load the port's CUDA kernels at first use.

Each kernel source under ``repro_torch/csrc`` is built by
``torch.utils.cpp_extension.load`` into ``build/torch_ext/`` at the
repository root (git-ignored), for ``sm_90a``. The sources have a plain C
interface and include none of PyTorch's headers, so a build takes
seconds rather than minutes; the wrapper calls the launcher through
``ctypes`` and raises on the CUDA error it returns. Nothing here runs at
import time: the CPU tests import every module on a machine without
``nvcc``.
"""
from __future__ import annotations

import ctypes
import pathlib

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "torch_ext"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

_libs = {}


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built on first use (and
    rebuilt by ``load`` when the source or flags change). A failed build
    raises with the compiler's output."""
    if name in _libs:
        return _libs[name]
    from torch.utils.cpp_extension import load as torch_load
    BUILD_DIR.mkdir(parents=True, exist_ok=True)   # load's lock file lives here
    path = torch_load(name=f"repro_torch_{name}",
                      sources=[str(CSRC / f"{name}.cu")],
                      extra_cuda_cflags=CUDA_FLAGS,
                      build_directory=str(BUILD_DIR),
                      is_python_module=False, verbose=False)
    lib = ctypes.CDLL(path)
    _libs[name] = lib
    return lib
