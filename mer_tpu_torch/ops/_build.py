"""Build and load the port's CUDA kernels (plain C interface, ``ctypes``).

A source ``mer_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` into a
shared library under ``mer_tpu_torch/_build/``, at first use. The library's
file name carries a hash of the source, the shared headers ``csrc/*.cuh``
and the flags, so an edited source or header builds anew. Nothing outside
the package's sources goes into a build, and a missing ``nvcc`` or a failed
build raises. Builds of different kernels may run at once (one ``nvcc``
each); ``chip_smoke.py`` starts them together.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source at first use")


def _source(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    """Where kernel ``name``'s library lives for the current source and headers."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [_source(name), *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build(name: str) -> bool:
    """Build kernel ``name`` unless it is built already; True if it was built."""
    final = library_path(name)
    if os.path.exists(final):
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _source(name)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, final)  # atomic: a reader never sees half a library
    return True


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build(name)
            lib = _loaded[name] = ctypes.CDLL(library_path(name))
    return lib
