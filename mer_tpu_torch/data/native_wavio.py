"""The native batch WAV decoder, ``native/wavio.cc``, bound with ``ctypes``
(counterpart of ``mer_tpu/data/native_wavio.py``).

A thread pool decodes a whole batch of PCM WAV files into one preallocated
[n, max_samples] float32 buffer: the host side of the streaming pipeline's
stage 1. The source compiles at first use with the flags of
``native/Makefile`` into ``mer_tpu_torch/_build/``, under a file name that
carries a hash of the source and the flags, so an edited source builds anew;
nothing is written into ``native/``. A failed build raises: no silent fallback.
``MER_TPU_NATIVE=0`` turns the decoder off (:func:`available` is then False
and the callers use the stdlib reader of :mod:`mer_tpu_torch.data.audio_io`).

Per-file error codes in the lengths: -1 open, -2 format, -3 sample rate.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading

import numpy as np

from mer_tpu_torch.ops import _build

SOURCE = os.path.join(os.path.dirname(os.path.dirname(_build.BUILD_DIR)), "native", "wavio.cc")
BUILD_DIR = _build.BUILD_DIR
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")  # native/Makefile's

ERR_OPEN, ERR_FORMAT, ERR_RATE = -1, -2, -3

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libwavio_{h.hexdigest()[:16]}.so")


def build() -> bool:
    """Compile ``native/wavio.cc`` unless it is built already; True if it was built."""
    return _build.compile_library([os.environ.get("CXX", "g++"), *CXX_FLAGS], SOURCE, library_path())


def load() -> ctypes.CDLL:
    """The loaded decoder, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(library_path())
            lib.decode_wav_batch.restype = ctypes.c_int
            lib.decode_wav_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int]
            _lib = lib
    return _lib


def available() -> bool:
    """Whether callers should decode through the native library: True unless
    ``MER_TPU_NATIVE=0`` asks for the stdlib reader. Building happens at the
    first decode, and a failed build raises there."""
    return os.environ.get("MER_TPU_NATIVE") != "0"


def decode_wav_batch(paths: list[str], max_samples: int, expect_rate: int = 0, n_threads: int = 0,
                     out: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Decode PCM wavs into a [n, max_samples] float32 buffer, zero past each
    clip (cut at ``max_samples``). Returns (buffer, lengths int32); a negative
    length is a per-file error: -1 open, -2 format, -3 a rate other than
    ``expect_rate`` (checked when it is > 0). ``n_threads`` 0 lets the library pick."""
    if not available():
        raise RuntimeError("the native wav decoder is turned off (MER_TPU_NATIVE=0)")
    lib = load()
    n = len(paths)
    if out is None:
        out = np.empty((n, max_samples), dtype=np.float32)
    if out.shape != (n, max_samples) or out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous float32 [{n}, {max_samples}] buffer")
    lengths = np.empty((n,), dtype=np.int32)
    names = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.decode_wav_batch(names, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_samples,
                         lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), expect_rate, n_threads)
    return out, lengths
