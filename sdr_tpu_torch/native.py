"""ctypes bindings to the native host runtime (``native/sdr_native.cpp``).

The port's own binding of the C++ source that both packages share at the
repository root (the JAX package binds it in ``sdr_tpu/native``).  On first
import it builds ``libsdr_native.so`` with g++ into
``build/sdr_native/`` (listed in ``.gitignore``); the build writes a
temporary file and renames it, so concurrent importers load a whole
library.  Import fails with ImportError when no toolchain is available:
callers (``sdr_tpu_torch.io``) then use the numpy implementations, which
are also the semantics oracle for the tests.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
_SRC = _ROOT / "native" / "sdr_native.cpp"
_SO = _ROOT / "build" / "sdr_native" / "libsdr_native.so"


def _build() -> None:
    _SO.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_SO.parent) as tmp:
        lib_tmp = Path(tmp) / _SO.name
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
               "-o", str(lib_tmp), str(_SRC)]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(lib_tmp, _SO)


def _load() -> ctypes.CDLL:
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        _build()
    lib = ctypes.CDLL(str(_SO))
    lib.sdr_u8_normalize.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64]
    lib.sdr_pcm_quantize.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int64]
    lib.sdr_reader_create.argtypes = [ctypes.c_int, ctypes.c_int64,
                                      ctypes.c_int]
    lib.sdr_reader_create.restype = ctypes.c_void_p
    lib.sdr_reader_next.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_float)]
    lib.sdr_reader_next.restype = ctypes.c_int
    lib.sdr_reader_next_u8.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_uint8)]
    lib.sdr_reader_next_u8.restype = ctypes.c_int
    lib.sdr_reader_depth.argtypes = [ctypes.c_void_p]
    lib.sdr_reader_depth.restype = ctypes.c_int
    lib.sdr_reader_destroy.argtypes = [ctypes.c_void_p]
    return lib


try:
    _lib = _load()
except (OSError, subprocess.CalledProcessError) as e:  # pragma: no cover
    raise ImportError(f"native runtime unavailable: {e}") from e


def u8_normalize(raw: np.ndarray) -> np.ndarray:
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    out = np.empty(raw.size, dtype=np.float32)
    _lib.sdr_u8_normalize(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), raw.size)
    return out.reshape(raw.shape)


def pcm_quantize(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(x.size, dtype=np.int16)
    _lib.sdr_pcm_quantize(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), x.size)
    return out.reshape(x.shape)


class BlockReader:
    """Threaded bounded-queue block feed from a file descriptor.

    The native producer thread reads u8 IQ ahead of the consumer (the
    receiver), mirroring the reference's front-end producer thread +
    capacity-6 queue.  With ``raw=True`` blocks come out as raw uint8 and
    normalization happens on the device in the u8 front-end (a quarter of
    the host->device bytes); ``raw=False`` yields host-normalized float32.
    """

    def __init__(self, fd: int, block_size: int, capacity: int = 6,
                 raw: bool = False):
        self._block_size = block_size
        self._raw = raw
        self._handle = _lib.sdr_reader_create(fd, block_size, capacity)

    def __iter__(self):
        try:
            while True:
                if self._raw:
                    out = np.empty(self._block_size, dtype=np.uint8)
                    ok = _lib.sdr_reader_next_u8(
                        self._handle,
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
                else:
                    out = np.empty(self._block_size, dtype=np.float32)
                    ok = _lib.sdr_reader_next(
                        self._handle,
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
                if not ok:
                    return
                yield out
        finally:
            self.close()

    def depth(self) -> int:
        return _lib.sdr_reader_depth(self._handle)

    def close(self) -> None:
        if self._handle is not None:
            _lib.sdr_reader_destroy(self._handle)
            self._handle = None
