"""Sample ingestion and audio emission (reference L0, src/iofunc.cpp).

Byte-level input: interleaved unsigned-8-bit I/Q blocks from a file or
stdin pipe (an RTL-SDR capture), normalized to [-1, 1) float32 exactly like
``readStdinBlockData`` (src/iofunc.cpp:128-135): (x - 128) / 128.

Output: 16-bit little-endian PCM to a stream (the reference's
threadMonoOnly.cpp:186-191 path, including its NaN->0 clamp :188), plus
float32 ``.bin`` and ``.wav`` writers (src/iofunc.cpp:31-86,
model/stereo.py:301-312).

When the native C extension is available (sdr_tpu_torch.native), the u8->f32
conversion and PCM quantization run in C; the numpy path is the fallback
and the semantics oracle.

The port's own copy of ``sdr_tpu/io.py``, behaviour
unchanged, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import sys
from typing import BinaryIO, Iterator, Optional

import numpy as np


def u8_normalize(raw: np.ndarray) -> np.ndarray:
    """(x - 128) / 128 normalization (src/iofunc.cpp:133-134)."""
    try:
        from sdr_tpu_torch import native
        return native.u8_normalize(raw)
    except ImportError:
        return (raw.astype(np.float32) - 128.0) / 128.0


def read_iq_u8(path_or_stream, count: int = -1) -> np.ndarray:
    """Whole-file interleaved u8 IQ -> normalized float32
    (model/fmMonoBasic.py:92-95)."""
    if hasattr(path_or_stream, "read"):
        raw = np.frombuffer(path_or_stream.read(
            count if count > 0 else -1), dtype=np.uint8)
    else:
        raw = np.fromfile(path_or_stream, dtype=np.uint8, count=count)
    return u8_normalize(raw)


def iter_iq_blocks(stream: BinaryIO, block_size: int) -> Iterator[np.ndarray]:
    """Stream fixed-size normalized IQ blocks from a binary stream; stops at
    EOF, dropping any short tail (src/iofunc.cpp:128-135 contract:
    a short read signals end of stream)."""
    for raw in iter_iq_blocks_raw(stream, block_size):
        yield u8_normalize(raw)


def iter_iq_blocks_raw(stream: BinaryIO,
                       block_size: int) -> Iterator[np.ndarray]:
    """Raw-u8 variant of :func:`iter_iq_blocks`: blocks stay uint8 so the
    receiver normalizes on-device (bit-identical to host normalization —
    1/128 is a power of two — at a quarter of the host->device bytes)."""
    while True:
        raw = stream.read(block_size)
        if raw is None or len(raw) < block_size:
            return
        yield np.frombuffer(raw, dtype=np.uint8)


def pcm_quantize(x: np.ndarray) -> np.ndarray:
    """float audio -> int16 PCM with the reference's NaN->0 clamp and
    16384 full-scale factor (src/threadMonoOnly.cpp:186-191)."""
    try:
        from sdr_tpu_torch import native
        return native.pcm_quantize(np.ascontiguousarray(x, dtype=np.float32))
    except ImportError:
        y = np.where(np.isnan(x), 0.0, x) * 16384.0
        # saturate exactly like the native path (int16 full range)
        return np.clip(y, -32768.0, 32767.0).astype(np.int16)


def write_pcm(stream: BinaryIO, x: np.ndarray) -> None:
    """Write 16-bit LE PCM samples (mono: (n,); stereo: (n, 2) interleaved
    L,R like write_audio_data, src/iofunc.cpp:65-86)."""
    stream.write(pcm_quantize(x).tobytes())


def write_wav(path: str, audio: np.ndarray, fs: float) -> None:
    """16-bit PCM .wav (model/stereo.py:301-312).  ``audio`` is (n,) mono or
    (n, 2) stereo float."""
    from scipy.io import wavfile
    wavfile.write(path, int(fs), pcm_quantize(audio))


class StreamingWavWriter:
    """Incremental 16-bit PCM .wav writer: O(block) host memory.

    Writes the 44-byte RIFF header with placeholder sizes up front,
    streams quantized frames per ``write`` call, and patches the RIFF and
    data chunk sizes on ``close`` (the file stays a valid wav after every
    flush given the patch — standard seekable-header technique).  Replaces
    accumulate-then-``write_wav`` on long captures (the serving regime:
    BASELINE.json's pod-scale config is a 1-hour recording).
    """

    def __init__(self, path: str, fs: float, channels: int = 1):
        import struct
        self.path = path
        self.channels = int(channels)
        self.fs = int(fs)
        self._n_frames = 0
        self._f = open(path, "wb")
        byte_rate = self.fs * self.channels * 2
        self._f.write(b"RIFF" + struct.pack("<I", 0) + b"WAVE"
                      + b"fmt " + struct.pack("<IHHIIHH", 16, 1,
                                              self.channels, self.fs,
                                              byte_rate, self.channels * 2,
                                              16)
                      + b"data" + struct.pack("<I", 0))

    def write(self, audio: np.ndarray) -> None:
        """Append float frames ((n,) mono or (n, channels))."""
        pcm = pcm_quantize(audio)
        n = pcm.shape[0]
        assert pcm.size == n * self.channels, (pcm.shape, self.channels)
        self._f.write(pcm.tobytes())
        self._n_frames += n

    def close(self) -> None:
        import struct
        data_bytes = self._n_frames * self.channels * 2
        self._f.seek(4)
        self._f.write(struct.pack("<I", 36 + data_bytes))
        self._f.seek(40)
        self._f.write(struct.pack("<I", data_bytes))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_f32(path: str) -> np.ndarray:
    """float32 .bin reader (src/iofunc.cpp:31-47)."""
    return np.fromfile(path, dtype=np.float32)


def write_f32(path: str, x: np.ndarray) -> None:
    """float32 .bin writer (src/iofunc.cpp:50-59)."""
    np.asarray(x, dtype=np.float32).tofile(path)


def print_first_last(x: np.ndarray, n: int = 5, label: str = "",
                     stream=None) -> None:
    """Debug printer: first/last n values (ref printFirstLastN,
    src/iofunc.cpp:113-124 — the reference's golden-vs-C++ comparison
    surface, data/data/pipeData.txt).  Handles complex values and arrays
    shorter than 2n (printed once, no overlap)."""
    stream = stream or sys.stderr
    x = np.asarray(x).reshape(-1)
    fmt = (str if np.iscomplexobj(x) else (lambda v: f"{v:.9f}"))
    if len(x) <= 2 * n:
        body = ", ".join(fmt(v) for v in x)
    else:
        head = ", ".join(fmt(v) for v in x[:n])
        tail = ", ".join(fmt(v) for v in x[-n:])
        body = f"{head} ... {tail}"
    print(f"{label}[{len(x)}]: [{body}]", file=stream)


def stdin_binary() -> BinaryIO:
    return sys.stdin.buffer


def stdout_binary() -> BinaryIO:
    return sys.stdout.buffer
