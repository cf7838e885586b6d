"""Build the port's CUDA kernels into one shared library and load it.

The sources are ``sdr_tpu_torch/csrc/*.cu``.  They are compiled at first
use by ``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per source, all
started together, and linked into one ``.so`` with a plain C interface,
which is loaded with ``ctypes``: a build takes seconds, where an extension
that includes PyTorch's headers takes minutes.  The library goes to
``build/sdr_tpu_torch/<hash>/`` at the repository root (listed in
``.gitignore``), keyed by a hash of the sources and flags, so an unchanged
checkout builds once and an edited source rebuilds.  ``nvcc``'s output,
including ``ptxas``'s register and shared-memory report, is kept beside the
library as ``build.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "sdr_tpu_torch"
LIB_NAME = "libsdr_tpu_torch.so"

# --fmad=false keeps the PLL recurrence rounding op by op like the plain
# PyTorch loop; the FIR kernels' multiply-adds are explicit fmaf.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                           "the CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / LIB_NAME


def build() -> tuple[Path, float]:
    """Compile the library unless it is already built for these sources.

    Returns (path, seconds spent compiling and linking; 0.0 when it was
    built before).  Raises RuntimeError with the compiler's output when
    nvcc fails."""
    out = library_path()
    if out.exists():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(_sources(), objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        results = [(cmd, p.communicate()[0], p.returncode)
                   for cmd, p in zip(cmds, procs)]
        lib_tmp = Path(tmp) / LIB_NAME
        if all(rc == 0 for _, _, rc in results):
            link = [nvcc, "-shared", "-o", str(lib_tmp), *map(str, objs)]
            proc = subprocess.run(link, capture_output=True, text=True)
            results.append((link, proc.stdout + proc.stderr,
                            proc.returncode))
        log = "".join(" ".join(cmd) + "\n" + text
                      for cmd, text, _ in results)
        (out.parent / "build.log").write_text(log)
        failed = [rc for _, _, rc in results if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
        os.replace(lib_tmp, out)    # atomic: a concurrent loader sees all
    return out, time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build if needed, load the library and declare its C interface.
    Every function returns ``cudaGetLastError()`` after its launch."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # iq, state, h, y, batch, n, k, decim, stream
    lib.sdr_fir_frontend_u8.argtypes = [p, p, p, p, i, i, i, i, p]
    # x, state, h, y, batch, arms, outer_stride, arm_stride, step, n, k,
    # decim, stream
    for fn in (lib.sdr_fir_decim_f32, lib.sdr_fir_decim_i8):
        fn.argtypes = [p, p, p, p, i, i, q, q, q, i, i, i, p]
    # xs, carry0, consts, args, carry_out, n, lanes, ld, stream
    lib.sdr_pll_angles.argtypes = [p, p, p, p, p, i, i, i, p]
    # xs, mix, carry0, consts, mixer, carry_out, n, lanes, ld, stream
    lib.sdr_pll_mixer.argtypes = [p, p, p, p, p, p, i, i, i, p]
    # carry0, consts, carry_out, n, lanes, stream
    lib.sdr_pll_chain_floor.argtypes = [p, p, p, i, i, p]
    # device, src table, dst table (host arrays of device pointers),
    # shards, rows, n, src_stride, dst_stride, stream
    table = ctypes.POINTER(ctypes.c_void_p)
    lib.sdr_halo_shift.argtypes = [i, table, table, i, i, q, q, q, p]
    # device, peer
    lib.sdr_halo_enable_peer.argtypes = [i, i]
    for fn in (lib.sdr_fir_frontend_u8, lib.sdr_fir_decim_f32,
               lib.sdr_fir_decim_i8, lib.sdr_pll_angles, lib.sdr_pll_mixer,
               lib.sdr_pll_chain_floor, lib.sdr_halo_shift,
               lib.sdr_halo_enable_peer):
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
