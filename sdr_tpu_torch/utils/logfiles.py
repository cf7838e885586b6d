"""gnuplot ``.dat`` emission + index vectors (reference L5, src/logfunc.cpp).

The reference dumps named vectors for offline gnuplot inspection
(``logVector`` src/logfunc.cpp:23-43 writes "<index>\t<value>" pairs;
``genIndexVector`` :14-19).  Kept byte-compatible so the reference's
gnuplot configs (data/data/*.gnuplot) work unchanged against our dumps.

The port's own copy of ``sdr_tpu/utils/logfiles.py``, behaviour
unchanged, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import os

import numpy as np


def gen_index_vector(n: int) -> np.ndarray:
    """0..n-1 as float (src/logfunc.cpp:14-19)."""
    return np.arange(n, dtype=np.float64)


def log_vector(filename: str, x: np.ndarray, out_dir: str = ".",
               precision: int = 9) -> str:
    """Write "<index>\\t<value>" lines to ``<out_dir>/<filename>.dat``
    (src/logfunc.cpp:23-43; fixed-precision float formatting)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{filename}.dat")
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    with open(path, "w") as f:
        for i, v in enumerate(x):
            f.write(f"{float(i):.{precision}f}\t{v:.{precision}f}\n")
    return path
