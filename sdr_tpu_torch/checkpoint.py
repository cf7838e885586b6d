"""Checkpoint/resume of the receiver state as one ``.npz``.

Port of ``save``/``load`` of ``sdr_tpu/checkpoint.py``, in the same file
format, so a checkpoint written by either package resumes in the other:

* one array per state leaf, keyed by its field path joined with ``/``
  (``rf_i``, ``pilot_pll/integrator``, ...; ``convert.state_to_numpy``);
* ``__meta__``: JSON with ``mode``, ``block_count``, ``extra`` and, when
  recorded, ``input_dtype``;
* ``host/<name>``: host-side arrays, e.g. the streaming RDS decoder's carry.

The input-dtype guard is the JAX package's: a checkpoint recorded with
another input dtype than the resumed run feeds is refused, in both
directions (also a u8-produced state on float resume, which would in fact
be safe; kept as the reference does it).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any

import numpy as np
import torch

from sdr_tpu_torch import config as cfg
from sdr_tpu_torch import convert
from sdr_tpu_torch.models import receiver as rx


def save(path: str, state: rx.ReceiverState, mode: int | cfg.Mode,
         block_count: int = 0, extra: dict[str, Any] | None = None,
         host_arrays: dict[str, np.ndarray] | None = None,
         input_dtype: str | None = None) -> str:
    """Write state + metadata to ``<path>`` (.npz appended if missing);
    returns the path actually written.

    ``extra`` is JSON-able metadata; ``host_arrays`` carries host-side
    decoder state (``StreamingRdsDecoder.state_dict``), so a resume
    reproduces the uninterrupted output stream exactly.  ``input_dtype``
    ("uint8" / "float32") records what the receiver was fed."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    meta = {"mode": int(mode), "block_count": int(block_count),
            "extra": extra or {}}
    if input_dtype is not None:
        meta["input_dtype"] = str(np.dtype(input_dtype))
    host = {f"host/{k}": np.asarray(v)
            for k, v in (host_arrays or {}).items()}
    np.savez(path, __meta__=json.dumps(meta), **convert.state_to_numpy(state),
             **host)
    return path


def load(path: str, expect_input_dtype: str | None = None,
         device: torch.device | str = "cuda"
         ) -> tuple[rx.ReceiverState, dict[str, Any]]:
    """Read a checkpoint onto ``device``; returns (state, meta).  Host-side
    arrays come back under ``meta["host_arrays"]``.  ``device`` defaults to
    the card, as the receiver does, and raises without one
    (``receiver.resolve_device``) unless ``device="cpu"`` is passed.

    ``expect_input_dtype``: the dtype the resumed run will feed.  A
    checkpoint recorded with another ``input_dtype`` raises ValueError; one
    with no record gets a warning on stderr and, when the resumed run
    feeds u8, a direct check that the RF tail is 1/128-quantized."""
    device = rx.resolve_device(device)
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        mc = cfg.get_mode_config(meta["mode"])
        keys = convert.state_to_numpy(rx.init_state(mc))
        flat = {k: z[k] for k in keys}
        meta["host_arrays"] = {k[len("host/"):]: z[k] for k in z.files
                               if k.startswith("host/")}
    if expect_input_dtype is not None:
        expect = str(np.dtype(expect_input_dtype))
        stored = meta.get("input_dtype")
        if stored is not None and stored != expect:
            raise ValueError(
                f"checkpoint {path} was produced from {stored} input but "
                f"the resumed run feeds {expect}: the u8 path requires a "
                "1/128-quantized RF tail, so this resume could silently "
                "corrupt the stream.  Feed the same input dtype, or "
                "re-create the checkpoint.")
        if stored is None and expect == "uint8":
            print(f"warning: checkpoint {path} predates input-dtype "
                  "recording; validating the RF tail directly",
                  file=sys.stderr)
            rx.validate_u8_rf_state(flat["rf_i"], flat["rf_q"])
    return convert.state_from_numpy(flat, device=device), meta
