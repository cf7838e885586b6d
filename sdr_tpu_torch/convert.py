"""Carry coefficients and streaming state between the JAX package and the
port.

The state's flat form is the JAX package's checkpoint layout
(``sdr_tpu/checkpoint.py``): one numpy array per leaf, keyed by the field
path joined with ``/`` (``rf_i``, ``pilot_pll/integrator``, ...).  A state
written by either package resumes in the other.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from sdr_tpu_torch.models.receiver import (ReceiverCoeffs, ReceiverState,
                                           validate_u8_rf_state)
from sdr_tpu_torch.ops.pll import PllState


def coeffs_from_numpy(coeffs: Any,
                      device: torch.device | str | None = None
                      ) -> ReceiverCoeffs:
    """The port's coefficients from a ``ReceiverCoeffs``-like mapping (or
    NamedTuple) of arrays, e.g. the JAX package's ``design_coeffs``."""
    m = coeffs._asdict() if hasattr(coeffs, "_asdict") else dict(coeffs)
    return ReceiverCoeffs(**{
        f: torch.tensor(np.asarray(m[f]), dtype=torch.float32, device=device)
        for f in ReceiverCoeffs._fields})


def state_to_numpy(state: ReceiverState) -> dict[str, np.ndarray]:
    """Flatten a state into ``{"field" or "field/leaf": array}``."""
    flat = {}
    for name, leaf in zip(state._fields, state):
        if isinstance(leaf, PllState):
            for sub, v in zip(leaf._fields, leaf):
                flat[f"{name}/{sub}"] = v.detach().cpu().numpy()
        else:
            flat[name] = leaf.detach().cpu().numpy()
    return flat


def state_from_numpy(flat: Mapping[str, np.ndarray],
                     device: torch.device | str | None = None,
                     expect_input_dtype: str | None = None) -> ReceiverState:
    """Rebuild a state from its flat form.

    ``expect_input_dtype="uint8"`` checks, as the JAX package's checkpoint
    load does, that the RF tail is 1/128-quantized, i.e. that the state can
    resume a raw-u8 stream."""
    t = lambda key: torch.tensor(np.asarray(flat[key]), device=device)
    fields = {}
    for name in ReceiverState._fields:
        if name in ("pilot_pll", "rds_pll"):
            fields[name] = PllState(*[t(f"{name}/{sub}")
                                      for sub in PllState._fields])
        else:
            fields[name] = t(name)
    if expect_input_dtype is not None and \
            np.dtype(expect_input_dtype) == np.uint8:
        validate_u8_rf_state(flat["rf_i"], flat["rf_q"])
    return ReceiverState(**fields)
