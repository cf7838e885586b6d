"""The port's ``.npz`` checkpoint against the JAX package's: the same file
format both ways, and the same input-dtype guard.

A state with random u8-normalized RF tails and random other leaves goes
through ``save`` of one package and ``load`` of the other; every leaf must
come back equal, with the metadata and host arrays.
"""

import json

import jax
import numpy as np
import pytest
import torch

from torch_parity import mode_configs

from sdr_tpu import checkpoint as jckpt
from sdr_tpu.models import receiver as jrx
from sdr_tpu_torch import checkpoint as pckpt
from sdr_tpu_torch import convert
from sdr_tpu_torch.models import receiver as prx

MC, PMC = mode_configs(0)


def _flat_state(seed: int, batch=(2,)) -> dict[str, np.ndarray]:
    """A state's flat form with random leaves; the RF tails are
    u8-normalized, so the state may resume a raw-u8 stream."""
    rng = np.random.default_rng(seed)
    flat = convert.state_to_numpy(prx.init_state(PMC, batch))
    out = {k: rng.standard_normal(v.shape).astype(v.dtype)
           for k, v in flat.items()}
    for k in ("rf_i", "rf_q"):
        out[k] = (rng.integers(-128, 128, flat[k].shape) / 128).astype(
            np.float32)
    return out


def _jax_state(flat):
    template = jrx.init_state(MC)
    keys = jckpt._flatten_with_paths(template)
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template),
        [jax.numpy.asarray(flat[k]) for k in keys])


def _assert_flat_equal(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], k)


def test_port_checkpoint_loads_in_jax(tmp_path):
    flat = _flat_state(1)
    path = pckpt.save(str(tmp_path / "p"), convert.state_from_numpy(flat),
                      0, block_count=7, extra={"rds": {"algo": "robust"}},
                      host_arrays={"rds/backlog": np.arange(5)},
                      input_dtype="uint8")
    assert path.endswith(".npz")
    state, meta = jckpt.load(path, expect_input_dtype="uint8")
    _assert_flat_equal(jckpt._flatten_with_paths(state), flat)
    assert meta["block_count"] == 7 and meta["extra"]["rds"]["algo"] == \
        "robust"
    np.testing.assert_array_equal(meta["host_arrays"]["rds/backlog"],
                                  np.arange(5))


def test_jax_checkpoint_loads_in_port(tmp_path):
    flat = _flat_state(2)
    path = jckpt.save(str(tmp_path / "j.npz"), _jax_state(flat), 0,
                      block_count=3, host_arrays={"chan/phi0": np.ones(2)},
                      input_dtype="float32")
    state, meta = pckpt.load(path, expect_input_dtype="float32",
                             device="cpu")
    assert isinstance(state.rf_i, torch.Tensor)
    _assert_flat_equal(convert.state_to_numpy(state), flat)
    assert meta["block_count"] == 3 and meta["input_dtype"] == "float32"
    np.testing.assert_array_equal(meta["host_arrays"]["chan/phi0"],
                                  np.ones(2))


@pytest.mark.parametrize("stored,expect", [("uint8", "float32"),
                                           ("float32", "uint8")])
def test_input_dtype_mismatch_is_refused_as_in_jax(tmp_path, stored, expect):
    """Both directions are refused, as the JAX package refuses them (a
    u8-produced state on float resume too)."""
    path = pckpt.save(str(tmp_path / "c"), convert.state_from_numpy(
        _flat_state(3)), 0, input_dtype=stored)
    with pytest.raises(ValueError):
        pckpt.load(path, expect_input_dtype=expect)
    with pytest.raises(ValueError):
        jckpt.load(path, expect_input_dtype=expect)


def test_unrecorded_checkpoint_checks_the_u8_tail(tmp_path, capsys):
    """A checkpoint without an input-dtype record: a float RF tail is
    refused for u8 resume, after a warning; a u8-normalized one loads."""
    flat = _flat_state(4)
    ok = pckpt.save(str(tmp_path / "ok"), convert.state_from_numpy(flat), 0)
    pckpt.load(ok, expect_input_dtype="uint8")
    assert "predates input-dtype" in capsys.readouterr().err
    flat["rf_q"] = flat["rf_q"] + np.float32(0.3 / 128)
    bad = pckpt.save(str(tmp_path / "bad"), convert.state_from_numpy(flat),
                     0)
    with pytest.raises(ValueError):
        pckpt.load(bad, expect_input_dtype="uint8")
    with np.load(bad) as z:
        assert "input_dtype" not in json.loads(str(z["__meta__"]))
