"""Gates of the port's time-shard overlap curve, measured on the card.

``docs/torch_overlap_convergence.json`` is written by
``scripts/torch_overlap_convergence.py`` on an NVIDIA GPU: the JAX
package's 2.4 s stations (seed 21, noise 0, 0.02, 0.1) time-sharded over
S=8 shards of one card (the chunk programs, K6) at overlaps of 1-12
blocks of 5,000 IF samples, against a contiguous run on the same card.  No
sweep runs here.  At the default overlap (6,000 IF samples, rounded up to
2 blocks) every noise level holds the gates ``chip_smoke.py``'s
``_sharded_gates`` applies to a time-sharded run (those of
tests/test_parallel.py): fm_demod and mono within LINEAR_ATOL, shard 0's
left within SHARD0_ATOL, the left channel's RMS error after RELOCK_SKIP
samples below RELOCK_RMS of the reference RMS; and at every overlap every
shard's kept-region relative RMS stays below RELOCK_RMS, as the JAX
package's curve (``docs/overlap_convergence.json``) does.
"""

import json
from pathlib import Path

import pytest

DOCS = Path(__file__).resolve().parents[1] / "docs"
LINEAR_ATOL = 1e-5
SHARD0_ATOL = 1e-2
RELOCK_RMS = 1e-4
RELOCK_SKIP = 8000
NOISES = [0.0, 0.02, 0.1]


@pytest.fixture(scope="module")
def port():
    return json.loads((DOCS / "torch_overlap_convergence.json").read_text())


def test_measured_on_the_card_as_the_jax_study(port):
    want = json.loads((DOCS / "overlap_convergence.json").read_text())
    assert port["device"].startswith("cuda") and port["card"]
    for k in ("mode", "shards", "block_if", "metric"):
        assert port[k] == want[k], k
    assert port["relock_skip"] == RELOCK_SKIP
    key = lambda r: (r["noise_std"], r["overlap_blocks"])
    assert sorted(map(key, port["rows"])) == sorted(map(key, want["rows"]))


@pytest.mark.parametrize("noise", NOISES)
def test_default_overlap_within_the_time_shard_gates(port, noise):
    (r,) = [r for r in port["rows"] if r["noise_std"] == noise
            and r["overlap_blocks"] == port["default_overlap_blocks"]]
    assert port["default_overlap_blocks"] == 2
    assert r["fm_demod_max_abs_err"] <= LINEAR_ATOL, r
    assert r["mono_max_abs_err"] <= LINEAR_ATOL, r
    assert r["shard0_left_max_abs_err"] <= SHARD0_ATOL, r
    assert r["relock_rel_rms"] < RELOCK_RMS, r


@pytest.mark.parametrize("noise", NOISES)
def test_every_overlap_relocks(port, noise):
    rows = [r for r in port["rows"] if r["noise_std"] == noise]
    assert len(rows) == 7
    for r in rows:
        assert r["worst_other_shard_rel_rms"] < RELOCK_RMS, r
        assert r["shard0_rel_rms"] < RELOCK_RMS, r
