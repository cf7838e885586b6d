"""Gates of the port's clock-drift matrix, measured on the card.

``docs/torch_rds_drift.json`` is written by
``scripts/torch_rds_drift_matrix.py`` on an NVIDIA GPU (the receiver on
the chunk programs and the CUDA kernels): the JAX package's 9 s stations
(seed 7, noise 0.1) at +-50, +-100, +-200 and 0 ppm.  No sweep runs here.
Gated as ``docs/rds_drift.json`` shows the JAX package: the tracking CDR
and the streaming tracking decoder reach at least frames_sent - 2 frames,
the tracking CDR at word accuracy 1.0, at every ppm; the fixed-phase CDR
loses the Manchester pairing once the clock slips a symbol (it decodes
fewer frames than the tracking CDR at every nonzero ppm) and keeps up
without drift.
"""

import json
from pathlib import Path

import pytest

DOCS = Path(__file__).resolve().parents[1] / "docs"
PPMS = [50.0, -50.0, 100.0, -100.0, 200.0, -200.0, 0.0]


@pytest.fixture(scope="module")
def port():
    return json.loads((DOCS / "torch_rds_drift.json").read_text())


def _row(matrix, ppm):
    return next(r for r in matrix["rows"] if r["clock_ppm"] == ppm)


def test_measured_on_the_card_as_the_jax_study(port):
    want = json.loads((DOCS / "rds_drift.json").read_text())
    assert port["device"].startswith("cuda") and port["card"]
    for k in ("duration_s", "noise_std", "window_symbols", "mode"):
        assert port[k] == want[k], k
    assert [r["clock_ppm"] for r in port["rows"]] == PPMS
    for r in want["rows"]:
        assert _row(port, r["clock_ppm"])["frames_sent"] == r["frames_sent"]


@pytest.mark.parametrize("ppm", PPMS)
def test_tracking_cdr_follows_the_drift(port, ppm):
    r = _row(port, ppm)
    assert r["tracking"]["frames"] >= r["frames_sent"] - 2, r
    assert r["tracking"]["word_accuracy"] == 1.0, r
    assert r["streaming_tracking_frames"] >= r["frames_sent"] - 2, r


@pytest.mark.parametrize("ppm", [p for p in PPMS if p])
def test_fixed_phase_cdr_loses_the_pairing(port, ppm):
    r = _row(port, ppm)
    assert r["fixed_phase"]["frames"] < r["tracking"]["frames"], r


def test_fixed_phase_cdr_without_drift(port):
    r = _row(port, 0.0)
    assert r["fixed_phase"]["frames"] >= r["frames_sent"] - 2
    assert r["fixed_phase"]["word_accuracy"] == 1.0
