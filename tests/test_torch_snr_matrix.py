"""Gates of the port's SNR matrix, measured on the card.

``docs/torch_snr_matrix.json`` is written by ``scripts/torch_snr_matrix.py``
on an NVIDIA GPU (the receiver on the chunk programs and the CUDA
kernels), from the same stations, seeds and 8 noise levels as the JAX
package's ``scripts/snr_matrix.py``.  No sweep runs here: an eager CPU PLL
costs ~0.8 s a block.  Two layers:

* the JAX package's own artifact gates (``tests/test_snr_matrix.py``'s
  ``TestArtifact``): schema and levels, clean-signal quality, graceful
  degradation, the robust CDR dominating the reference-faithful one, and
  burst error correction extending the noise floor;
* the port against ``docs/snr_matrix.json`` level by level: separation
  (L, R) and mono tone SNR within SNR_DB_TOL dB; each decoder's RDS frames
  and word accuracy equal at noise <= 0.2, and within FRAMES_TOL frames and
  ACCURACY_TOL at 0.4-0.63, where the decoders work at their floor and the
  soft symbols' last bits (the port's PLL arms agree with the JAX
  package's to 5e-3) can move a frame.
"""

import json
from pathlib import Path

import pytest

DOCS = Path(__file__).resolve().parents[1] / "docs"
LEVELS = [0.0, 0.02, 0.05, 0.1, 0.2, 0.4, 0.5, 0.63]
DECODERS = ("rds_robust", "rds_reference", "rds_robust_ec")
SNR_DB_TOL = 0.3
FRAMES_TOL = 3
ACCURACY_TOL = 0.1


@pytest.fixture(scope="module")
def port():
    return json.loads((DOCS / "torch_snr_matrix.json").read_text())


@pytest.fixture(scope="module")
def jax_rows():
    return {r["noise_std"]: r for r in json.loads(
        (DOCS / "snr_matrix.json").read_text())["rows"]}


def _row(matrix, noise):
    return next(r for r in matrix["rows"] if r["noise_std"] == noise)


def test_measured_on_the_card(port):
    assert port["device"].startswith("cuda") and port["card"]
    assert "," in port["card"] and port["card"].rstrip().endswith("W")
    assert port["torch"] and port["duration_s"] == 1.2


def test_schema_and_levels(port):
    assert [r["noise_std"] for r in port["rows"]] == LEVELS
    for r in port["rows"]:
        for k in ("separation_db_l", "separation_db_r", "mono_tone_snr_db",
                  *DECODERS):
            assert k in r, k


def test_clean_signal_quality(port):
    r0 = port["rows"][0]
    assert r0["separation_db_l"] > 30 and r0["separation_db_r"] > 30
    assert r0["mono_tone_snr_db"] > 24
    assert r0["rds_robust"]["word_accuracy"] == 1.0
    assert r0["rds_robust"]["pi_ok"] and r0["rds_robust"]["ps_ok"]


def test_degradation_is_graceful(port):
    rows = port["rows"]
    assert rows[-1]["mono_tone_snr_db"] < rows[0]["mono_tone_snr_db"]
    r04 = _row(port, 0.4)
    assert r04["separation_db_l"] > 25
    assert r04["rds_robust"]["word_accuracy"] > 0.9


def test_robust_algo_dominates_reference(port):
    for r in port["rows"]:
        assert (r["rds_robust"]["word_accuracy"]
                >= r["rds_reference"]["word_accuracy"]), r["noise_std"]
        if r["rds_robust"]["word_accuracy"] >= 0.5:
            assert (r["rds_robust"]["frames"]
                    >= r["rds_reference"]["frames"]), r["noise_std"]


def test_error_correction_extends_noise_floor(port):
    for r in port["rows"]:
        assert r["rds_robust_ec"]["frames"] >= r["rds_robust"]["frames"]
    r02, r04 = _row(port, 0.2), _row(port, 0.4)
    assert r02["rds_robust"]["word_accuracy"] == 1.0
    assert r04["rds_robust"]["word_accuracy"] < 1.0
    assert r04["rds_robust_ec"]["word_accuracy"] == 1.0
    assert r04["rds_robust_ec"]["corrected"] > 0
    r05 = _row(port, 0.5)
    assert r05["rds_robust_ec"]["frames"] > r05["rds_robust"]["frames"]


@pytest.mark.parametrize("noise", LEVELS)
def test_audio_matches_the_jax_artifact(port, jax_rows, noise):
    got, want = _row(port, noise), jax_rows[noise]
    for k in ("separation_db_l", "separation_db_r", "mono_tone_snr_db"):
        assert abs(got[k] - want[k]) <= SNR_DB_TOL, (k, got[k], want[k])


@pytest.mark.parametrize("noise", LEVELS)
def test_rds_matches_the_jax_artifact(port, jax_rows, noise):
    got, want = _row(port, noise), jax_rows[noise]
    for dec in DECODERS:
        g, w = got[dec], want[dec]
        if noise <= 0.2:
            assert (g["frames"], g["word_accuracy"]) == (
                w["frames"], w["word_accuracy"]), (dec, g, w)
        else:
            assert abs(g["frames"] - w["frames"]) <= FRAMES_TOL, (dec, g, w)
            assert abs(g["word_accuracy"] - w["word_accuracy"]) \
                <= ACCURACY_TOL, (dec, g, w)
