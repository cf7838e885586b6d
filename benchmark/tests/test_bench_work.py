"""The RF front-end's required work against hand counts, and the bound on
the published peaks."""

import json
from pathlib import Path

import pytest

from harness import roofline

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def _cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.mark.parametrize("name,block,n_if", [
    ("mode0_stereo_rds", 115_200, 5_760),
    ("mode2_stereo_rds", 192_000, 9_600)])
@pytest.mark.parametrize("channels", [1, 512])
def test_frontend_work_by_hand(name, block, n_if, channels):
    cfg = _cfg(name)
    assert cfg["block_bytes"] // 2 // cfg["rf_decim"] == n_if
    # per channel: the u8 block read once, I and Q at the IF rate written
    # once (4 bytes each), 150 samples of state per arm read and written
    # (8 bytes), then the 151 taps read once per call
    per = block + 2 * n_if * 4 + 2 * 150 * 8
    nbytes, ops = roofline.frontend_work(cfg, channels, 3)
    assert nbytes == 3 * (channels * per + 151 * 4)
    assert ops == 3 * channels * 2 * n_if * 151 * 2


def test_bound_takes_the_larger_side():
    t, by = roofline.bound_s(3.35e12, 1.0)
    assert (t, by) == (pytest.approx(1.0), "bytes")
    t, by = roofline.bound_s(1.0, 2 * 67e12)
    assert (t, by) == (pytest.approx(2.0), "operations")


def test_mode0_c512_bound_matches_the_kernel_table():
    # PERF.md's kernel table: K1 at C=512 is bound at 0.0266 ms (fp32)
    t, by = roofline.bound_s(*roofline.frontend_work(
        _cfg("mode0_stereo_rds"), 512, 1))
    assert by == "operations"
    assert t * 1e3 == pytest.approx(0.0266, abs=5e-5)
