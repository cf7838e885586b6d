"""The ring of raw u8 I/Q: the same rows from the same seed, distinct rows,
other rows from another seed, and no seam where it wraps."""

import json
from pathlib import Path

import numpy as np
import pytest

from harness import stations

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
MIX = dict(channels=6, stations=2, ring_blocks=3, tone_hz=[300.0, 3000.0],
           noise_std=0.02)


def _cfg(name="mode0_stereo_rds"):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_same_seed_same_rows_and_rows_distinct():
    seed = 2 ** 33 + 17          # wider than 32 bits, as a run's seed may be
    a = stations.make_ring(_cfg(), MIX, seed, "cpu")
    b = stations.make_ring(_cfg(), MIX, seed, "cpu")
    assert a.shape == (6, 3 * 115_200) and a.dtype == np.uint8
    assert np.array_equal(a, b)
    assert len({r.tobytes() for r in a}) == 6
    c = stations.make_ring(_cfg(), MIX, seed + 1, "cpu")
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("name", ["mode0_stereo_rds", "mode2_stereo_rds"])
def test_no_seam_at_the_wrap(name):
    cfg = _cfg(name)
    ring = stations.make_ring(cfg, {**MIX, "channels": 1, "stations": 1,
                                    "ring_blocks": 64, "noise_std": 0.0},
                              5, "cpu")
    x = (ring[0].astype(np.float64) - 128.0) / 128.0
    z = x[0::2] + 1j * x[1::2]
    steps = np.abs(np.angle(z[1:] * np.conj(z[:-1])))
    wrap = abs(np.angle(z[0] * np.conj(z[-1])))
    # the phase step across the wrap is one more step of the signal
    assert wrap <= steps.max()


def test_rds_blocks_satisfy_the_parity_equations():
    rng = np.random.default_rng(3)
    bits = stations.rds_encode_groups(rng, 2).reshape(-1, 26)
    syn = bits @ stations.PARITY_MATRIX % 2
    want = [stations.SYNDROMES[o] for o in stations.OFFSET_SEQUENCE] * 2
    assert np.array_equal(syn, np.stack(want))
