"""The window arithmetic on synthetic samples: a stall in the window has
to move the rate and the tail."""

import pytest

from harness import window


def test_rate_counts_every_sample_over_the_whole_window():
    # 20 chunks of 64 blocks x 512 channels x 57,600 pairs in 10 s
    samples = 20 * 64 * 512 * 57_600
    assert window.rate_msps(samples, 100.0, 110.0) == pytest.approx(
        samples / 10.0 / 1e6)


def test_a_stall_moves_the_rate():
    chunk = 64 * 512 * 57_600
    steady = window.rate_msps(20 * chunk, 0.0, 20 * 0.9)
    stalled = window.rate_msps(20 * chunk, 0.0, 19 * 0.9 + 2.7)
    assert stalled < steady * 0.92


def test_percentiles_and_a_stall_in_the_tail():
    lat = [0.001] * 800 + [0.0012] * 33
    assert window.percentile_ms(lat, 50) == pytest.approx(1.0)
    # a 1.2 s stall makes the 50 blocks due during it late, 6% of them
    stalled = lat[:400] + [1.2 - 0.024 * k for k in range(50)] + lat[450:]
    assert window.percentile_ms(stalled, 95) > 2 * window.percentile_ms(
        lat, 95)
    assert window.percentile_ms(stalled, 50) == pytest.approx(1.0)


def test_late_counts_blocks_past_their_duration():
    assert window.late([0.001, 0.0239, 0.0241, 0.5], 0.024) == 2
    assert window.late([], 0.024) == 0
