"""Gates of the port's long-capture demo, measured on the card.

``docs/torch_long_capture.json`` is written by
``scripts/torch_long_capture_demo.py`` on an NVIDIA GPU: a mode-0
stereo+RDS capture of 60 s and one of 120 s, each in a process of its
own, streamed through ``Receiver.iter_run(chunk_blocks=64)`` on the chunk
programs.  No run happens here.  Memory is O(chunk): the peak device
allocation is the same at both durations, and so is the host's RSS growth
during the run, within the size of one chunk's outputs; every block's
audio was written.
"""

import json
from pathlib import Path

import pytest

DOCS = Path(__file__).resolve().parents[1] / "docs"


@pytest.fixture(scope="module")
def demo():
    return json.loads((DOCS / "torch_long_capture.json").read_text())


def test_measured_on_the_card(demo):
    assert demo["device"].startswith("cuda") and demo["card"]
    assert [r["duration_s"] for r in demo["rows"]] == [60.0, 120.0]
    assert demo["chunk_blocks"] == 64 and demo["rds"] and demo["stereo"]


def test_device_memory_does_not_grow_with_the_capture(demo):
    short, long_ = demo["rows"]
    assert long_["blocks"] == 2 * short["blocks"]
    assert short["max_memory_allocated_bytes"] \
        == long_["max_memory_allocated_bytes"] > 0


def test_host_memory_does_not_grow_with_the_capture(demo):
    short, long_ = demo["rows"]
    # one chunk of audio as 16-bit stereo PCM, with room for the rest
    chunk_mb = demo["chunk_blocks"] * demo["block_bytes"] / 1e6
    assert abs(long_["peak_rss_growth_mb"] - short["peak_rss_growth_mb"]) \
        < chunk_mb


@pytest.mark.parametrize("row", [0, 1])
def test_every_block_was_written(demo, row):
    r = demo["rows"][row]
    # 48 kHz stereo int16: 1,152 audio samples a 115,200-byte block (24 ms)
    assert r["pcm_bytes"] == r["blocks"] * 1152 * 2 * 2
    assert r["x_real_time"] > 1.0
