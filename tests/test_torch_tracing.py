"""The port's own spans (``utils.profiling.span``) on the CPU.

With no profile recording, every span is one shared no-op and nothing is
recorded.  Under ``torch.profiler`` a block through ``Receiver.process``
and a recording through ``Receiver.iter_run`` mark their stages as
sibling ``sdr.*`` host events, in order (the pinned-staging pair exists
only for a host input on the card), a new key adds one
``sdr.program.capture``, and each ``sdr.program.replay`` is one replay
of ``program.counts``.  K is set to 2 so that 19,200-byte blocks (mode 0,
960 IF samples) make whole chunks.  The receiver is mono: the spans do not
depend on the arms, and a CPU profile records each op of the PLLs' plain
per-sample loops.  One thread, as tier-1 runs several workers.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sdr_tpu_torch.models import program as pprog
from sdr_tpu_torch.models import receiver as prx
from sdr_tpu_torch.utils import profiling, synth

torch.set_num_threads(1)

BS = 19_200
K = 2
CALL = ["sdr.program.inputs", "sdr.program.load", "sdr.program.replay",
        "sdr.program.copy_out"]
CHUNK = CALL + ["sdr.receiver.cat", "sdr.receiver.wait",
                "sdr.receiver.fetch"]


@pytest.fixture(scope="module")
def station():
    return synth.synthesize_fm(duration_s=0.04, mode=0, with_stereo=True,
                               with_rds=True, seed=31).iq_u8[:4 * BS]


@pytest.fixture
def receiver(monkeypatch):
    monkeypatch.setattr(prx, "SCAN_BLOCKS", K)
    return prx.Receiver(0, stereo=False, with_rds=False, device="cpu")


def _drive(rx, station) -> None:
    """One block through ``process``, then two chunks of K blocks through
    ``iter_run``."""
    rx.process(station[:BS])
    for _ in rx.iter_run(station, block_size=BS, chunk_blocks=K):
        pass


def _port_spans(prof) -> list:
    """The profile's ``sdr.*`` host events in start order."""
    return sorted((e for e in prof.events() if e.name.startswith("sdr.")),
                  key=lambda e: e.time_range.start)


def _port_ancestor(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith("sdr."):
        p = p.cpu_parent
    return p


def test_span_is_the_shared_no_op_without_a_profile():
    assert profiling.span("sdr.a") is profiling.span("sdr.b")
    assert profiling.span("sdr.a") is profiling._OFF
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("sdr.a") is not profiling._OFF


def test_a_run_without_a_profile_records_nothing(receiver, station,
                                                 monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name))
    _drive(receiver, station)
    assert made == []


def test_spans_are_siblings_in_stage_order(receiver, station):
    _drive(receiver, station)                 # every key captured
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _drive(receiver, station)
    spans = _port_spans(prof)
    assert [e.name for e in spans] == CALL + CHUNK + CHUNK
    assert all(_port_ancestor(e) is None for e in spans)
    ends = [e.time_range.end for e in spans]
    assert all(e <= s.time_range.start for e, s in zip(ends, spans[1:]))


@pytest.mark.parametrize("chunk_blocks", [2, 3])
def test_each_chunk_waits_and_fetches_once(receiver, station, chunk_blocks):
    """One ``sdr.receiver.wait`` and then one ``sdr.receiver.fetch`` a
    chunk, after the chunk's replays (a chunk graph, and with 3 a
    per-block tail): the spans ``device_wait_ms_per_block`` and
    ``fetch_ms_per_block`` read."""
    list(receiver.iter_run(station, block_size=BS, chunk_blocks=chunk_blocks))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        list(receiver.iter_run(station, block_size=BS,
                               chunk_blocks=chunk_blocks))
    names = [e.name for e in _port_spans(prof)
             if e.name in ("sdr.program.replay", "sdr.receiver.wait",
                           "sdr.receiver.fetch")]
    each = ["sdr.receiver.wait", "sdr.receiver.fetch"]
    replays = [len(prx.block_spans(min(chunk_blocks, 4 - b)))
               for b in range(0, 4, chunk_blocks)]
    assert names == [n for r in replays
                     for n in ["sdr.program.replay"] * r + each]


def test_a_new_key_adds_one_capture_around_its_load(receiver, station):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        receiver.process(station[:BS])
    spans = _port_spans(prof)
    assert [e.name for e in spans] == [
        "sdr.program.inputs", "sdr.program.capture", "sdr.program.load",
        "sdr.program.replay", "sdr.program.copy_out"]
    load = spans[2]
    assert _port_ancestor(load).name == "sdr.program.capture"
    assert [_port_ancestor(e) for e in spans if e is not load] == [None] * 4


def test_each_replay_span_is_one_counted_replay(receiver, station):
    before = pprog.counts["replays"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _drive(receiver, station)
        key, = [k for k in receiver.program.keys() if len(k) > 6]
        receiver.program.replay(key)          # the K-block chunk graph
    replays = [e for e in _port_spans(prof)
               if e.name == "sdr.program.replay"]
    assert len(replays) == pprog.counts["replays"] - before == 4
    captures = [e for e in _port_spans(prof)
                if e.name == "sdr.program.capture"]
    assert len(captures) == len(receiver.program.keys()) == 2
