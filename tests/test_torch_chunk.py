"""The chunk programs of the port's entry points on the CPU.

``Receiver.run``, ``Receiver.iter_run``, ``receive()``, ``run_blocks`` and
``channel_sharded_run`` replay a graph of ``receiver.SCAN_BLOCKS`` chained
blocks per whole chunk (``Program.scan``) and the per-block graph for the
rest; on the CPU the same bookkeeping runs with direct calls.  Held here:
K chunks plus a tail equal to the per-block program (``SCAN_BLOCKS = 0``)
bit for bit, ``process``/``run``/``process`` interleaved on one receiver,
a checkpoint restart in the middle of a recording, and ``Receiver.run``
against the JAX package's ``run_blocks_scan`` at the receiver tolerances
(FM_ATOL on fm_demod/mono, PLL_ARM_ATOL on the PLL-driven arms:
tests/test_models_receiver.py).  K is set to 3 so that a few 19,200-byte
blocks (mode 0, 960 IF samples) make whole chunks and a tail.  One thread,
as tier-1 runs several workers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (FM_ATOL, MC, PLL_ARM_ATOL, PMC, SHORT,
                          assert_close, np_of)

import sdr_tpu_torch
from sdr_tpu.models import receiver as jrx
from sdr_tpu_torch import checkpoint as pckpt
from sdr_tpu_torch.models import program as pprog
from sdr_tpu_torch.models import receiver as prx
from sdr_tpu_torch.parallel import channel as pch
from sdr_tpu_torch.parallel.mesh import Mesh
from sdr_tpu_torch.utils import synth

torch.set_num_threads(1)

K = 3
ARMS = ("fm_demod", "mono", "left", "right", "rds_symbols")


@pytest.fixture(scope="module")
def station():
    return synth.synthesize_fm(duration_s=0.12, mode=0, with_stereo=True,
                               with_rds=True, seed=23).iq_u8


@pytest.fixture
def k3(monkeypatch):
    monkeypatch.setattr(prx, "SCAN_BLOCKS", K)


def _equal(a, b) -> None:
    for x, y in zip(pprog.tree_leaves(a), pprog.tree_leaves(b)):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        assert x.shape == y.shape and torch.equal(x, y)


def _per_block(monkeypatch, fn):
    """``fn()`` with every block through the per-block program."""
    monkeypatch.setattr(prx, "SCAN_BLOCKS", 0)
    try:
        return fn()
    finally:
        monkeypatch.setattr(prx, "SCAN_BLOCKS", K)


def test_block_spans(k3):
    assert prx.block_spans(8) == [slice(0, 3), slice(3, 6), slice(6, 7),
                                  slice(7, 8)]
    assert prx.block_spans(2) == [slice(0, 1), slice(1, 2)]
    assert prx.block_spans(6) == [slice(0, 3), slice(3, 6)]


@pytest.mark.parametrize("lead", [(), (2,)])
def test_run_chunks_and_tail_equal_per_block(station, k3, monkeypatch, lead):
    """8 blocks (two chunks of 3 and a tail of 2) through ``Receiver.run``
    against the per-block program: outputs and state bit-equal; two chunk
    replays and two block replays."""
    iq = station[:8 * SHORT]
    if lead:
        iq = np.stack([iq, station[SHORT:9 * SHORT]])
    r = prx.Receiver(0, True, True, batch_shape=lead, device="cpu")
    pprog.reset_counts()
    got = r.run(iq, block_size=SHORT)
    assert pprog.counts["replays"] == 4 and pprog.counts["blocks"] == 8
    assert len(r.program.keys()) == 2
    ref = prx.Receiver(0, True, True, batch_shape=lead, device="cpu")
    want = _per_block(monkeypatch, lambda: ref.run(iq, block_size=SHORT))
    _equal(got, want)
    _equal(r.state, ref.state)


def test_process_run_process_interleave(station, k3, monkeypatch):
    """``process`` one block, ``run`` seven (chunks and tail), ``process``
    one more on one receiver: equal to the nine blocks one by one, and the
    state stays the program's one set of buffers."""
    blocks = [station[b * SHORT:(b + 1) * SHORT] for b in range(9)]
    r = prx.Receiver(0, True, True, device="cpu")
    first = r.process(blocks[0])
    own = pprog.tree_leaves(r.state)
    mid = r.run(np.concatenate(blocks[1:8]), block_size=SHORT)
    last = r.process(blocks[8])
    assert all(a is b for a, b in zip(own, pprog.tree_leaves(r.state)))
    ref = prx.Receiver(0, True, True, device="cpu")
    want = [ref.process(b) for b in blocks]
    _equal(first, want[0])
    _equal(mid, prx.map_state(lambda *a: torch.stack(a), *want[1:8]))
    _equal(last, want[8])
    _equal(r.state, ref.state)


def test_checkpoint_restart_mid_recording(station, k3, tmp_path):
    """A checkpoint saved after ``run`` of 5 blocks (a chunk and a tail),
    loaded into a new receiver whose ``run`` goes on with 7 more (two
    chunks and a tail): bit-equal to one uninterrupted ``run`` of 12."""
    iq = station[:12 * SHORT]
    whole = prx.Receiver(0, True, True, device="cpu")
    want = whole.run(iq, block_size=SHORT)
    a = prx.Receiver(0, True, True, device="cpu")
    head = a.run(iq[:5 * SHORT], block_size=SHORT)
    path = pckpt.save(str(tmp_path / "ck"), a.state, 0, block_count=5,
                      input_dtype="uint8")
    b = prx.Receiver(0, True, True, device="cpu")
    b.state, meta = pckpt.load(path, expect_input_dtype="uint8",
                               device="cpu")
    tail = b.run(iq[5 * SHORT:], block_size=SHORT)
    _equal(prx.map_state(lambda x, y: torch.cat([x, y]), head, tail), want)
    _equal(b.state, whole.state)


def test_foreign_state_into_a_chunk_run(station, k3, monkeypatch):
    """A state assigned to the receiver (here another receiver's, after 2
    blocks) is copied into the program's buffers by the chunk graph and
    left as it was."""
    src = prx.Receiver(0, True, True, device="cpu")
    src.run(station[:2 * SHORT], block_size=SHORT)
    kept = pprog.tree_map(torch.clone, src.state)
    r = prx.Receiver(0, True, True, device="cpu")
    r.state = src.state
    got = r.run(station[2 * SHORT:5 * SHORT], block_size=SHORT)
    _equal(src.state, kept)
    ref = prx.Receiver(0, True, True, device="cpu")
    ref.state = pprog.tree_map(torch.clone, kept)
    want = _per_block(monkeypatch, lambda: ref.run(
        station[2 * SHORT:5 * SHORT], block_size=SHORT))
    _equal(got, want)


@pytest.mark.parametrize("chunk_blocks", [4, 7])
def test_iter_run_on_chunks_equals_run(station, k3, monkeypatch,
                                       chunk_blocks):
    """``iter_run`` (host chunks straight into the chunk graph's static
    input) concatenates to the per-block ``run``, bit for bit."""
    iq = station[:10 * SHORT]
    r = prx.Receiver(0, True, True, device="cpu")
    chunks = list(r.iter_run(iq, block_size=SHORT,
                             chunk_blocks=chunk_blocks))
    ref = prx.Receiver(0, True, True, device="cpu")
    want = _per_block(monkeypatch, lambda: ref.run(iq, block_size=SHORT))
    for arm in ARMS:
        got = np.concatenate([getattr(c, arm) for c in chunks])
        np.testing.assert_array_equal(got, np_of(getattr(want, arm)),
                                      err_msg=arm)
    _equal(r.state, ref.state)


@pytest.mark.parametrize("chunk_blocks", [3, 5])
def test_iter_run_on_the_cpu_copies_nothing_to_pinned_memory(
        station, k3, chunk_blocks):
    """On the CPU the outputs are host memory already: ``iter_run`` counts
    no pinned fetch and no fetched byte (``receiver.fetch_counts``), and its
    chunks (whole chunk graphs, and per-block tails with 5) are ``run``'s,
    bit for bit, each writable and no other chunk's memory."""
    iq = station[:10 * SHORT]
    prx.reset_fetch_counts()
    r = prx.Receiver(0, True, True, device="cpu")
    chunks = list(r.iter_run(iq, block_size=SHORT,
                             chunk_blocks=chunk_blocks))
    assert prx.fetch_counts == {"pinned_fetches": 0, "fetched_bytes": 0}
    want = prx.Receiver(0, True, True, device="cpu").run(iq,
                                                        block_size=SHORT)
    for arm in ARMS:
        np.testing.assert_array_equal(
            np.concatenate([getattr(c, arm) for c in chunks]),
            np_of(getattr(want, arm)), err_msg=arm)
    arrays = [(i, a) for i, c in enumerate(chunks) for a in c if a.size]
    assert all(a.flags.writeable for _, a in arrays)
    assert not any(np.may_share_memory(a, b) for i, a in arrays
                   for j, b in arrays if i != j)


def test_receive_on_chunks_equals_per_block(station, k3, monkeypatch):
    """``receive()`` of 0.25 s with K=3 (10 whole 115,200-byte blocks:
    three chunk graphs and a block, then the short tail block) against
    the per-block program: audio and decoded RDS info words equal."""
    iq = synth.synthesize_fm(duration_s=0.25, mode=0, with_rds=True,
                             seed=8).iq_u8
    got = sdr_tpu_torch.receive(iq, 0, stereo=True, rds=True, device="cpu")
    want = _per_block(monkeypatch, lambda: sdr_tpu_torch.receive(
        iq, 0, stereo=True, rds=True, device="cpu"))
    for f in ("mono", "left", "right", "rds_info_words"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_channel_sharded_on_chunks_equals_per_block(station, k3,
                                                    monkeypatch):
    """4 channels over 2 shards, 7 blocks each: equal to the per-block
    program."""
    chans = np.stack([station[o:o + 7 * SHORT] for o in (0, 2, 40, 400)])
    mesh = Mesh(["cpu"] * 2, ("ch",))
    run = lambda: pch.gather_channels(pch.channel_sharded_run(
        chans, mesh, 0, stereo=True, with_rds=True, block_size=SHORT))
    got = run()
    want = _per_block(monkeypatch, run)
    _equal(got[0], want[0])
    _equal(got[1], want[1])


def test_receiver_run_on_chunks_matches_jax_scan(station, k3):
    """``Receiver.run`` on chunk programs (7 blocks x 2 channels: two
    chunks and a tail) against ``run_blocks_scan`` at the receiver
    tolerances."""
    iq2 = np.stack([station[:7 * SHORT], station[SHORT:8 * SHORT]])
    r = prx.Receiver(0, True, True, batch_shape=(2,), device="cpu")
    ro = r.run(iq2, block_size=SHORT)
    blocks = np.ascontiguousarray(np.moveaxis(iq2.reshape(2, 7, SHORT), 1,
                                              0))
    jo, js = jrx.run_blocks_scan(jnp.asarray(blocks), jrx.design_coeffs(MC),
                                 jrx.init_state(MC, (2,)), 0, True, True)
    for arm in ARMS:
        tol = FM_ATOL if arm in ("fm_demod", "mono") else PLL_ARM_ATOL
        assert_close(getattr(ro, arm), getattr(jo, arm), tol, arm)
    np.testing.assert_array_equal(np_of(r.state.rf_i), np.asarray(js.rf_i))
