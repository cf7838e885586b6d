"""The time-sharded runners on chunk programs, on the CPU.

The counterparts of the JAX package's two ``lax.scan``s of ``run_shard``
(the warm-up over the halo blocks and the body) and of ``_scan_blocks`` in
the chunked form: ``_Runner.warm_up`` replays one graph of the ``n_skip``
halo blocks a device and ``_Runner.run`` a graph of
``receiver.SCAN_BLOCKS`` blocks per whole chunk (on the CPU, direct calls
with the same bookkeeping).  K is set to 3 so that 7 blocks a shard make
two chunks and a tail.  Held: bit-equal to the per-block program
(``SCAN_BLOCKS = 0``), the chunked form bit-equal to the single-shot one,
against ``sdr_tpu.parallel.time_shard`` on the 8 virtual JAX CPU devices
at the receiver tolerances (FM_ATOL on fm_demod/mono, PLL_ARM_ATOL on the
PLL-driven arms), and against the port's contiguous run at the JAX
package's gates (tests/test_parallel.py: 1e-5 on the linear arms, 1e-2 on
shard 0's left channel, relock RMS below 1e-4 of the reference RMS).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from torch_parity import FM_ATOL, MC, PLL_ARM_ATOL, assert_close, np_of

from sdr_tpu.parallel import time_shard as jts
from sdr_tpu.utils import synth
from sdr_tpu_torch.models import program as pprog
from sdr_tpu_torch.models import receiver as prx
from sdr_tpu_torch.parallel import time_shard as pts
from sdr_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

S = 4
K = 3
BLOCK_IF = 960
BLOCK_RAW = BLOCK_IF * 2 * MC.rf_decim
SMALL = dict(overlap_if=2 * BLOCK_IF, block_if=BLOCK_IF)
ARMS = ("fm_demod", "mono", "left", "right", "rds_symbols")


@pytest.fixture(scope="module")
def recording():
    res = synth.synthesize_fm(duration_s=0.12, mode=0, with_stereo=True,
                              with_rds=True, seed=21)
    iq = synth.u8_to_float(res.iq_u8)
    seg = (iq.shape[-1] // S) // BLOCK_RAW * BLOCK_RAW
    return np.ascontiguousarray(iq[: seg * S])


@pytest.fixture(scope="module")
def runs(recording):
    """The port's S=4 stereo+RDS run with K=3 (7 blocks a shard: two
    chunks and a tail), the same with every block through the per-block
    program, and the launch bookkeeping of the first."""
    mesh = Mesh(["cpu"] * S, ("time",))
    run = lambda: pts.time_sharded_receive(recording, mesh, 0, True, True,
                                           **SMALL)
    saved = prx.SCAN_BLOCKS
    try:
        prx.SCAN_BLOCKS = K
        pprog.reset_counts()
        chunked = run()
        counts = dict(pprog.counts)
        prx.SCAN_BLOCKS = 0
        per_block = run()
    finally:
        prx.SCAN_BLOCKS = saved
    return chunked, per_block, counts


def test_chunk_graphs_equal_per_block(recording, runs):
    chunked, per_block, counts = runs
    assert recording.shape[-1] // S // BLOCK_RAW == 7
    # the warm-up (one graph of 2 halo blocks), two chunks of 3, one tail
    assert counts["replays"] == 4 and counts["blocks"] == 2 + 7
    for arm in ARMS:
        np.testing.assert_array_equal(np_of(getattr(chunked, arm)),
                                      np_of(getattr(per_block, arm)),
                                      err_msg=arm)


def test_chunk_graphs_match_jax(recording, runs):
    mesh = JMesh(np.array(jax.devices()[:S]), ("time",))
    want = jts.time_sharded_receive(recording, mesh, 0, True, True, **SMALL)
    for arm in ARMS:
        tol = FM_ATOL if arm in ("fm_demod", "mono") else PLL_ARM_ATOL
        assert_close(getattr(runs[0], arm), getattr(want, arm), tol, arm)


def test_chunk_graphs_within_the_gates_of_contiguous(recording, runs,
                                                     monkeypatch):
    monkeypatch.setattr(prx, "SCAN_BLOCKS", K)
    out = runs[0]
    ref = prx.Receiver(0, True, True, device="cpu").run(
        recording, block_size=BLOCK_RAW)
    for arm in ("fm_demod", "mono"):
        assert_close(getattr(out, arm), getattr(ref, arm).reshape(-1), 1e-5,
                     arm)
    left, ref_left = np_of(out.left), np_of(ref.left).reshape(-1)
    first = ref_left.shape[0] // S
    np.testing.assert_allclose(left[:first], ref_left[:first], atol=1e-2)
    err = np.sqrt(np.mean((left[first:] - ref_left[first:]) ** 2))
    assert err < 1e-4 * np.sqrt(np.mean(ref_left[first:] ** 2))


@pytest.mark.parametrize("chunk_blocks", [4, 7])
def test_chunked_form_on_chunk_graphs(recording, runs, monkeypatch,
                                      chunk_blocks):
    """Host chunks of 4 (a graph of 3 and a block, then 3) or 7 blocks
    straight into the static inputs: bit-equal to the single-shot run."""
    monkeypatch.setattr(prx, "SCAN_BLOCKS", K)
    chunks = list(pts.time_sharded_receive_chunked(
        recording, Mesh(["cpu"] * S, ("time",)), 0, True, True,
        chunk_blocks=chunk_blocks, **SMALL))
    got = pts.assemble_time_chunks(chunks)
    for arm in ARMS:
        np.testing.assert_array_equal(got[arm], np_of(getattr(runs[0], arm)),
                                      err_msg=arm)
