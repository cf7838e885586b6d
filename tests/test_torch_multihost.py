"""The port's scale-out across processes, in gloo processes on the CPU.

``multihost.setup`` joins the processes (rendezvous through a file under
the test's ``tmp_path``, not a fixed port: the suite runs several pytest
workers at once), ``multihost.make_mesh`` builds one mesh over them, and
each process runs its own cells.  Mirrors the four cases of
tests/test_multihost.py through ``scripts/torch_multihost_scaling.py``: a
two-process channel mesh; 2 processes x 2 mesh entries with the time
halo kept in each process; the halo crossing the process edge; the
time-sharded receiver itself.  Blocks of 960 IF samples, two warm-up
blocks (tests/test_torch_parallel.py's sizes); every worker calls
``torch.set_num_threads(1)`` and every configuration has its own timeout.

Gates: each process's channel-sharded rows against a one-process run of
the same rows, and the gathered time-sharded outputs against the port's
one-process run of the same global mesh, at 1e-5 on fm_demod and mono and
5e-3 on the PLL-driven arms; the time-sharded outputs against a
contiguous run at the JAX package's gates, as tests/test_torch_parallel.py
applies them (1e-5 on the linear arms, 1e-2 on shard 0's left channel,
relock RMS below 1e-4 of the reference's); the PLL kernel chosen from the
global channel count in every process.
"""

import datetime
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_multiprocess
from torch_parity import MC, np_of

from sdr_tpu_torch.models import receiver as prx
from sdr_tpu_torch.parallel import mesh as pmesh
from sdr_tpu_torch.parallel import multihost as pmh
from sdr_tpu_torch.parallel import time_shard as pts
from sdr_tpu_torch.parallel.mesh import Mesh
from sdr_tpu_torch.utils import synth

ROOT = Path(__file__).resolve().parents[1]
BLOCK_IF = 960
OVERLAP_IF = 1920
BLOCK_RAW = BLOCK_IF * 2 * MC.rf_decim
LINEAR_ATOL = 1e-5
PLL_ATOL = 5e-3
ATOL = {"fm_demod": LINEAR_ATOL, "mono": LINEAR_ATOL, "left": PLL_ATOL,
        "right": PLL_ATOL, "rds_symbols": PLL_ATOL}
TIMEOUT_S = 240.0
TINY = dict(device="cpu", block_if=BLOCK_IF, rounds=1, timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def scaling():
    return torch_multiprocess.load_scaling()


# --- setup and the backend ---------------------------------------------------


def test_setup_is_a_noop_without_init_or_with_a_group(tmp_path):
    pmh.setup(init_distributed=False)
    assert not dist.is_initialized()
    pmh.setup(f"file://{tmp_path}/store", 1, 0, devices=["cpu"],
              timeout=datetime.timedelta(seconds=60))
    try:
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        # a second call with other arguments changes nothing
        pmh.setup(f"file://{tmp_path}/other", 2, 1, backend="nccl")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        m = pmh.make_mesh(time_per_host=2, devices=["cpu"] * 4)
        assert m.shape == {"ch": 2, "time": 2} and not m.spans_processes
    finally:
        dist.destroy_process_group()


def test_setup_fails_when_a_peer_never_comes(tmp_path):
    """A lost peer fails the rendezvous within its timeout."""
    with pytest.raises(RuntimeError):
        pmh.setup(f"file://{tmp_path}/store", 2, 0, devices=["cpu"],
                  timeout=datetime.timedelta(seconds=1))
    assert not dist.is_initialized()


def test_setup_needs_devices_or_a_backend(tmp_path):
    with pytest.raises(ValueError, match="devices"):
        pmh.setup(f"file://{tmp_path}/store", 1, 0)


@pytest.mark.parametrize("cards,want", [
    ([["cpu"], ["cpu"]], "gloo"),
    ([["h/GPU-a"], ["h/GPU-b"]], "nccl"),
    ([["h/GPU-a", "h/GPU-a"], ["h/GPU-b"]], "nccl"),
    ([["h/GPU-a"], ["h/GPU-a"]], "gloo"),          # two ranks on one card
    ([["h/GPU-a", "h/GPU-b"], ["h/GPU-b"]], "gloo"),
    ([["h/GPU-a"], []], "gloo"),
])
def test_pick_backend(cards, want):
    assert pmh.pick_backend(cards) == want


# --- the mesh's local view ---------------------------------------------------


def test_local_cells_of_each_rank(monkeypatch):
    """A 2 x 4 (ch x time) mesh of two processes: by rows (each time row
    on one process) and transposed (each time row spans both)."""
    devs = np.full((2, 4), "cpu", dtype=object)
    by_rows = Mesh(devs, ("ch", "time"), ranks=[[0] * 4, [1] * 4])
    cross = Mesh(devs, ("ch", "time"), ranks=[[0, 0, 1, 1]] * 2)
    assert by_rows.spans_processes and cross.spans_processes
    for rank in (0, 1):
        monkeypatch.setattr(pmesh, "process_index", lambda: rank)
        assert by_rows.local_cells("time", "ch") == (range(rank, rank + 1),
                                                     range(0, 4))
        assert cross.local_cells("time", "ch") == (
            range(0, 2), range(2 * rank, 2 * rank + 2))
    monkeypatch.setattr(pmesh, "process_index", lambda: 0)
    ragged = Mesh(devs, ("ch", "time"), ranks=[[0, 1, 0, 1]] * 2)
    with pytest.raises(ValueError, match="not one block"):
        ragged.local_cells("time", "ch")
    monkeypatch.setattr(pmesh, "process_index", lambda: 2)
    with pytest.raises(ValueError, match="owns no cell"):
        by_rows.local_cells("time", "ch")


def test_make_mesh_without_a_group_is_one_process():
    m = pmh.make_mesh(time_per_host=4, cross_process_time=True,
                      devices=["cpu"] * 8)
    assert m.shape == {"ch": 4, "time": 2}
    assert not m.spans_processes and not m.ranks.any()


def _span(shape=(2, 4), ranks=((0, 0, 1, 1),) * 2):
    return Mesh(np.full(shape, "cpu", dtype=object), ("ch", "time"),
                ranks=ranks)


def test_chunked_refuses_a_mesh_that_spans_processes():
    with pytest.raises(ValueError, match="spans processes"):
        pts.time_sharded_receive_chunked(np.zeros((2, 4 * BLOCK_RAW)),
                                         _span(), 0, batch_axis="ch",
                                         block_if=BLOCK_IF,
                                         overlap_if=BLOCK_IF)


def test_edge_halos_need_the_process_group():
    """Rank 0's part of a mesh whose time rows span two processes: its
    tails cross the edge, which needs the group."""
    with pytest.raises(RuntimeError, match="torch.distributed"):
        pts.time_sharded_receive(np.zeros((2, 4 * BLOCK_RAW), np.float32),
                                 _span(), 0, stereo=False, batch_axis="ch",
                                 block_if=BLOCK_IF, overlap_if=BLOCK_IF)


def test_exchange_edges_stages_contiguous_host_messages(monkeypatch):
    """With gloo, the edge exchange hands the group contiguous host
    tensors (unpinned for CPU halos), one a time row each way, tagged by
    the row, and the strided halo slots receive the tails whole (a
    loopback in place of the group)."""
    seen = torch_multiprocess.loopback_group(monkeypatch, "gloo")
    monkeypatch.setattr(pts.exchange_edges, "messages", 0)
    halo = 100
    ext = torch.randn(4, 3 * halo, generator=torch.Generator().manual_seed(5))
    pts.exchange_edges([(ext[r:r + 2, -halo:], 1, r) for r in (0, 2)],
                       [(ext[r:r + 2, :halo], 1, r) for r in (0, 2)])
    assert [(op, peer, tag) for op, _, peer, tag in seen] == [
        (dist.isend, 1, 0), (dist.isend, 1, 2),
        (dist.irecv, 1, 0), (dist.irecv, 1, 2)]
    for _, t, _, _ in seen:
        assert t.device.type == "cpu" and t.is_contiguous()
        assert not t.is_pinned()
    assert pts.exchange_edges.messages == 4
    assert torch.equal(ext[:, :halo], ext[:, -halo:])


# --- the four multi-process cases ------------------------------------------


def _held_to_one_process(result: dict) -> None:
    errs = result["max_abs_err_vs_one_process"]
    assert set(errs) == {"fm_demod", "mono", "left", "right"}
    for arm, err in errs.items():
        assert err <= ATOL[arm], (arm, err)


def test_2proc_channel_mesh_runs(scaling, tmp_path):
    """Two gloo processes run the channel-sharded receiver over one global
    mesh, each on its own rows; each held to a one-process run."""
    r = scaling.run_config(tmp_path, 2, 1, ch_per_proc=2, blocks=2, **TINY)
    assert r["num_processes"] == 2 and r["backend"] == "gloo"
    assert r["global_devices"] == 2
    assert r["channels_global"] == 4
    assert r["aggregate_samples_per_s"] > 0
    assert r["halo_confined_to_host"]
    for res in r["results"]:
        _held_to_one_process(res)


def test_2proc_2dev_2d_mesh_halo_local(scaling, tmp_path):
    """2 processes x 2 mesh entries: the (ch x time) grid keeps every time
    row on one process."""
    r = scaling.run_config(tmp_path, 2, 2, ch_per_proc=2, blocks=2, **TINY)
    assert r["global_devices"] == 4
    assert r["results"][0]["mesh_shape"] == {"ch": 2, "time": 2}
    assert r["halo_confined_to_host"]
    assert r["aggregate_samples_per_s"] > 0
    for res in r["results"]:
        _held_to_one_process(res)


def _time_axis_gates(scaling, tmp_path: Path, r: dict) -> None:
    """The gathered outputs against the port's one-process run of the same
    global mesh and against a contiguous run of each channel."""
    full = np.load(tmp_path / "outputs.npz")
    b_rows, s = r["mesh_shape"]["ch"], r["mesh_shape"]["time"]
    iq = synth.u8_to_float(scaling.capture_rows(tmp_path / "capture.npz",
                                                range(b_rows)))
    one = pts.time_sharded_receive(
        iq, Mesh(np.full((b_rows, s), "cpu", dtype=object), ("ch", "time")),
        0, stereo=True, batch_axis="ch", block_if=BLOCK_IF,
        overlap_if=OVERLAP_IF)
    for arm in ("fm_demod", "mono", "left", "right"):
        assert full[arm].shape == tuple(getattr(one, arm).shape), arm
        np.testing.assert_allclose(full[arm], np_of(getattr(one, arm)),
                                   rtol=0, atol=ATOL[arm], err_msg=arm)
    ref = prx.Receiver(0, stereo=True, batch_shape=(b_rows,),
                       device="cpu").run(iq, block_size=BLOCK_RAW)
    for arm in ("fm_demod", "mono"):
        want = np_of(getattr(ref, arm)).transpose(1, 0, 2).reshape(b_rows, -1)
        np.testing.assert_allclose(full[arm], want, rtol=0, atol=LINEAR_ATOL,
                                   err_msg=arm)
    want = np_of(ref.left).transpose(1, 0, 2).reshape(b_rows, -1)
    first = want.shape[1] // s
    np.testing.assert_allclose(full["left"][:, :first], want[:, :first],
                               atol=1e-2)
    err = np.sqrt(np.mean((full["left"][:, first:] - want[:, first:]) ** 2))
    assert err < 1e-4 * np.sqrt(np.mean(want[:, first:] ** 2))


def test_2proc_cross_process_halo(scaling, tmp_path):
    """The mesh transposed so that every time row spans both processes:
    K6's plain version gives each process's one shard of a row zeros, the
    left process's tail arrives by point-to-point, and the outputs hold
    their gates."""
    r = scaling.run_time_axis(tmp_path, 2, 2, cross=True, blocks=3,
                              overlap_if=OVERLAP_IF, reps=2,
                              save_outputs=True, **TINY)
    assert r["mesh_shape"] == {"ch": 2, "time": 2}
    assert not r["halo_intra_process"]
    for res in r["results"]:
        assert res["edge_messages"] == 2          # one per time row
        assert res["edge_ms"] > 0
    assert r["fm_max_abs_err_vs_contiguous"] <= LINEAR_ATOL
    assert r["mono_rel_rms_vs_contiguous"] < 1e-4
    assert r["aggregate_samples_per_s"] > 0
    _time_axis_gates(scaling, tmp_path, r)


def test_2proc_time_axis_sharded_receiver(scaling, tmp_path):
    """The time-sharded receiver over 2 processes x 2 mesh entries, every
    halo inside its process (no edge message)."""
    r = scaling.run_time_axis(tmp_path, 2, 2, blocks=3,
                              overlap_if=OVERLAP_IF, reps=2,
                              save_outputs=True, **TINY)
    assert r["mesh_shape"] == {"ch": 2, "time": 2}
    assert r["halo_intra_process"]
    for res in r["results"]:
        assert res["edge_messages"] == 0 and res["edge_ms"] is None
    assert r["fm_max_abs_err_vs_contiguous"] <= LINEAR_ATOL
    assert r["mono_rel_rms_vs_contiguous"] < 1e-4
    assert r["aggregate_samples_per_s"] > 0
    _time_axis_gates(scaling, tmp_path, r)


# --- the PLL kernel from the global channel count ----------------------------

_SPY = """
import json, sys
import numpy as np
import torch
from sdr_tpu_torch.ops import pll_cuda
from sdr_tpu_torch.parallel import Mesh, channel_sharded_run, multihost
from sdr_tpu_torch.parallel import time_shard

torch.set_num_threads(1)
store, rank, block = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
multihost.setup(store, 2, rank, devices=["cpu"])
calls = {"angles": 0, "mixer": 0}

def spy(name, fn):
    def wrapped(*a, **k):
        calls[name] += 1
        return fn(*a, **k)
    return wrapped

pll_cuda.pll_block_fused_kernel = spy("angles",
                                      pll_cuda.pll_block_fused_kernel)
pll_cuda.pll_mixer_fused_kernel = spy("mixer",
                                      pll_cuda.pll_mixer_fused_kernel)
mesh = multihost.make_mesh(devices=["cpu"])         # (ch 2, time 1)
u8 = np.random.default_rng(rank).integers(0, 256, (256, block),
                                          dtype=np.uint8)
kw = dict(stereo=True, with_rds=True, block_size=block)
seen = {}
channel_sharded_run(u8, mesh, 0, **kw)
seen["channel"] = dict(calls)
calls.update(angles=0, mixer=0)
channel_sharded_run(u8, Mesh(["cpu"], ("ch",)), 0, **kw)
seen["channel_alone"] = dict(calls)
calls.update(angles=0, mixer=0)
iq = u8.astype(np.float32) / 128.0 - 1.0          # one block a shard
time_shard.time_sharded_receive(iq, mesh, 0, True, True, batch_axis="ch",
                                block_if=block // 20,
                                overlap_if=block // 20)
seen["time"] = dict(calls)
print(json.dumps(seen))
"""


def test_fused_mixer_pinned_from_global_channels_across_processes(tmp_path):
    """256 channels x 2 arms in each of two processes: 512 lanes each, but
    the global 512 channels (1,024 lanes) take K3's path, as the
    one-process run of all 512 does, in the channel mesh and the time
    axis; a one-process run of the 256 alone takes K2's."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", _SPY, f"file://{tmp_path}/store", str(r),
         str(BLOCK_RAW)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    for seen in outs:
        assert seen["channel"] == {"angles": 0, "mixer": 1}
        assert seen["channel_alone"] == {"angles": 1, "mixer": 0}
        assert seen["time"] == {"angles": 0, "mixer": 2}   # warm-up + block
