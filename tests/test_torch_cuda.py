"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a CUDA
kernel has no CPU mode.  The file imports no JAX, so it runs on the GPU
machine, from the repository root:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)

Tolerances: K1, K4 and K5 at 1e-5 (two fp32 summation orders; the
carried tails are exact and must be equal; the kernels write their own,
K5's held to ``tail()``), K1 and K4 also at odd tap counts and
decimations, and row 0 of a batch bit-equal to the row alone; K2/K3
bit-equal (torch.equal on outputs and carries, every rounding explicit on
both sides), over
chained blocks at the main path's shapes and at ragged lane and step
counts, and the chain floor bit-equal to K2's recurrence; the receiver on
the card (u8 input: K1; float input: K5) against the receiver on the CPU
at 1e-5 on fm_demod and 5e-3 on the PLL-driven arms (the FIR products sum
in other orders on the two devices, and the PLL lock transient amplifies
ulps).  K6, the halo copy of time
sharding, is bit-equal to its plain version: through its row-block entry
(S=8 shards as row blocks of one tensor, C=1 and 4 rows, shard 0's zero
fill), and through its table entry on one card (the same tensor at an odd
halo, views of one buffer, a 1-D row of shards and a channel x time grid,
float4 and odd lengths, a misaligned view) and across two cards (skipped,
with the reason, on one).  K5 is also held at tap counts whose phase
windows end in half a swizzle group.  The mesh across processes runs
through scripts/torch_multihost_scaling.py with NCCL, two processes on
cards of their own (skipped below 2 or 4 cards): the channel mesh, each
process's rows against a one-process run of the same rows, and the time
axis with the halo inside each process or across the process edge,
against one process running the same mesh on one card (1e-5 on
fm_demod and mono, 5e-3 on the PLL arms) and a contiguous run.  The edge
exchange of halos on the card stages its messages by the group's backend:
pinned host memory for gloo, the card for NCCL.  The block programs (CUDA
graphs of the receiver's block, of the channelizer's and of the
time-sharded step) replay bit-equal (torch.equal) to the eager block over
8 chained blocks, every output arm and state leaf, for each kernel and
arm combination of the paths; ``receive()``'s tail block, a checkpoint
resumed after 5 program blocks, and a capture made to fail (it raises,
nothing runs eagerly instead).  The chunk programs (one graph of
``SCAN_BLOCKS`` chained blocks) equal the per-block program, torch.equal:
u8 at C=1 and C=512, float, mode 2, blocks whose byte length is not a
multiple of 16, a chunk followed by a tail, a host recording through
pinned staging with ``process``/``run``/``process`` interleaved and
``iter_run``, a checkpoint restart between two runs, the time-sharded S=8 run with its warm-up graph (single-shot
and chunked); a chunk capture made to fail raises.  ``iter_run`` fetches
each span's outputs into one pinned host buffer a chunk: bit-equal to
``run``, each chunk its own writable memory, one wait and one fetch span
a chunk.  Mode 3 stereo, on
float input (K5) and raw u8 (K1 at decimation 3), against the port's
float64 golden receiver at the JAX package's tolerances (2e-4 on
fm_demod and mono, 5e-3 on left and right), the one mode no earlier card
check ran; ``profiling.profile_stages`` returns positive times on the
card.
"""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import sdr_tpu_torch
import torch_multiprocess
from sdr_tpu_torch import checkpoint as pckpt
from sdr_tpu_torch import config as cfg
from sdr_tpu_torch import stimulus
from sdr_tpu_torch.golden import filters as gfilt
from sdr_tpu_torch.golden import receiver as grx
from sdr_tpu_torch.models import channelizer as pchan
from sdr_tpu_torch.models import program as pprog
from sdr_tpu_torch.models import receiver as prx
from sdr_tpu_torch.ops import fir_decim, fir_frontend, pll_cuda
from sdr_tpu_torch.ops import pll as tpll
from sdr_tpu_torch.parallel import halo as phalo
from sdr_tpu_torch.parallel import time_shard as pts
from sdr_tpu_torch.parallel.mesh import Mesh
from sdr_tpu_torch.utils import profiling, synth

pytestmark = pytest.mark.cuda

K1_ATOL = 1e-5
MC = cfg.get_mode_config(0)


@pytest.fixture
def dev():
    """The CUDA device; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    prx.pin_fp32_matmul()
    return torch.device("cuda")


def _close(a, b, atol):
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                               atol=atol)


def _lanes_case(c: int, n: int, mixer: bool, device):
    """Time-major PLL inputs for c channels x 2 arms (pilot, RDS): xs laid
    out by LaneLayout, mix a plain contiguous (n, 2c) tensor (which the
    wrapper copies into the kernels' layout when 2c is not a multiple of
    4)."""
    rng = np.random.default_rng(31 + c)
    x = torch.from_numpy(stimulus.pll_tones(rng, c, n, MC.if_fs)).to(device)
    st0 = prx.init_state(MC, (c,), device=device)
    st = tpll.stack_arms([st0.pilot_pll, st0.rds_pll])
    ly = pll_cuda.LaneLayout(x, (prx.pilot_pll_params(MC),
                                 prx.rds_pll_params(MC)))
    mix = torch.tensor(rng.standard_normal((n, c * 2)), dtype=torch.float32,
                       device=device)
    return (ly.time_major(x), ly.carry0(st, mixer), ly.consts(mixer), mix)


# (channels, steps per block, chained blocks): the main path's C=1 and
# C=512, the S=8 time-sharded step's 8 rows (16 lanes), lanes that are not
# a multiple of 32 (6, 1,030), blocks that end inside a 64-step tile, N = 1
PLL_CASES = [(1, 1920, 3), (512, 1920, 1), (8, 1920, 3), (3, 960, 3),
             (515, 960, 2), (1, 1, 3), (2, 1997, 2)]


def _u8_operands(rng, c: int, n: int, k: int, dev):
    """c channels of n random I/Q byte pairs and a u8-normalized state."""
    u8 = torch.from_numpy(rng.integers(0, 256, size=(c, 2 * n),
                                       dtype=np.uint8)).to(dev)
    st = torch.tensor(rng.integers(-128, 128, size=(c, 2, k - 1)) / 128.0,
                      dtype=torch.float32, device=dev)
    return u8, st


# the one-byte front-ends on the FIR template: K1 and K4
U8_KERNELS = {"K1": fir_frontend.fir_frontend_u8,
              "K4": fir_frontend.fir_frontend_u8_deinterleaved}


@pytest.mark.parametrize("c,n", [(1, 57600), (2, 57600), (7, 57600),
                                 (512, 57600), (2, 140)])
def test_k1_kernel_matches_plain(dev, c, n):
    """The main path's block at C = 1, 2, 7, 512, and a block shorter than
    K-1 (the state keeps part of the old one)."""
    rng = np.random.default_rng(c * n)
    u8, st = _u8_operands(rng, c, n, 151, dev)
    h = torch.tensor(gfilt.lowpass_taps(151, MC.rf_fs, cfg.RF_FC_HZ),
                     dtype=torch.float32, device=dev)
    before = fir_frontend.fir_frontend_u8.launches
    yk, sk = fir_frontend.fir_frontend_u8(u8, h, st, 10)
    yp, sp = fir_frontend.fir_frontend_u8_plain(u8, h, st, 10)
    torch.cuda.synchronize()
    assert fir_frontend.fir_frontend_u8.launches == before + 1
    _close(yk, yp, K1_ATOL)
    assert torch.equal(sk, sp)


@pytest.mark.parametrize("kernel", ["K1", "K4"])
@pytest.mark.parametrize("k,decim", [(31, 10), (125, 3), (151, 8),
                                     (151, 10)])
def test_u8_kernels_at_odd_shapes(dev, kernel, k, decim):
    """K1 and K4 at tap counts and decimations off the main path (K=31 at
    D=10, K=125 at D=3, D=8), C = 1 and 64, over 2 chained blocks, the
    second shorter than K-1, each side carrying its own state: within
    K1_ATOL, states equal."""
    fn = U8_KERNELS[kernel]
    h = torch.tensor(gfilt.lowpass_taps(k, decim * 240e3, 100e3),
                     dtype=torch.float32, device=dev)
    for c in (1, 64):
        rng = np.random.default_rng(k * c + decim)
        _, sk = _u8_operands(rng, c, 1, k, dev)
        sp = sk
        for n in (decim * 5_760, decim * 7):
            u8, _ = _u8_operands(rng, c, n, k, dev)
            yk, sk = fn(u8, h, sk, decim)
            yp, sp = fir_frontend.fir_frontend_u8_plain(u8, h, sp, decim)
            torch.cuda.synchronize()
            _close(yk, yp, K1_ATOL)
            assert torch.equal(sk, sp)


@pytest.mark.parametrize("kernel", ["K1", "K4"])
def test_u8_kernels_row_is_batch_invariant(dev, kernel):
    """Row 0 of a C=512 and a C=4 batch gives bit-identical output and state
    to the same row alone (C=1), though the plans differ: an output's
    summation order does not depend on the plan."""
    fn = U8_KERNELS[kernel]
    rng = np.random.default_rng(512)
    u8, st = _u8_operands(rng, 512, 57600, 151, dev)
    h = torch.tensor(gfilt.lowpass_taps(151, MC.rf_fs, cfg.RF_FC_HZ),
                     dtype=torch.float32, device=dev)
    y1, s1 = fn(u8[:1].clone(), h, st[:1].clone(), 10)
    for c in (4, 512):
        yc, sc = fn(u8[:c].clone(), h, st[:c].clone(), 10)
        torch.cuda.synchronize()
        assert torch.equal(yc[:1], y1) and torch.equal(sc[:1], s1), c


@pytest.mark.parametrize("decim", [3, 4, 5, 8, 10])
@pytest.mark.parametrize("layout", ["interleaved", "stacked"])
def test_k5_kernel_matches_plain(dev, decim, layout):
    """K5 on the receiver's interleaved I/Q view (element step 2) and on
    the channelizer's contiguous (C, 2, N) stack (step 1), over 3 chained
    blocks; the first block is shorter than K-1 per output phase."""
    rng = np.random.default_rng(decim)
    c, k = 3, 151
    h = torch.tensor(gfilt.lowpass_taps(k, 9.6e6, 1.08e6),
                     dtype=torch.float32, device=dev)
    sk = sp = torch.tensor(rng.standard_normal((c, 2, k - 1)),
                           dtype=torch.float32, device=dev)
    before = fir_decim.fir_block_decim.launches
    for n in (decim * 14, decim * 960, decim * 1000):
        x = torch.tensor(rng.standard_normal((c, 2 * n)), dtype=torch.float32,
                         device=dev)
        if layout == "interleaved":
            x = x.reshape(c, n, 2).movedim(-1, -2)
        else:
            x = x.reshape(c, 2, n)
        yk, sk = fir_decim.fir_block_decim(x, h, sk, decim)
        yp, sp = fir_decim.fir_block_decim_plain(x, h, sp, decim)
        torch.cuda.synchronize()
        _close(yk, yp, K1_ATOL)
        assert torch.equal(sk, sp)
    assert fir_decim.fir_block_decim.launches == before + 3


@pytest.mark.parametrize("decim", [3, 4, 5, 8, 10])
@pytest.mark.parametrize("layout", ["interleaved", "stacked"])
@pytest.mark.parametrize("c", [1, 2, 64, 512])
def test_k5_kernel_at_the_paths_widths(dev, decim, layout, c):
    """One block of 5,760 outputs per row at C = 1, 2, 64, 512 (R = 1 and
    R = 8 plans, ragged last tiles), then a block shorter than K-1 chained
    on the kernel's own state: outputs within K1_ATOL, each new state
    equal to ``tail()`` of the block."""
    rng = np.random.default_rng(100 * c + decim)
    k = 151
    h = torch.tensor(gfilt.lowpass_taps(k, decim * 240e3, 100e3),
                     dtype=torch.float32, device=dev)
    sk = torch.tensor(rng.standard_normal((c, 2, k - 1)),
                      dtype=torch.float32, device=dev)
    for n in (decim * 5_760, decim * 13):
        x = torch.tensor(rng.standard_normal((c, 2 * n)), dtype=torch.float32,
                         device=dev)
        x = (x.reshape(c, n, 2).movedim(-1, -2) if layout == "interleaved"
             else x.reshape(c, 2, n))
        yk, nk = fir_decim.fir_block_decim(x, h, sk, decim)
        yp, _ = fir_decim.fir_block_decim_plain(x, h, sk, decim)
        torch.cuda.synchronize()
        _close(yk, yp, K1_ATOL)
        assert torch.equal(nk, fir_decim.tail(x, sk))
        sk = nk


@pytest.mark.parametrize("k,decim,c", [(31, 10, 1), (31, 10, 64),
                                        (125, 3, 1), (125, 3, 64)])
@pytest.mark.parametrize("layout", ["interleaved", "stacked"])
def test_k5_kernel_at_odd_tap_counts(dev, k, decim, c, layout):
    """Tap counts whose window rows per phase (32 * R + r_pad) end in half
    a swizzle group: K=31 at D=10 (the R = 1 plan at C=1) and K=125 at D=3
    (the R = 8 plan at C=64).  A block of 5,760 outputs per row, then a
    short one on the kernel's own state, within K1_ATOL; states equal."""
    rng = np.random.default_rng(k * c + decim)
    h = torch.tensor(gfilt.lowpass_taps(k, decim * 240e3, 100e3),
                     dtype=torch.float32, device=dev)
    sk = torch.tensor(rng.standard_normal((c, 2, k - 1)),
                      dtype=torch.float32, device=dev)
    for n in (decim * 5_760, decim * 7):
        x = torch.tensor(rng.standard_normal((c, 2 * n)), dtype=torch.float32,
                         device=dev)
        x = (x.reshape(c, n, 2).movedim(-1, -2) if layout == "interleaved"
             else x.reshape(c, 2, n))
        yk, nk = fir_decim.fir_block_decim(x, h, sk, decim)
        yp, _ = fir_decim.fir_block_decim_plain(x, h, sk, decim)
        torch.cuda.synchronize()
        _close(yk, yp, K1_ATOL)
        assert torch.equal(nk, fir_decim.tail(x, sk))
        sk = nk


@pytest.mark.parametrize("c,n", [(1, 57600), (2, 57600), (7, 57600),
                                 (512, 57600), (2, 140)])
def test_k4_kernel_matches_plain(dev, c, n):
    rng = np.random.default_rng(c + n)
    u8, st = _u8_operands(rng, c, n, 151, dev)
    h = torch.tensor(gfilt.lowpass_taps(151, MC.rf_fs, cfg.RF_FC_HZ),
                     dtype=torch.float32, device=dev)
    before = fir_frontend.fir_frontend_u8_deinterleaved.launches
    yk, sk = fir_frontend.fir_frontend_u8_deinterleaved(u8, h, st, 10)
    yp, sp = fir_frontend.fir_frontend_u8_plain(u8, h, st, 10)
    torch.cuda.synchronize()
    assert fir_frontend.fir_frontend_u8_deinterleaved.launches == before + 1
    _close(yk, yp, K1_ATOL)
    assert torch.equal(sk, sp)


def test_float_receiver_on_card_matches_cpu(dev):
    """Float input (the channelizer's output form) through the receiver on
    the card (K5 front-end) and on the CPU, 2 stations x 2 blocks."""
    iq = synth.synthesize_fm(duration_s=0.02, mode=0, seed=4).iq_u8[:38_400]
    x = np.stack([iq, iq[::-1]]).astype(np.float32) / 128.0 - 1.0
    gpu = prx.Receiver(0, True, True, batch_shape=(2,), device=dev)
    cpu = prx.Receiver(0, True, True, batch_shape=(2,), device="cpu")
    before = fir_decim.fir_block_decim.launches
    og = gpu.run(x, block_size=19_200)
    oc = cpu.run(x, block_size=19_200)
    # two replays of the block program and its eager warm-up
    assert fir_decim.fir_block_decim.launches == before + 2 + 1
    _close(og.fm_demod, oc.fm_demod, 1e-5)
    for f in ("left", "right", "rds_symbols"):
        _close(getattr(og, f), getattr(oc, f), 5e-3)


@pytest.mark.parametrize("c,n,blocks", PLL_CASES)
def test_k2_kernel_matches_plain(dev, c, n, blocks):
    xs, c0, consts, _ = _lanes_case(c, n * blocks, False, dev)
    before = pll_cuda.pll_angles.launches
    ck = cp = c0
    for b in range(blocks):
        blk = xs[b * n:(b + 1) * n]
        ak, ck = pll_cuda.pll_angles(blk, ck, consts)
        ap, cp = pll_cuda.pll_angles_plain(blk, cp, consts)
        torch.cuda.synchronize()
        assert torch.equal(ak, ap) and torch.equal(ck, cp), b
    assert pll_cuda.pll_angles.launches == before + blocks


@pytest.mark.parametrize("c,n,blocks", PLL_CASES)
def test_k3_kernel_matches_plain(dev, c, n, blocks):
    xs, c0, consts, mix = _lanes_case(c, n * blocks, True, dev)
    before = pll_cuda.pll_mixer.launches
    ck = cp = c0
    for b in range(blocks):
        blk, mb = xs[b * n:(b + 1) * n], mix[b * n:(b + 1) * n]
        mk, ck = pll_cuda.pll_mixer(blk, mb, ck, consts)
        mp, cp = pll_cuda.pll_mixer_plain(blk, mb, cp, consts)
        torch.cuda.synchronize()
        assert torch.equal(mk, mp) and torch.equal(ck, cp), b
    assert pll_cuda.pll_mixer.launches == before + blocks


@pytest.mark.parametrize("mixer", [False, True])
def test_pll_kernels_replay_out_of_range_carry(dev, mixer):
    """A carry far outside the shortcuts' ranges (phases beyond 2m, the
    wrapped angle beyond pi): the kernels replay those tiles with fmodf and
    the division, and stay bit-equal."""
    xs, c0, consts, mix = _lanes_case(3, 960, mixer, dev)
    c0 = c0.clone()
    c0[1] = 100.0 + torch.arange(c0.shape[1], device=dev)
    c0[2, ::2] = -37.5
    c0[3] = 9.0
    if mixer:
        got = pll_cuda.pll_mixer(xs, mix, c0, consts)
        want = pll_cuda.pll_mixer_plain(xs, mix, c0, consts)
    else:
        got = pll_cuda.pll_angles(xs, c0, consts)
        want = pll_cuda.pll_angles_plain(xs, c0, consts)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_chain_floor_matches_plain(dev):
    """The chain floor runs K2's recurrence on its own input pattern."""
    _, c0, consts, _ = _lanes_case(1, 4, False, dev)
    before = pll_cuda.chain_floor.launches
    got = pll_cuda.chain_floor(c0, consts, 1000)
    assert torch.equal(got, pll_cuda.chain_floor_plain(c0, consts, 1000))
    assert pll_cuda.chain_floor.launches == before + 1


@pytest.mark.parametrize("c", [1, 512])
def test_receiver_on_card_matches_cpu(dev, c):
    """Two short blocks through the receiver on the card (kernels) and on
    the CPU (plain versions); C = 512 takes K3, C = 1 takes K2."""
    iq = synth.synthesize_fm(duration_s=0.02, mode=0, seed=3).iq_u8[:38_400]
    iq = np.broadcast_to(iq, (c,) + iq.shape) if c > 1 else iq
    gpu = prx.Receiver(0, True, True, batch_shape=(c,) if c > 1 else (),
                       device=dev)
    cpu = prx.Receiver(0, True, True, batch_shape=(c,) if c > 1 else (),
                       device="cpu")
    counts = (pll_cuda.pll_angles.launches, pll_cuda.pll_mixer.launches)
    og = gpu.run(iq, block_size=19_200)
    oc = cpu.run(iq, block_size=19_200)
    used = (pll_cuda.pll_mixer.launches if c > 1
            else pll_cuda.pll_angles.launches)
    # two replays of the block program and its eager warm-up
    assert used == counts[1 if c > 1 else 0] + 2 + 1
    _close(og.fm_demod, oc.fm_demod, 1e-5)
    for f in ("left", "right", "rds_symbols"):
        _close(getattr(og, f), getattr(oc, f), 5e-3)


# --- K6: the halo exchange of time sharding ---------------------------------


def _shard_rows(grid, c: int, halo: int, seg: int, seed: int,
                offset: int = 0):
    """Shard buffers [halo | segment] (c rows each) on the devices of
    ``grid`` (time rows of devices): random segments, NaN halo slots.  With
    ``offset``, each buffer is a view that starts ``offset`` floats into
    its allocation (a pointer that is not 16-byte aligned)."""
    rng = np.random.default_rng(seed)
    rows = []
    for devs in grid:
        row = []
        for d in devs:
            base = torch.full((c, offset + halo + seg), float("nan"),
                              device=d)
            buf = base[:, offset:]
            buf[:, halo:] = torch.from_numpy(
                rng.standard_normal((c, seg)).astype(np.float32))
            row.append(buf)
        rows.append(row)
    return rows


def _k6_against_plain(rows, halo: int) -> None:
    want = [[b.clone() for b in row] for row in rows]
    phalo.halo_fill_plain(want, halo)
    before = phalo.halo_shift_right.launches
    phalo.halo_shift_right(rows, halo)
    torch.cuda.synchronize()
    assert phalo.halo_shift_right.launches > before
    for row, ref in zip(rows, want):
        for b, w in zip(row, ref):
            assert torch.equal(b, w)
    assert not rows[0][0][:, :halo].any()


@pytest.mark.parametrize("grid", [(1, 8), (2, 4)])
@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("halo", [230_400, 38_400, 1_001])
def test_k6_one_card_matches_plain(dev, grid, c, halo):
    """S shards on one card: a row of 8, or a 2 x 4 channel x time grid;
    mode 0's RDS halo and mode 3's (float4 path), and an odd length
    (scalar path)."""
    rows = _shard_rows([[dev] * grid[1]] * grid[0], c, halo, halo + 64,
                       seed=halo + c)
    before = phalo.halo_shift_right.launches
    _k6_against_plain(rows, halo)
    assert phalo.halo_shift_right.launches == before + 1


def test_k6_misaligned_view_matches_plain(dev):
    rows = _shard_rows([[dev] * 4], 3, 4_096, 5_000, seed=9, offset=1)
    assert rows[0][0].data_ptr() % 16
    _k6_against_plain(rows, 4_096)


def test_k6_two_cards_matches_plain(dev):
    """Shards on two cards, each reading its left neighbour over peer
    access; no synchronize between the upload and the kernel."""
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs 2 CUDA devices for peer access, found "
                    f"{torch.cuda.device_count()}")
    a, b = torch.device("cuda", 0), torch.device("cuda", 1)
    for grid in ([[a, a, b, b]], [[a, b, a, b], [b, a, b, a]]):
        _k6_against_plain(_shard_rows(grid, 2, 230_400, 230_464, seed=3),
                          230_400)


def test_time_sharded_two_cards_matches_one_card(dev):
    """S=4 shards, two on each of two cards (shard 2 reads shard 1's tail
    over peer access), against the same shards all on one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs 2 CUDA devices for peer access, found "
                    f"{torch.cuda.device_count()}")
    res = synth.synthesize_fm(duration_s=0.12, mode=0, with_stereo=True,
                              with_rds=True, seed=22)
    iq = synth.u8_to_float(res.iq_u8)[: 4 * 7 * 19_200]
    kw = dict(stereo=True, with_rds=True, overlap_if=1920, block_if=960)
    two = Mesh(["cuda:0", "cuda:0", "cuda:1", "cuda:1"], ("time",))
    before = phalo.halo_shift_right.launches
    o2 = pts.time_sharded_receive(iq, two, 0, **kw)
    assert phalo.halo_shift_right.launches == before + 2
    o1 = pts.time_sharded_receive(iq, Mesh([dev] * 4, ("time",)), 0, **kw)
    _close(o2.fm_demod, o1.fm_demod, 1e-5)
    for f in ("left", "right", "rds_symbols"):
        _close(getattr(o2, f), getattr(o1, f), 5e-3)


@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("halo", [230_400, 1_001])
def test_k6_row_blocks_match_plain(dev, c, halo):
    """S=8 shards as row blocks of one buffer ([halo | segment] rows, as
    time_sharded_receive lays them out): one launch, bit-equal to the plain
    version, shard 0 zero-filled.  Bulk copies move 16-byte multiples only:
    the row-block entry takes mode 0's halo, and the odd halo takes the
    table entry."""
    s, seg = 8, halo + 64
    rng = np.random.default_rng(halo + c)
    ext = torch.full((s * c, halo + seg), float("nan"), device=dev)
    ext[:, halo:] = torch.from_numpy(
        rng.standard_normal((s * c, seg)).astype(np.float32))
    want = ext.clone()
    phalo.halo_fill_plain([[want[j * c:(j + 1) * c] for j in range(s)]],
                          halo)
    buf = ext.view(1, s, c, halo + seg)
    before = (phalo.halo_shift_right.launches,
              phalo.halo_shift_right.row_block_launches)
    phalo.halo_shift_right(buf, halo)
    assert (phalo.halo_shift_right.launches,
            phalo.halo_shift_right.row_block_launches) == (
                before[0] + 1, before[1] + (halo % 4 == 0))
    torch.cuda.synchronize()
    assert torch.equal(ext, want)
    assert not ext[:c, :halo].any()


def test_k6_views_of_one_buffer_take_the_table(dev):
    """Time rows of views of one buffer (a 2 x 4 grid of 3-row shards),
    handed over as lists: one launch of the table entry, bit-equal."""
    t, s, c, halo = 2, 4, 3, 38_400
    ext = torch.randn(t * s * c, 2 * halo + 64, device=dev)
    want = ext.clone()
    rows = lambda e: [[e[(b * s + k) * c:(b * s + k + 1) * c]
                       for k in range(s)] for b in range(t)]
    phalo.halo_fill_plain(rows(want), halo)
    before = (phalo.halo_shift_right.launches,
              phalo.halo_shift_right.row_block_launches)
    phalo.halo_shift_right(rows(ext), halo)
    torch.cuda.synchronize()
    assert (phalo.halo_shift_right.launches,
            phalo.halo_shift_right.row_block_launches) == (
                before[0] + 1, before[1])
    assert torch.equal(ext, want)


@pytest.mark.parametrize("bad", ["mix", "dtype", "stride"])
def test_k6_wrapper_raises(dev, bad):
    ok = torch.zeros(2, 64, device=dev)
    other = {"mix": torch.zeros(2, 64),
             "dtype": torch.zeros(2, 64, dtype=torch.float64, device=dev),
             "stride": torch.zeros(64, 2, device=dev).t()}[bad]
    with pytest.raises(TypeError if bad == "dtype" else ValueError):
        phalo.halo_shift_right([[ok, other]], 16)


def test_time_sharded_on_card_matches_cpu_and_chunked(dev):
    """S=4 shards on one card against the same run on the CPU (1e-5 on
    fm_demod, 5e-3 on the PLL arms, as for the receiver); the chunked path
    equals the single-shot one bit for bit on the card."""
    res = synth.synthesize_fm(duration_s=0.12, mode=0, with_stereo=True,
                              with_rds=True, seed=21)
    iq = synth.u8_to_float(res.iq_u8)[: 4 * 7 * 19_200]
    kw = dict(stereo=True, with_rds=True, overlap_if=1920, block_if=960)
    before = (phalo.halo_shift_right.launches,
              phalo.halo_shift_right.row_block_launches)
    og = pts.time_sharded_receive(iq, Mesh([dev] * 4, ("time",)), 0, **kw)
    assert (phalo.halo_shift_right.launches,
            phalo.halo_shift_right.row_block_launches) == (
                before[0] + 1, before[1] + 1)
    oc = pts.time_sharded_receive(iq, Mesh(["cpu"] * 4, ("time",)), 0, **kw)
    _close(og.fm_demod, oc.fm_demod, 1e-5)
    for f in ("left", "right", "rds_symbols"):
        _close(getattr(og, f), getattr(oc, f), 5e-3)
    chunks = list(pts.time_sharded_receive_chunked(
        iq, Mesh([dev] * 4, ("time",)), 0, chunk_blocks=3, **kw))
    got = pts.assemble_time_chunks(chunks)
    for f in ("fm_demod", "mono", "left", "right", "rds_symbols"):
        np.testing.assert_array_equal(got[f], getattr(og, f).cpu().numpy())


# --- the mesh across processes: NCCL, each process on its own cards ---------

@pytest.fixture(scope="module")
def scaling():
    return torch_multiprocess.load_scaling()


def _need_cards(n: int) -> None:
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices (2 processes on cards of their "
                    f"own), found {torch.cuda.device_count()}")


def test_nccl_channel_mesh_across_processes(dev, scaling, tmp_path):
    """Two processes, one card each, NCCL picked from their devices: each
    process's rows against a one-process run of the same rows."""
    _need_cards(2)
    r = scaling.run_config(tmp_path, 2, 1, device="cuda", cards=1,
                           ch_per_proc=8, rds=True, blocks=3, rounds=2,
                           timeout_s=300.0)
    assert r["backend"] == "nccl"
    for res in r["results"]:
        assert res["launches"]["fir_frontend_u8"] > 0
        for arm, err in res["max_abs_err_vs_one_process"].items():
            assert err <= (1e-5 if arm in ("fm_demod", "mono") else 5e-3), \
                (arm, err)
    print(json.dumps({k: v for k, v in r.items() if k != "results"}))


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("cards", [1, 2])
def test_nccl_time_axis_across_processes(dev, scaling, tmp_path, cards,
                                         cross):
    """Two processes of two mesh entries each, on one card or on two cards
    of their own: the halo inside each process (K6), or every time row
    across the process edge (NCCL point-to-point, staged on the card).
    The gathered outputs against the same mesh shape run by one process
    on one card (1e-5 on fm_demod and mono, 5e-3 on the PLL arms), and
    against a contiguous run (fm_demod 1e-5, mono relative RMS 1e-4)."""
    _need_cards(2 * cards)
    r = scaling.run_time_axis(tmp_path, 2, 2, device="cuda", cards=cards,
                              cross=cross, rds=True, block_if=960, blocks=6,
                              overlap_if=1920, rounds=3, reps=20,
                              save_outputs=True, timeout_s=300.0)
    assert r["backend"] == "nccl" and r["mesh_shape"] == {"ch": 2, "time": 2}
    assert r["halo_intra_process"] == (not cross)
    for res in r["results"]:
        assert res["edge_messages"] == (2 if cross else 0)
        for k in ("fir_decim_f32", "pll_angles", "halo_shift_right"):
            assert res["launches"][k] > 0, (k, res["launches"])
    assert r["fm_max_abs_err_vs_contiguous"] <= 1e-5
    assert r["mono_rel_rms_vs_contiguous"] < 1e-4
    full = np.load(tmp_path / "outputs.npz")
    iq = synth.u8_to_float(scaling.capture_rows(tmp_path / "capture.npz",
                                                range(2)))
    one = pts.time_sharded_receive(
        iq, Mesh(np.full((2, 2), dev, dtype=object), ("ch", "time")), 0,
        stereo=True, with_rds=True, batch_axis="ch", block_if=960,
        overlap_if=1920)
    for f in ("fm_demod", "mono", "left", "right", "rds_symbols"):
        np.testing.assert_allclose(
            full[f], getattr(one, f).cpu().numpy(), rtol=0,
            atol=1e-5 if f in ("fm_demod", "mono") else 5e-3, err_msg=f)
    print(json.dumps({"cards": cards, "cross": cross,
                      **{k: v for k, v in r.items() if k != "results"},
                      "edge_ms": [res["edge_ms"] for res in r["results"]],
                      "k6_ms": [res["k6_ms"] for res in r["results"]]}))


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_exchange_edges_stages_by_backend(dev, monkeypatch, backend):
    """The edge exchange of halos on the card hands gloo only pinned host
    tensors (its TCP transport cannot read a card's memory) and NCCL only
    tensors on the process's card, whatever the layout of the tails and
    slots (a loopback in place of the group)."""
    seen = torch_multiprocess.loopback_group(monkeypatch, backend)
    halo = 1000
    ext = torch.randn(4, 3 * halo, device=dev)
    tails = [(ext[r:r + 2, -halo:], 1, r) for r in (0, 2)]
    slots = [(ext[r:r + 2, :halo], 1, r) for r in (0, 2)]
    pts.exchange_edges(tails, slots)
    for _, t, _, _ in seen:
        assert t.is_contiguous()
        if backend == "gloo":
            assert t.device.type == "cpu" and t.is_pinned()
        else:
            assert t.device == torch.device("cuda",
                                            torch.cuda.current_device())
    assert len(seen) == 4
    assert torch.equal(ext[:, :halo], ext[:, -halo:])


# --- block programs: CUDA graphs of the block against the eager block -------


def _assert_trees_equal(got, want, label: str) -> None:
    """torch.equal leaf by leaf, naming the first leaf that differs."""
    for i, (a, b) in enumerate(zip(pprog.tree_leaves(got),
                                   pprog.tree_leaves(want))):
        assert a.shape == b.shape and torch.equal(a, b), (
            f"{label}, leaf {i}: max abs diff "
            f"{(a.float() - b.float()).abs().max().item() if a.numel() else 0}")


# (mode, channels, stereo, with_rds, rds_debug_q, float input): kernels
PROGRAM_CASES = {
    "u8 C=1": (0, 1, True, True, False, False),             # K1, K2
    "u8 C=512": (0, 512, True, True, False, False),         # K1, K3
    "float C=1": (0, 1, True, True, False, True),           # K5, K2
    "float 8 rows (time-sharded step)": (0, 8, True, True, False, True),
    "mode 2 (44.1 kHz resampler)": (2, 1, True, True, False, False),
    "stereo no RDS": (0, 1, True, False, False, False),     # K1, K3 (1 arm)
    "rds_debug_q": (0, 1, True, True, True, False),         # K1, K2 unfused
}


@pytest.mark.parametrize("case", list(PROGRAM_CASES))
def test_block_program_replay_equals_eager(dev, case):
    """8 chained blocks through the block program (one capture, 8
    replays) and through the eager ``process_block``, each carrying its
    own state: every output arm and state leaf torch.equal.  Each replay
    counts its graph's kernel launches: the eager blocks, the warm-up and
    the replays launch the same kernels."""
    mode, c, stereo, rds, debug_q, as_float = PROGRAM_CASES[case]
    mc = cfg.get_mode_config(mode)
    bs = mc.default_block_size(rds and mc.rds is not None)
    lead = (c,) if c > 1 else ()
    rng = np.random.default_rng(31)
    iq = torch.from_numpy(rng.integers(0, 256, lead + (8 * bs,),
                                       dtype=np.uint8)).to(dev)
    if as_float:
        iq = fir_frontend.normalize_u8(iq)
    coeffs = prx.design_coeffs(mc, device=dev)
    fn = prx.make_block_fn(mc, stereo, rds, rds_debug_q=debug_q)
    s_eager = s_prog = prx.init_state(mc, lead, device=dev)
    before = [f.launches for f in pprog.COUNTED]
    for b in range(8):
        blk = iq[..., b * bs:(b + 1) * bs].contiguous()
        o_eager, s_eager = prx.process_block(blk, coeffs, s_eager, mc, stereo,
                                             rds, rds_debug_q=debug_q)
        o_prog, s_prog = fn(blk, coeffs, s_prog)
        _assert_trees_equal(o_prog, o_eager, f"{case} block {b} outputs")
        _assert_trees_equal(s_prog, s_eager, f"{case} block {b} state")
    torch.cuda.synchronize()
    assert len(fn.captures) == 1 and fn.captures[0].pool_bytes > 0
    runs = 8 + 1 + 8
    added = [f.launches - n for f, n in zip(pprog.COUNTED, before)]
    assert any(added) and all(a % runs == 0 for a in added), added


def test_receive_tail_block_equals_eager(dev):
    """``receive()`` on a capture with a short tail: the whole blocks
    replay one program and the tail captures its own graph; the audio is
    bit-equal to the eager blocks'."""
    mc = cfg.get_mode_config(0)
    iq = synth.synthesize_fm(duration_s=0.3, mode=0, with_rds=True,
                             seed=8).iq_u8
    bs = mc.default_block_size(True)
    assert len(iq) % bs and len(iq) % 19_200 == 0
    got = sdr_tpu_torch.receive(iq, 0, stereo=True, rds=True, device=dev)
    coeffs = prx.design_coeffs(mc, device=dev)
    st = prx.init_state(mc, device=dev)
    outs = []
    for b0 in range(0, len(iq), bs):
        blk = torch.from_numpy(iq[b0:b0 + bs].copy()).to(dev)
        out, st = prx.process_block(blk, coeffs, st, mc, True, True)
        outs.append(out)
    for f in ("mono", "left", "right"):
        want = torch.cat([getattr(o, f) for o in outs]).cpu().numpy()
        np.testing.assert_array_equal(getattr(got, f), want, err_msg=f)


def test_channelizer_program_equals_eager(dev):
    """The channelizer's program (mixer + K5), C=64 stations at 19.2 MS/s,
    3 chained blocks: outputs and state torch.equal to its eager block."""
    mc = cfg.get_mode_config(0)
    ch = pchan.Channelizer([(k - 32) * 200e3 for k in range(64)], 19.2e6,
                           0, device=dev)
    rng = np.random.default_rng(32)
    n_bytes = mc.default_block_size(True) * ch.decim
    st = ch.state
    for b in range(3):
        blk = torch.from_numpy(rng.integers(0, 256, n_bytes,
                                            dtype=np.uint8)).to(dev)
        out = ch.process(blk)
        want, st = pchan._channelize_block(blk, ch.coeffs, st, *ch.mixer,
                                           ch.phase_step(n_bytes // 2),
                                           ch.decim)
        _assert_trees_equal(out, want, f"channelizer block {b}")
        _assert_trees_equal(ch.state, st, f"channelizer state {b}")
    assert len(ch.program.captures) == 1


def test_checkpoint_resume_after_program_blocks(dev, tmp_path):
    """A checkpoint of the program's state saved after 5 blocks and
    resumed in a new ``Receiver`` gives the uninterrupted run's next
    blocks bit for bit."""
    mc = cfg.get_mode_config(0)
    bs = mc.default_block_size(True)
    iq = synth.synthesize_fm(duration_s=0.2, mode=0, with_rds=True,
                             seed=9).iq_u8[:8 * bs]
    blocks = [iq[b * bs:(b + 1) * bs] for b in range(8)]
    r = prx.Receiver(0, True, True, device=dev)
    for blk in blocks[:5]:
        r.process(blk)
    path = pckpt.save(str(tmp_path / "ck"), r.state, 0, block_count=5,
                      input_dtype="uint8")
    want = [r.process(blk) for blk in blocks[5:]]
    r2 = prx.Receiver(0, True, True, device=dev)
    r2.state, _ = pckpt.load(path, expect_input_dtype="uint8", device=dev)
    for b, blk in enumerate(blocks[5:]):
        _assert_trees_equal(r2.process(blk), want[b], f"resumed block {b}")
    _assert_trees_equal(r2.state, r.state, "resumed state")


def _uploading_constants(params_seq, nl, mixer, device):
    """The PLL kernels' constant rows as they were made before they were
    cached: the breakpoints uploaded from host memory on every call."""
    c = pll_cuda.lane_constants(params_seq, nl, device)
    rows = ("kp", "ki", "w", "m", "scale", "adj")[:6 if mixer else 4]
    bps = torch.from_numpy(pll_cuda.turn_breakpoints()).to(device)
    return torch.cat([torch.stack([c[r] for r in rows]),
                      bps[:, None].expand(4, c["kp"].shape[0])])


def _reading_demod(real):
    def demod(i, q, prev):
        y, st = real(i, q, prev)
        float(y.sum())              # a read-back to the host
        return y, st
    return demod


@pytest.mark.parametrize("fault", ["host upload", "host read"])
def test_failed_capture_raises(dev, monkeypatch, fault):
    """A block that uploads from pageable host memory, or reads a result
    back, cannot be captured: the program raises and keeps no graph, and
    nothing runs eagerly in its place.  A program made afterwards still
    captures and replays."""
    if fault == "host upload":
        monkeypatch.setattr(pll_cuda, "kernel_constants",
                            _uploading_constants)
    else:
        monkeypatch.setattr(prx.tdemod, "fm_demod_quad",
                            _reading_demod(prx.tdemod.fm_demod_quad))
    mc = cfg.get_mode_config(0)
    blk = torch.from_numpy(np.random.default_rng(33).integers(
        0, 256, mc.default_block_size(True), dtype=np.uint8)).to(dev)
    coeffs = prx.design_coeffs(mc, device=dev)
    fn = prx.make_block_fn(mc, True, True)
    with pytest.raises(RuntimeError):
        fn(blk, coeffs, prx.init_state(mc, device=dev))
    assert not fn.keys() and not fn.captures
    monkeypatch.undo()
    torch.cuda.synchronize()
    fn = prx.make_block_fn(mc, True, True)
    out, _ = fn(blk, coeffs, prx.init_state(mc, device=dev))
    want, _ = prx.process_block(blk, coeffs, prx.init_state(mc, device=dev),
                                mc, True, True)
    _assert_trees_equal(out, want, "after a failed capture")


# --- chunk programs: one CUDA graph of SCAN_BLOCKS chained blocks -----------

# (mode, channels, with_rds, float input, block bytes or None for the
# mode's default): the chunk graph's kernel and layout combinations
CHUNK_CASES = {
    "u8 C=1": (0, 1, True, False, None),                    # K1, K2
    "u8 C=512": (0, 512, True, False, None),                # K1, K3
    "float C=1": (0, 1, True, True, None),                  # K5, K2
    "mode 2": (2, 1, True, False, None),
    "u8 block not a multiple of 16 bytes": (1, 1, False, False, None),
    # a custom mode (rf 1.2 MS/s, IF 240 kS/s, audio 48 kS/s: blocks of 50
    # samples' multiples) with float blocks of 40,200 bytes
    "float custom-mode block not a multiple of 16 bytes": (
        cfg.custom_mode(1.2e6, 240e3, 48e3), 1, False, True, 10_050),
}


def _chunk_case(dev, case, n_blocks):
    mode, c, rds, as_float, bs = CHUNK_CASES[case]
    mc = mode if isinstance(mode, cfg.ModeConfig) else \
        cfg.get_mode_config(mode)
    rds = rds and mc.rds is not None
    bs = bs or mc.default_block_size(rds)
    lead = (c,) if c > 1 else ()
    rng = np.random.default_rng(41)
    iq = torch.from_numpy(rng.integers(0, 256, (n_blocks,) + lead + (bs,),
                                       dtype=np.uint8)).to(dev)
    if as_float:
        iq = fir_frontend.normalize_u8(iq)
    return mc, rds, lead, iq


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_chunk_program_equals_per_block(dev, case):
    """SCAN_BLOCKS + 3 chained blocks through ``run_blocks`` (one chunk
    graph replayed once, then three replays of the block's graph) against
    the per-block program on the same blocks: every output arm and the
    state torch.equal.  The chunk replay adds SCAN_BLOCKS blocks'
    launches; the static input's block views are 16-byte aligned."""
    k = prx.SCAN_BLOCKS
    mc, rds, lead, iq = _chunk_case(dev, case, k + 3)
    coeffs = prx.design_coeffs(mc, device=dev)
    one = prx.make_block_fn(mc, True, rds)
    st, outs = prx.init_state(mc, lead, device=dev), []
    for blk in iq:
        out, st = one(blk, coeffs, st)
        outs.append(out)
    want = prx.map_state(lambda *a: torch.stack(a), *outs)
    fn = prx.make_block_fn(mc, True, rds)
    pprog.reset_counts()
    before = [f.launches for f in pprog.COUNTED]
    got, own = prx.run_blocks(iq, coeffs, prx.init_state(mc, lead,
                                                         device=dev),
                              mc, True, rds, fn=fn)
    torch.cuda.synchronize()
    _assert_trees_equal(got, want, f"{case} outputs")
    _assert_trees_equal(own, st, f"{case} state")
    assert pprog.counts == {"warm_ups": 2, "captures": 2, "replays": 4,
                            "blocks": k + 3}
    assert sorted(r.blocks for r in fn.captures) == [1, k]
    # per block run: the chunk's k blocks, 3 tail blocks, 2 warm-ups
    added = [f.launches - n for f, n in zip(pprog.COUNTED, before)]
    assert any(added) and all(a % (k + 5) == 0 for a in added), added
    (entry,) = [e for e in fn._entries.values() if e.blocks]
    assert all(entry.x[b].data_ptr() % 16 == 0 for b in range(k))


def test_chunk_program_from_host_through_pinned_staging(dev):
    """``Receiver.run`` and ``iter_run`` on a host recording (copied into
    the chunk graph's static input through pinned staging), and
    ``process``/``run``/``process`` interleaved on one receiver: equal to
    the per-block program block by block."""
    k = prx.SCAN_BLOCKS
    bs = MC.default_block_size(True)
    iq = np.random.default_rng(42).integers(0, 256, (2 * k + 5) * bs,
                                            dtype=np.uint8)
    ref = prx.Receiver(0, True, True, device=dev)
    want = [ref.process(iq[b * bs:(b + 1) * bs]) for b in range(2 * k + 5)]
    stack = lambda outs: prx.map_state(lambda *a: torch.stack(a), *outs)
    r = prx.Receiver(0, True, True, device=dev)
    _assert_trees_equal(r.process(iq[:bs]), want[0], "process")
    mid = r.run(iq[bs:(2 * k + 4) * bs])
    _assert_trees_equal(mid, stack(want[1:2 * k + 4]), "run")
    _assert_trees_equal(r.process(iq[(2 * k + 4) * bs:]), want[-1],
                        "process after run")
    _assert_trees_equal(r.state, ref.state, "state")
    it = prx.Receiver(0, True, True, device=dev)
    chunks = list(it.iter_run(iq, chunk_blocks=k + 2))
    for arm in ("mono", "left", "rds_symbols"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(c, arm) for c in chunks]),
            getattr(stack(want), arm).cpu().numpy(), err_msg=arm)


@pytest.mark.parametrize("chunk_blocks", [16, 35, 64])
def test_iter_run_fetches_each_span_into_pinned_host_memory(dev,
                                                            chunk_blocks):
    """``iter_run`` of 4 channels over 2 chunks and a 5-block tail (35
    leaves per-block spans in every chunk): each span's outputs go
    straight into one pinned host buffer of the chunk.  The chunks
    concatenate to ``run`` fetched to the host bit for bit on every arm,
    with the same state; every array is writable, pinned and no other
    chunk's memory, so writing chunk 0 after chunk 2 was drawn leaves the
    others as they were; ``fetch_counts`` counts each span and its
    bytes."""
    bs = MC.default_block_size(True)
    n = 2 * chunk_blocks + 5
    iq = np.random.default_rng(45).integers(0, 256, (4, n * bs),
                                            dtype=np.uint8)
    ref = prx.Receiver(0, True, True, batch_shape=(4,), device=dev)
    want = prx.map_state(lambda a: a.cpu().numpy(), ref.run(iq))
    rx = prx.Receiver(0, True, True, batch_shape=(4,), device=dev)
    prx.reset_fetch_counts()
    chunks = list(rx.iter_run(iq, chunk_blocks=chunk_blocks))
    assert [len(c.mono) for c in chunks] == [chunk_blocks] * 2 + [5]
    for arm in prx.BlockOutputs._fields:
        np.testing.assert_array_equal(
            np.concatenate([getattr(c, arm) for c in chunks]),
            getattr(want, arm), err_msg=arm)
    _assert_trees_equal(rx.state, ref.state, "state")
    arrays = [(i, a) for i, c in enumerate(chunks) for a in c if a.size]
    assert all(a.flags.writeable and torch.from_numpy(a).is_pinned()
               for _, a in arrays)
    assert not any(np.may_share_memory(a, b) for i, a in arrays
                   for j, b in arrays if i != j)
    for a in chunks[0]:
        a[...] = -1.0
    for arm in prx.BlockOutputs._fields:
        np.testing.assert_array_equal(
            np.concatenate([getattr(c, arm) for c in chunks[1:]]),
            getattr(want, arm)[chunk_blocks:], err_msg=arm)
    assert prx.fetch_counts == {
        "pinned_fetches": sum(len(prx.block_spans(len(c.mono)))
                              for c in chunks),
        "fetched_bytes": sum(a.nbytes for _, a in arrays)}


def test_iter_run_on_the_card_waits_and_fetches_once_a_chunk(dev):
    """While a profile records, each chunk of ``iter_run`` on the card
    shows one ``sdr.receiver.wait`` and then one ``sdr.receiver.fetch``
    span after its spans' replays, and nothing is concatenated on the
    device: the spans ``device_wait_ms_per_block`` and
    ``fetch_ms_per_block`` read."""
    from torch.profiler import ProfilerActivity, profile
    k = prx.SCAN_BLOCKS
    bs = MC.default_block_size(True)
    iq = np.random.default_rng(46).integers(0, 256, (2 * k + 3) * bs,
                                            dtype=np.uint8)
    rx = prx.Receiver(0, True, True, device=dev)
    list(rx.iter_run(iq, chunk_blocks=k + 3))     # every key captured
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        list(rx.iter_run(iq, chunk_blocks=k + 3))
    names = [e.name for e in sorted(prof.events(),
                                    key=lambda e: e.time_range.start)
             if e.name in ("sdr.program.replay", "sdr.receiver.cat",
                           "sdr.receiver.wait", "sdr.receiver.fetch")]
    chunk = ["sdr.receiver.wait", "sdr.receiver.fetch"]
    assert names == ["sdr.program.replay"] * 4 + chunk \
        + ["sdr.program.replay"] + chunk


def test_chunk_checkpoint_restart_mid_recording(dev, tmp_path):
    """``run`` of SCAN_BLOCKS + 2 blocks (a chunk graph, 2 block replays),
    a checkpoint of the state, a new ``Receiver`` loading it and running
    SCAN_BLOCKS + 3 more: torch.equal to one uninterrupted ``run``."""
    k = prx.SCAN_BLOCKS
    bs = MC.default_block_size(True)
    iq = np.random.default_rng(44).integers(0, 256, (2 * k + 5) * bs,
                                            dtype=np.uint8)
    whole = prx.Receiver(0, True, True, device=dev)
    want = whole.run(iq)
    a = prx.Receiver(0, True, True, device=dev)
    head = a.run(iq[:(k + 2) * bs])
    path = pckpt.save(str(tmp_path / "ck"), a.state, 0, block_count=k + 2,
                      input_dtype="uint8")
    b = prx.Receiver(0, True, True, device=dev)
    b.state, _ = pckpt.load(path, expect_input_dtype="uint8", device=dev)
    tail = b.run(iq[(k + 2) * bs:])
    _assert_trees_equal(prx.map_state(lambda x, y: torch.cat([x, y]), head,
                                      tail), want, "resumed run")
    _assert_trees_equal(b.state, whole.state, "resumed state")


def test_time_sharded_chunk_graphs_equal_per_block(dev, monkeypatch):
    """S=8 shards on one card, 2 warm-up blocks (one graph) and 20 blocks
    a shard (a chunk graph per SCAN_BLOCKS, a tail), the single-shot and
    the chunked forms: torch.equal to the per-block program."""
    bs = 960 * 2 * MC.rf_decim
    iq = synth.u8_to_float(synth.synthesize_fm(
        duration_s=0.8, mode=0, with_stereo=True, with_rds=True,
        seed=21).iq_u8)[: 8 * 20 * bs]
    kw = dict(stereo=True, with_rds=True, overlap_if=1920, block_if=960)
    mesh = Mesh([dev] * 8, ("time",))
    got = pts.time_sharded_receive(iq, mesh, 0, **kw)
    chunked = pts.assemble_time_chunks(list(pts.time_sharded_receive_chunked(
        iq, mesh, 0, chunk_blocks=prx.SCAN_BLOCKS + 2, **kw)))
    monkeypatch.setattr(prx, "SCAN_BLOCKS", 0)
    want = pts.time_sharded_receive(iq, mesh, 0, **kw)
    _assert_trees_equal(got, want, "time-sharded")
    for f in ("fm_demod", "mono", "left", "right", "rds_symbols"):
        np.testing.assert_array_equal(chunked[f],
                                      getattr(want, f).cpu().numpy())


def test_failed_chunk_capture_raises(dev, monkeypatch):
    """A chunk graph whose block reads a result back cannot be captured:
    the scan raises and keeps no graph, nothing runs eagerly instead."""
    monkeypatch.setattr(prx.tdemod, "fm_demod_quad",
                        _reading_demod(prx.tdemod.fm_demod_quad))
    bs = MC.default_block_size(True)
    xs = torch.from_numpy(np.random.default_rng(43).integers(
        0, 256, (4, bs), dtype=np.uint8)).to(dev)
    fn = prx.make_block_fn(MC, True, True)
    pprog.reset_counts()
    with pytest.raises(RuntimeError):
        fn.scan(xs, prx.design_coeffs(MC, device=dev),
                prx.init_state(MC, device=dev))
    assert not fn.keys() and not fn.captures
    assert pprog.counts["replays"] == 0 and pprog.counts["blocks"] == 0
    torch.cuda.synchronize()


# --- the golden receiver and the profile on the card --------------------


@pytest.mark.parametrize("kind", ["float", "u8"])
def test_mode3_matches_golden_receiver(dev, kind):
    """Mode 3 stereo (K3; K5 on float, K1 at decimation 3 on u8) against
    ``golden.receiver.run_file`` over 3 blocks, chip_smoke.py phase 6's
    case."""
    mc = cfg.get_mode_config(3)
    res = synth.synthesize_fm(duration_s=0.12, mode=3, with_stereo=True,
                              with_rds=False, seed=6)
    iq = synth.u8_to_float(res.iq_u8)
    bs = mc.default_block_size()
    gold = grx.run_file(iq, mc, stereo=True, block_size=bs)[:3]
    x = iq if kind == "float" else res.iq_u8
    outs = prx.Receiver(3, stereo=True, device=dev).run(x[:3 * bs])
    for arm, atol in (("fm_demod", 2e-4), ("mono", 2e-4), ("left", 5e-3),
                      ("right", 5e-3)):
        np.testing.assert_allclose(
            getattr(outs, arm).cpu().numpy(),
            np.stack([getattr(g, arm) for g in gold]), rtol=0, atol=atol,
            err_msg=arm)


def test_profile_stages_on_card(dev):
    p = profiling.profile_stages(mode=0, n_blocks=5, device=dev)
    for k in ("mono_ms", "stereo_ms", "stereo_rds_ms"):
        assert p[k] > 0, (k, p)
    assert p["realtime_budget_ms"] == 24.0
    assert p["stereo_rds_ms"] < p["realtime_budget_ms"]
