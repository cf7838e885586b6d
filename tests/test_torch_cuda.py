"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a CUDA
kernel has no CPU mode.  The file imports no JAX, so it runs on the GPU
machine, from the repository root:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)

Tolerances: K1, K4 and K5 at 1e-5 (two fp32 summation orders; the
carried tails are exact and must be equal); K2/K3 bit-equal (torch.equal
on outputs and carries, every rounding explicit on both sides), over
chained blocks at the main path's shapes and at ragged lane and step
counts, and the chain floor bit-equal to K2's recurrence; the receiver on
the card (u8 input: K1; float input: K5) against the receiver on the CPU
at 1e-5 on fm_demod and 5e-3 on the PLL-driven arms (the FIR products sum
in other orders on the two devices, and the PLL lock transient amplifies
ulps).  K6, the halo copy of time
sharding, is bit-equal to its plain version: on one card (a 1-D row of
shards and a channel x time grid, float4 and odd lengths, a misaligned
view) and across two cards (skipped, with the reason, on one).
"""

import numpy as np
import pytest
import torch

from sdr_tpu_torch import config as cfg
from sdr_tpu_torch import stimulus
from sdr_tpu_torch.golden import filters as gfilt
from sdr_tpu_torch.models import receiver as prx
from sdr_tpu_torch.ops import fir_decim, fir_frontend, pll_cuda
from sdr_tpu_torch.ops import pll as tpll
from sdr_tpu_torch.parallel import halo as phalo
from sdr_tpu_torch.parallel import time_shard as pts
from sdr_tpu_torch.parallel.mesh import Mesh
from sdr_tpu_torch.utils import synth

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


@pytest.mark.parametrize("c,n", [(1, 57600), (512, 57600), (2, 140)])
def test_k1_kernel_matches_plain(dev, c, n):
    rng = np.random.default_rng(c * n)
    u8 = torch.from_numpy(rng.integers(0, 256, size=(c, 2 * n),
                                       dtype=np.uint8)).to(dev)
    st = torch.tensor(rng.integers(-128, 128, size=(c, 2, 150)) / 128.0,
                      dtype=torch.float32, device=dev)
    h = torch.tensor(gfilt.lowpass_taps(151, MC.rf_fs, cfg.RF_FC_HZ),
                     dtype=torch.float32, device=dev)
    before = fir_frontend.fir_frontend_u8.launches
    yk, sk = fir_frontend.fir_frontend_u8(u8, h, st, 10)
    yp, sp = fir_frontend.fir_frontend_u8_plain(u8, h, st, 10)
    torch.cuda.synchronize()
    assert fir_frontend.fir_frontend_u8.launches == before + 1
    _close(yk, yp, K1_ATOL)
    assert torch.equal(sk, sp)


@pytest.mark.parametrize("decim", [3, 4, 8, 10])
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


@pytest.mark.parametrize("c,n", [(1, 57600), (512, 57600), (2, 140)])
def test_k4_kernel_matches_plain(dev, c, n):
    rng = np.random.default_rng(c + n)
    u8 = torch.from_numpy(rng.integers(0, 256, size=(c, 2 * n),
                                       dtype=np.uint8)).to(dev)
    st = torch.tensor(rng.integers(-128, 128, size=(c, 2, 150)) / 128.0,
                      dtype=torch.float32, device=dev)
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
    assert fir_decim.fir_block_decim.launches == before + 2
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
    assert used == counts[1 if c > 1 else 0] + 2
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
    before = phalo.halo_shift_right.launches
    og = pts.time_sharded_receive(iq, Mesh([dev] * 4, ("time",)), 0, **kw)
    assert phalo.halo_shift_right.launches == before + 1
    oc = pts.time_sharded_receive(iq, Mesh(["cpu"] * 4, ("time",)), 0, **kw)
    _close(og.fm_demod, oc.fm_demod, 1e-5)
    for f in ("left", "right", "rds_symbols"):
        _close(getattr(og, f), getattr(oc, f), 5e-3)
    chunks = list(pts.time_sharded_receive_chunked(
        iq, Mesh([dev] * 4, ("time",)), 0, chunk_blocks=3, **kw))
    got = pts.assemble_time_chunks(chunks)
    for f in ("fm_demod", "mono", "left", "right", "rds_symbols"):
        np.testing.assert_array_equal(got[f], getattr(og, f).cpu().numpy())
