"""The port's scale-out layer (``sdr_tpu_torch.parallel``) against the JAX
package's, on the CPU.

The JAX package runs on the 8 virtual CPU devices of tests/conftest.py; the
port runs on ``cpu`` meshes of the same shape (one process, a device named
once per shard), where K6 and the receiver's kernels run their plain
versions.  Recordings are short and blocks small (960 IF samples, two
warm-up blocks), as tests/test_parallel.py does for its 2-D case.

Tolerances: the port against the JAX package at FM_ATOL (2e-4) on
fm_demod/mono and PLL_ARM_ATOL (5e-3) on left/right/RDS, as for the
receiver (XLA contracts the PLL's multiply-adds into FMAs on the CPU); the
port's own time-sharded run against its contiguous run at the JAX
package's gates (tests/test_parallel.py): 1e-5 on the linear arms, 1e-2
on shard 0's left channel, relock RMS below 1e-4 of the reference RMS.
Chunked against single-shot, ``iter_run`` against ``run`` and K6's plain
version against ``lax.ppermute`` are bit-equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax import shard_map
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from torch_parity import (FM_ATOL, MC, PLL_ARM_ATOL, PMC, assert_close,
                          mode_configs, np_of)

from sdr_tpu import config as cfg
from sdr_tpu.models import receiver as jrx
from sdr_tpu.parallel import channel as jch
from sdr_tpu.parallel import multihost as jmh
from sdr_tpu.parallel import time_shard as jts
from sdr_tpu.utils import synth
from sdr_tpu_torch.models import rds_decode as prds
from sdr_tpu_torch.models import receiver as prx
from sdr_tpu_torch.ops import pll_cuda
from sdr_tpu_torch.parallel import channel as pch
from sdr_tpu_torch.parallel import halo as phalo
from sdr_tpu_torch.parallel import multihost as pmh
from sdr_tpu_torch.parallel import time_shard as pts
from sdr_tpu_torch.parallel.mesh import Mesh

S = 4
BLOCK_IF = 960            # mode 0 with RDS: the smallest whole block
OVERLAP_IF = 1920         # two warm-up blocks
BLOCK_RAW = BLOCK_IF * 2 * MC.rf_decim
ARMS = ("fm_demod", "mono", "left", "right", "rds_symbols")
SMALL = dict(overlap_if=OVERLAP_IF, block_if=BLOCK_IF)


def _trim(iq: np.ndarray, s: int, block_raw: int) -> np.ndarray:
    seg = (iq.shape[-1] // s) // block_raw * block_raw
    return np.ascontiguousarray(iq[..., : seg * s])


def _leaves(tree) -> list:
    """The tensors of a state or outputs tuple, in field order."""
    out = []
    prx.map_state(out.append, tree)
    return out


def _jmesh(shape, names):
    return JMesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                 names)


def _pmesh(shape, names):
    return Mesh(np.full(shape, "cpu", dtype=object), names)


@pytest.fixture(scope="module")
def recording():
    res = synth.synthesize_fm(duration_s=0.12, mode=0, with_stereo=True,
                              with_rds=True, seed=21)
    return _trim(synth.u8_to_float(res.iq_u8), S, BLOCK_RAW)


@pytest.fixture(scope="module")
def sharded(recording):
    """The port's 1-D S=4 stereo+RDS time-sharded run."""
    return pts.time_sharded_receive(recording, _pmesh((S,), ("time",)), 0,
                                    stereo=True, with_rds=True, **SMALL)


@pytest.fixture(scope="module")
def contiguous(recording):
    """The port's contiguous run of the same recording, same blocks."""
    r = prx.Receiver(0, stereo=True, with_rds=True, device="cpu")
    return r.run(recording, block_size=BLOCK_RAW)


# --- time sharding against the JAX package ------------------------------


def _case(name, recording):
    """(iq, mode, stereo, with_rds, kwargs, mesh shape and names)."""
    if name == "1d":
        return recording, 0, True, True, dict(SMALL), (S,), ("time",)
    if name == "2d":
        iqc = np.stack([recording, recording * 0.75])
        return (iqc, 0, True, False, dict(SMALL, batch_axis="ch"), (2, S),
                ("ch", "time"))
    mc2 = cfg.get_mode_config(2)
    res = synth.synthesize_fm(duration_s=0.2, mode=2, with_stereo=False,
                              with_rds=False, seed=17)
    mult = mc2.if_block_multiple(False)
    iq = _trim(synth.u8_to_float(res.iq_u8), S, mult * 2 * mc2.rf_decim)
    return (iq, 2, False, False, dict(overlap_if=2 * mult, block_if=mult),
            (S,), ("time",))


@pytest.mark.parametrize("name", ["1d", "2d", "mode2"])
def test_time_sharded_matches_jax(recording, sharded, name):
    """1-D S=4 stereo+RDS, a 2 x 4 channel x time grid (stereo), and
    mode 2's rational resampler (mono) against ``time_sharded_receive``."""
    iq, mode, stereo, rds, kw, shape, names = _case(name, recording)
    j = jts.time_sharded_receive(iq, _jmesh(shape, names), mode, stereo,
                                 rds, axis="time", **kw)
    p = sharded if name == "1d" else pts.time_sharded_receive(
        iq, _pmesh(shape, names), mode, stereo, rds, **kw)
    for arm in ("fm_demod", "mono"):
        assert_close(getattr(p, arm), getattr(j, arm), FM_ATOL, arm)
    for arm in ("left", "right", "rds_symbols"):
        want, got = np.asarray(getattr(j, arm)), np_of(getattr(p, arm))
        if (arm in ("left", "right") and not stereo) or (
                arm == "rds_symbols" and not rds):
            assert got.size == 0 and want.size == 0, arm
            continue
        assert got.shape == want.shape, arm
        assert_close(got, want, PLL_ARM_ATOL, arm)


def test_default_block_if_matches_jax():
    for mode in range(4):
        mc, pmc = mode_configs(mode)
        for rds in (False, True):
            assert pts.default_block_if(pmc, rds) == jts.default_block_if(mc,
                                                                          rds)


# --- the port's own invariants at the JAX package's gates ----------------


def test_linear_arms_match_contiguous(sharded, contiguous):
    for arm in ("fm_demod", "mono"):
        assert_close(getattr(sharded, arm),
                     getattr(contiguous, arm).reshape(-1), 1e-5, arm)


def test_shard0_reset_and_relock(sharded, contiguous):
    """Shard 0 restarts from the exact fresh state after its zero warm-up,
    so it follows a contiguous run from sample 0; the later shards re-lock
    within the overlap."""
    left = np_of(sharded.left)
    ref = np_of(contiguous.left).reshape(-1)
    assert left.shape == ref.shape
    first = ref.shape[0] // S
    np.testing.assert_allclose(left[:first], ref[:first], atol=1e-2)
    err = np.sqrt(np.mean((left[first:] - ref[first:]) ** 2))
    assert err < 1e-4 * np.sqrt(np.mean(ref[first:] ** 2))


def test_reset_shard0_state_is_fresh():
    """Rows of shard 0 take the fresh state, the others keep theirs."""
    fresh = prx.init_state(PMC, (3,))
    walked = prx.map_state(lambda a: a + 1.0, fresh)
    got = pts._reset_first(walked, fresh, torch.tensor([True, False, True]))
    for g, f, w in zip(*map(_leaves, (got, fresh, walked))):
        np.testing.assert_array_equal(np_of(g)[[0, 2]], np_of(f)[[0, 2]])
        np.testing.assert_array_equal(np_of(g)[1], np_of(w)[1])


def test_rds_symbols_survive_sharding():
    """Every RDS info word decoded from the time-sharded soft symbols was
    transmitted."""
    res = synth.synthesize_fm(duration_s=0.45, mode=0, with_stereo=False,
                              with_rds=True, seed=21)
    iq = _trim(synth.u8_to_float(res.iq_u8), S, BLOCK_RAW)
    out = pts.time_sharded_receive(iq, _pmesh((S,), ("time",)), 0,
                                   stereo=False, with_rds=True, **SMALL)
    dec = prds.decode_robust(np_of(out.rds_symbols), MC.rds.sps)
    sent = {tuple(w) for g in res.rds_info_bits for w in g}
    words = [tuple(w) for w in dec.info_words]
    assert len(words) >= 10
    assert all(w in sent for w in words)


# --- chunked streaming -----------------------------------------------------


@pytest.mark.parametrize("layout,chunk_blocks",
                         [("1d", 2), ("1d", 7), ("1d", 1000), ("2d", 3)])
def test_chunked_equals_single_shot(recording, sharded, layout,
                                    chunk_blocks):
    """The chunked path (halos sliced on the host) assembles bit for bit
    to the single-shot path (halos from K6)."""
    if layout == "1d":
        iq, mesh, kw, ref = recording, _pmesh((S,), ("time",)), {}, sharded
        stereo, rds = True, True
    else:
        iq = np.stack([recording, recording * 0.5])
        mesh, kw = _pmesh((2, S), ("ch", "time")), dict(batch_axis="ch")
        stereo, rds = True, False
        ref = pts.time_sharded_receive(iq, mesh, 0, stereo, rds, **SMALL,
                                       **kw)
    chunks = list(pts.time_sharded_receive_chunked(
        iq, mesh, 0, stereo, rds, chunk_blocks=chunk_blocks, **SMALL, **kw))
    got = pts.assemble_time_chunks(chunks)
    for arm in ARMS[:4] + (("rds_symbols",) if rds else ()):
        np.testing.assert_array_equal(got[arm], np_of(getattr(ref, arm)),
                                      err_msg=arm)


def test_chunk_outputs_are_bounded(recording):
    per = BLOCK_IF * MC.audio_upsamp // MC.audio_decim
    gen = pts.time_sharded_receive_chunked(
        recording, _pmesh((S,), ("time",)), 0, stereo=False, chunk_blocks=2,
        **SMALL)
    n = 0
    for out in gen:
        assert out["mono"].shape[0] == S
        assert out["mono"].shape[-1] <= 2 * per
        n += 1
    assert n == -(-(recording.shape[-1] // S // BLOCK_RAW) // 2)


# --- contiguous counterparts in models.receiver ---------------------------


@pytest.fixture(scope="module")
def station_u8():
    return synth.synthesize_fm(duration_s=0.05, mode=0, seed=7,
                               with_stereo=True, with_rds=True).iq_u8


@pytest.mark.parametrize("chunk_blocks", [1, 3, 64])
def test_iter_run_concat_equals_run(station_u8, chunk_blocks):
    a = prx.Receiver(0, stereo=True, with_rds=True, device="cpu")
    b = prx.Receiver(0, stereo=True, with_rds=True, device="cpu")
    whole = a.run(station_u8, block_size=BLOCK_RAW)
    chunks = list(b.iter_run(station_u8, block_size=BLOCK_RAW,
                             chunk_blocks=chunk_blocks))
    assert all(isinstance(c.mono, np.ndarray) for c in chunks)
    for arm in ARMS:
        got = np.concatenate([getattr(c, arm) for c in chunks], axis=0)
        np.testing.assert_array_equal(got, np_of(getattr(whole, arm)),
                                      err_msg=arm)
    for sa, sb in zip(_leaves(a.state), _leaves(b.state)):
        np.testing.assert_array_equal(np_of(sa), np_of(sb))


def test_iter_run_batched_channels(station_u8):
    iq2 = np.stack([station_u8, station_u8[::-1].copy()])
    a = prx.Receiver(0, stereo=True, batch_shape=(2,), device="cpu")
    b = prx.Receiver(0, stereo=True, batch_shape=(2,), device="cpu")
    whole = a.run(iq2, block_size=BLOCK_RAW)
    got = np.concatenate([c.mono for c in b.iter_run(
        iq2, block_size=BLOCK_RAW, chunk_blocks=2)], axis=0)
    np.testing.assert_array_equal(got, np_of(whole.mono))


def test_run_blocks_matches_jax_scan(station_u8):
    """``run_blocks`` against ``run_blocks_scan``: 3 blocks x 2 channels."""
    blocks = np.stack([station_u8[:3 * BLOCK_RAW],
                       station_u8[BLOCK_RAW:4 * BLOCK_RAW]])
    blocks = np.ascontiguousarray(
        np.moveaxis(blocks.reshape(2, 3, BLOCK_RAW), 1, 0))
    po, ps = prx.run_blocks(torch.from_numpy(blocks), prx.design_coeffs(PMC),
                            prx.init_state(PMC, (2,)), PMC, True, True)
    jo, js = jrx.run_blocks_scan(jnp.asarray(blocks), jrx.design_coeffs(MC),
                                 jrx.init_state(MC, (2,)), 0, True, True)
    for arm in ARMS:
        tol = FM_ATOL if arm in ("fm_demod", "mono") else PLL_ARM_ATOL
        assert_close(getattr(po, arm), getattr(jo, arm), tol, arm)
    np.testing.assert_array_equal(np_of(ps.rf_i), np.asarray(js.rf_i))


def test_channel_chunked_matches_direct_and_jax(station_u8):
    """Six channels in chunks of 3, after a warm-up block: equal to the
    port's direct call, and to the JAX package's chunked call at the
    receiver tolerances."""
    c = 6
    iq = [np.stack([np.roll(station_u8[b * BLOCK_RAW:(b + 1) * BLOCK_RAW],
                            13 * r) for r in range(c)]) for b in range(2)]
    kw = dict(stereo=True, with_rds=True)
    _, warm = prx.process_block(torch.from_numpy(iq[0]),
                                prx.design_coeffs(PMC),
                                prx.init_state(PMC, (c,)), PMC, **kw)
    o1, s1 = prx.process_block(torch.from_numpy(iq[1]),
                               prx.design_coeffs(PMC), warm, PMC, **kw)
    o2, s2 = prx.process_block_channel_chunked(
        torch.from_numpy(iq[1]), prx.design_coeffs(PMC), warm, PMC,
        channel_chunk=3, **kw)
    for arm in ARMS:
        assert_close(getattr(o2, arm), getattr(o1, arm), 1e-4, arm)
    for a, b in zip(_leaves(s1), _leaves(s2)):
        assert a.shape == b.shape
    np.testing.assert_array_equal(np_of(s1.rf_i), np_of(s2.rf_i))

    jc = jrx.design_coeffs(MC)
    _, jwarm = jrx.process_block(jnp.asarray(iq[0]), jc,
                                 jrx.init_state(MC, (c,)), MC, **kw)
    jo, js = jrx.process_block_channel_chunked(jnp.asarray(iq[1]), jc, jwarm,
                                               MC, channel_chunk=3, **kw)
    for arm in ARMS:
        tol = FM_ATOL if arm in ("fm_demod", "mono") else PLL_ARM_ATOL
        assert_close(getattr(o2, arm), getattr(jo, arm), tol, arm)
    np.testing.assert_array_equal(np_of(s2.rf_i), np.asarray(js.rf_i))


def test_channel_chunked_falls_through(station_u8):
    """A batch that is not a whole number (> 1) of chunks takes the direct
    path: identical results."""
    iq = torch.from_numpy(np.stack([station_u8[:BLOCK_RAW]] * 5))
    st = prx.init_state(PMC, (5,))
    coeffs = prx.design_coeffs(PMC)
    o1, _ = prx.process_block(iq, coeffs, st, PMC, stereo=True)
    o2, _ = prx.process_block_channel_chunked(iq, coeffs, st, PMC,
                                              stereo=True, channel_chunk=3)
    np.testing.assert_array_equal(np_of(o1.left), np_of(o2.left))


# --- channel sharding --------------------------------------------------------


@pytest.fixture(scope="module")
def channels():
    """8 stations (own tones and seeds), 4 short blocks each, float."""
    chans = []
    for seed in range(8):
        r = synth.synthesize_fm(duration_s=0.02, mode=0, seed=seed,
                                with_rds=False, tone_l=400.0 + 100 * seed,
                                tone_r=2600.0 - 200 * seed)
        chans.append(synth.u8_to_float(r.iq_u8)[:4 * BLOCK_RAW])
    return np.stack(chans)


@pytest.mark.parametrize("devices", [4, 8])
def test_channel_sharded_matches_serial_and_jax(channels, devices):
    """8 channels over 4 or 8 shards (two or one per mesh entry) against
    per-channel runs of the port, and against the JAX package's sharded
    run on 8 devices."""
    mesh = _pmesh((devices,), ("d",))
    shards = pch.channel_sharded_run(channels, mesh, 0, stereo=True,
                                     block_size=BLOCK_RAW, axis="d")
    assert len(shards.outputs) == devices
    per = 8 // devices
    for d, out in enumerate(shards.outputs):
        assert out.left.shape[:2] == (4, per)
        assert shards.states[d].rf_i.shape[0] == per
    outs, state = pch.gather_channels(shards)
    assert outs.left.shape[:2] == (4, 8) and state.rf_i.shape[0] == 8
    for c in (0, 3, 7):
        ref = prx.Receiver(0, stereo=True, device="cpu").run(
            channels[c], block_size=BLOCK_RAW)
        assert_close(outs.left[:, c], ref.left, 1e-4, f"channel {c}")
    jo, _ = jch.channel_sharded_run(channels, _jmesh((8,), ("d",)), 0,
                                    stereo=True, block_size=BLOCK_RAW,
                                    axis="d")
    assert_close(outs.fm_demod, jo.fm_demod, FM_ATOL)
    assert_close(outs.mono, jo.mono, FM_ATOL)
    assert_close(outs.left, jo.left, PLL_ARM_ATOL)


def test_channel_sharded_u8_input(channels):
    """Raw u8 stays u8 up to the receiver and matches its float form."""
    u8 = np.round((channels[:2] + 1.0) * 128.0).clip(0, 255).astype(np.uint8)
    mesh = _pmesh((2,), ("ch",))
    a, _ = pch.gather_channels(pch.channel_sharded_run(
        u8, mesh, 0, stereo=False, block_size=BLOCK_RAW))
    b, _ = pch.gather_channels(pch.channel_sharded_run(
        u8.astype(np.float32) / 128.0 - 1.0, mesh, 0, stereo=False,
        block_size=BLOCK_RAW))
    assert_close(a.mono, b.mono, 1e-6)


# --- mesh layout -------------------------------------------------------------


def test_make_mesh_layout():
    devs = ["cpu"] * 8
    m = pmh.make_mesh(time_per_host=4, devices=devs)
    assert m.shape == {"ch": 2, "time": 4}
    assert m.shape == dict(jmh.make_mesh(time_per_host=4).shape)
    t = pmh.make_mesh(time_per_host=4, cross_process_time=True, devices=devs)
    assert t.shape == {"ch": 4, "time": 2}
    assert pmh.make_mesh(devices=devs).shape == {"ch": 1, "time": 8}
    with pytest.raises(ValueError, match="do not split"):
        pmh.make_mesh(time_per_host=3, devices=devs)


def test_mesh_grid_and_errors():
    m = Mesh(np.array(["cpu:0", "cpu:1", "cpu:2", "cpu:3", "cpu:4", "cpu:5"],
                      dtype=object).reshape(2, 3), ("time", "ch"))
    assert m.shape == {"time": 2, "ch": 3} and m.size == 6
    g = m.grid("time", "ch")              # channel rows, time across
    assert g.shape == (3, 2)
    assert [str(d) for d in g[1]] == ["cpu:1", "cpu:4"]
    assert [str(d) for d in m.grid("ch")[0]] == ["cpu:0", "cpu:1", "cpu:2"]
    with pytest.raises(ValueError, match="have no"):
        m.grid("x")
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu"] * 2, ("a", "b"))


# --- K6's plain version against lax.ppermute --------------------------------


@pytest.mark.parametrize("shape,names", [((S,), ("time",)),
                                         ((2, S), ("ch", "time"))])
def test_halo_plain_matches_ppermute(shape, names):
    """Shard k receives shard k-1's tail along ``time``, within each row of
    the grid; shard 0 receives zeros (not the ring's wrap)."""
    halo, seg, c = 37, 100, 3
    rng = np.random.default_rng(5)
    b = shape[0] if len(shape) == 2 else 1
    x = rng.standard_normal((b * c, S * seg)).astype(np.float32)

    mesh = _jmesh(shape, names)
    spec = P("ch", "time") if len(shape) == 2 else P(None, "time")

    @functools.partial(shard_map, mesh=mesh, in_specs=spec, out_specs=spec,
                       check_vma=False)
    def shift(xl):
        return lax.ppermute(xl[..., -halo:], "time",
                            [(i, i + 1) for i in range(S - 1)])

    want = np.asarray(shift(jax.device_put(jnp.asarray(x),
                                           NamedSharding(mesh, spec))))
    # the port: one [halo | segment] buffer per grid cell
    bufs = [[torch.zeros((c, halo + seg)) for _ in range(S)]
            for _ in range(b)]
    for r in range(b):
        for k in range(S):
            bufs[r][k][:, halo:] = torch.from_numpy(
                x[r * c:(r + 1) * c, k * seg:(k + 1) * seg])
    phalo.halo_shift_right(bufs, halo)
    got = np.concatenate([np.concatenate([np_of(bufs[r][k][:, :halo])
                                          for k in range(S)], axis=-1)
                          for r in range(b)])
    np.testing.assert_array_equal(got, want)
    assert not got[:, :halo].any()
    # the plain version over one row, 1-D tails
    tails = [torch.from_numpy(x[0, (k + 1) * seg - halo:(k + 1) * seg])
             for k in range(S)]
    plain = phalo.halo_shift_right_plain(tails)
    np.testing.assert_array_equal(np.concatenate([np_of(t) for t in plain]),
                                  want[0])


def test_halo_counts_no_launch_on_cpu():
    before = phalo.halo_shift_right.launches
    phalo.halo_shift_right([[torch.ones(8), torch.ones(8)]], 4)
    assert phalo.halo_shift_right.launches == before


@pytest.mark.parametrize("bad", ["dtype", "stride", "mix", "halo", "shape"])
def test_halo_rejects_bad_buffers(bad):
    ok = [torch.zeros(2, 16), torch.zeros(2, 16)]
    rows, halo, err = [ok], 4, ValueError
    if bad == "dtype":
        rows, err = [[ok[0], torch.zeros(2, 16, dtype=torch.float64)]], \
            TypeError
    elif bad == "stride":
        rows = [[ok[0], torch.zeros(16, 2).t()]]
    elif bad == "mix":
        rows = [[ok[0], torch.zeros(2, 16, device="meta")]]
    elif bad == "halo":
        halo = 9                  # longer than the segment (16 - 9)
    else:
        rows = [[ok[0], torch.zeros(3, 16)]]
    with pytest.raises(err):
        phalo.halo_shift_right(rows, halo)


# --- kernel choice from the global shape ------------------------------------


def test_fused_mixer_pinned_from_global_shape(monkeypatch):
    """C=64 stations x S=8 shards x 2 arms is 1,024 lanes on one device,
    but the global shape (C=64, 2 arms: 128 lanes) takes K2, as the
    contiguous run of the same batch does."""
    calls = {"angles": 0, "mixer": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(pll_cuda, "pll_block_fused_kernel",
                        spy("angles", pll_cuda.pll_block_fused_kernel))
    monkeypatch.setattr(pll_cuda, "pll_mixer_fused_kernel",
                        spy("mixer", pll_cuda.pll_mixer_fused_kernel))
    rng = np.random.default_rng(2)
    iq = rng.uniform(-1, 1, (64, 8 * BLOCK_RAW)).astype(np.float32)
    mesh = _pmesh((1, 8), ("ch", "time"))
    out = pts.time_sharded_receive(iq, mesh, 0, True, True, batch_axis="ch",
                                   overlap_if=BLOCK_IF, block_if=BLOCK_IF)
    assert calls == {"angles": 2, "mixer": 0}     # warm-up + one block
    assert out.left.shape == (64, 8 * BLOCK_IF // MC.audio_decim)
    assert np.isfinite(np_of(out.left)).all()
