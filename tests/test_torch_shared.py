"""The port's own copies of the JAX package's numpy modules against the
originals, and the port's entry points defaulting to the card.

``sdr_tpu_torch`` imports nothing of ``sdr_tpu``: it keeps copies of
``config``, ``golden.filters``, ``golden.rds``, ``io`` and ``utils.synth``
and its own binding of the shared C++ runtime.  Each copy must behave as
its original, so every comparison here is exact: configs field by field,
filter taps, the RDS decode of one synthesized station, synthesized I/Q
from one seed, and ``io``'s conversions.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sdr_tpu import config as jcfg
from sdr_tpu import io as jio
from sdr_tpu.golden import filters as jfilt
from sdr_tpu.golden import rds as jgrds
from sdr_tpu.models import rds_decode as jrds
from sdr_tpu.utils import synth as jsynth

import sdr_tpu_torch
from sdr_tpu_torch import config as pcfg
from sdr_tpu_torch import io as pio
from sdr_tpu_torch.golden import filters as pfilt
from sdr_tpu_torch.golden import rds as pgrds
from sdr_tpu_torch.models import rds_decode as prds
from sdr_tpu_torch.models import receiver as prx
from sdr_tpu_torch.models.channelizer import Channelizer
from sdr_tpu_torch.parallel import mesh as pmesh
from sdr_tpu_torch.parallel import multihost as pmh
from sdr_tpu_torch.utils import synth as psynth

CUSTOM = dict(rf_fs=1.44e6, if_fs=240e3, audio_fs=32e3,
              rds=None, rf_taps=101)


# --- config -----------------------------------------------------------------


@pytest.mark.parametrize("mode", [0, 1, 2, 3, "custom"])
def test_configs_agree_field_by_field(mode):
    if mode == "custom":
        p, j = pcfg.custom_mode(**CUSTOM), jcfg.custom_mode(**CUSTOM)
    else:
        p, j = pcfg.get_mode_config(mode), jcfg.get_mode_config(mode)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    for prop in ("audio_taps", "audio_lpf_fs", "audio_out_per_if"):
        assert getattr(p, prop) == getattr(j, prop), prop
    for rds in (False, True):
        assert p.if_block_multiple(rds) == j.if_block_multiple(rds)
        assert p.default_block_size(rds) == j.default_block_size(rds)
    if p.rds is not None:
        assert (p.rds.resampler_taps, p.rds.symbol_fs) == (
            j.rds.resampler_taps, j.rds.symbol_fs)


def test_config_constants_agree():
    names = [n for n in vars(jcfg) if n.isupper() and not n.startswith("_")]
    assert names
    for n in names:
        assert getattr(pcfg, n) == getattr(jcfg, n), n


# --- filters ----------------------------------------------------------------


@pytest.mark.parametrize("taps,fs", [(151, 2.4e6), (101, 240e3),
                                     (24947, 240e3 * 247)])
def test_filter_taps_bit_equal(taps, fs):
    np.testing.assert_array_equal(pfilt.lowpass_taps(taps, fs, 16e3),
                                  jfilt.lowpass_taps(taps, fs, 16e3))
    np.testing.assert_array_equal(
        pfilt.bandpass_taps(taps, fs, 18.5e3, 19.5e3),
        jfilt.bandpass_taps(taps, fs, 18.5e3, 19.5e3))
    for up in (1, 147, 247):
        assert pfilt.resample_state_len(taps, up) == \
            jfilt.resample_state_len(taps, up)


@pytest.mark.parametrize("sps", [26, 43])
def test_rrc_taps_bit_equal(sps):
    np.testing.assert_array_equal(pfilt.rrc_taps(sps * 2375.0, 101),
                                  jfilt.rrc_taps(sps * 2375.0, 101))


# --- RDS --------------------------------------------------------------------


def _rds_symbols(seed: int, sps: int) -> np.ndarray:
    """Soft symbols of one synthesized station: its framed bits,
    differentially and Manchester coded, held for ``sps`` samples each,
    with noise and a fractional start."""
    station = jsynth.StationConfig(pi=0x54B1, pty=9, ps="CUDA FM ",
                                   radiotext="HELLO H100", tp=True)
    _, framed = jsynth.rds_encode_station(station, 24)
    sym = jsynth.manchester_encode(jsynth.diff_encode(framed))
    rng = np.random.default_rng(seed)
    x = np.repeat(sym.astype(np.float64), sps)[sps // 3:]
    return (x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32)


@pytest.mark.parametrize("ec", [False, True])
def test_rds_decode_of_a_station_equal(ec):
    sps = pcfg.get_mode_config(0).rds.sps
    x = _rds_symbols(5, sps)
    p = prds.decode_robust(x, sps, error_correction=ec)
    j = jrds.decode_robust(x, sps, error_correction=ec)
    assert len(p.frames.matches) > 20
    assert p.frames.matches == j.frames.matches
    np.testing.assert_array_equal(p.info_words, j.info_words)
    np.testing.assert_array_equal(p.bits, j.bits)
    assert p.n_corrected == j.n_corrected


def test_rds_golden_chain_equal():
    sps = pcfg.get_mode_config(2).rds.sps
    x = _rds_symbols(6, sps)
    pb, ps = pgrds.cdr(x, sps, pgrds.CdrState(), 0)
    jb, js = jgrds.cdr(x, sps, jgrds.CdrState(), 0)
    np.testing.assert_array_equal(pb, jb)
    assert dataclasses.asdict(ps) == dataclasses.asdict(js)
    bits = pgrds.diff_decode(np.asarray(pb))
    np.testing.assert_array_equal(bits, jgrds.diff_decode(np.asarray(jb)))
    assert pgrds.frame_sync(bits).matches == jgrds.frame_sync(bits).matches
    np.testing.assert_array_equal(pgrds.PARITY_MATRIX, jgrds.PARITY_MATRIX)
    assert pgrds.SYNDROMES.keys() == jgrds.SYNDROMES.keys()
    for k in jgrds.SYNDROMES:
        np.testing.assert_array_equal(pgrds.SYNDROMES[k], jgrds.SYNDROMES[k])


# --- synth ------------------------------------------------------------------


def test_synth_fm_bit_equal():
    kw = dict(duration_s=0.03, mode=0, seed=9, with_rds=True, noise_std=0.05)
    p, j = psynth.synthesize_fm(**kw), jsynth.synthesize_fm(**kw)
    np.testing.assert_array_equal(p.iq_u8, j.iq_u8)
    np.testing.assert_array_equal(p.rds_info_bits, j.rds_info_bits)
    np.testing.assert_array_equal(p.rds_frame_bits, j.rds_frame_bits)
    np.testing.assert_array_equal(psynth.u8_to_float(p.iq_u8),
                                  jsynth.u8_to_float(j.iq_u8))


def test_synth_wideband_and_station_bit_equal():
    kw = dict(duration_s=0.01, fs_wide=9.6e6, offsets_hz=[-1.5e6, 2e6],
              seed=4)
    np.testing.assert_array_equal(psynth.synthesize_wideband(**kw).iq_u8,
                                  jsynth.synthesize_wideband(**kw).iq_u8)
    st = dict(pi=0x1234, pty=3, ps="PORT", radiotext="RT", tp=False)
    for version_b in (False, True):
        pi, pf = psynth.rds_encode_station(psynth.StationConfig(**st), 8,
                                           version_b=version_b)
        ji, jf = jsynth.rds_encode_station(jsynth.StationConfig(**st), 8,
                                           version_b=version_b)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pf, jf)


# --- io ---------------------------------------------------------------------


def test_io_conversions_equal():
    rng = np.random.default_rng(3)
    x = rng.uniform(-3, 3, 4001).astype(np.float32)
    x[::97] = np.nan
    np.testing.assert_array_equal(pio.pcm_quantize(x), jio.pcm_quantize(x))
    stereo = x[:4000].reshape(2000, 2)
    np.testing.assert_array_equal(pio.pcm_quantize(stereo),
                                  jio.pcm_quantize(stereo))
    raw = rng.integers(0, 256, 4096, dtype=np.uint8)
    np.testing.assert_array_equal(pio.u8_normalize(raw),
                                  jio.u8_normalize(raw))


# --- entry points default to the card ---------------------------------------


@pytest.fixture
def no_cuda(monkeypatch):
    """torch as built for the CPU only."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_to_run_on_cpu_by_default(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prx.Receiver(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Channelizer([-1.5e6, 2e6], 9.6e6, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sdr_tpu_torch.receive(np.zeros(115_200, np.uint8), mode=0)
    with pytest.raises(RuntimeError):
        pmesh.local_devices()
    with pytest.raises(RuntimeError):
        pmh.make_mesh()


def test_entry_points_run_on_cpu_when_asked(no_cuda):
    assert prx.Receiver(0, device="cpu").device.type == "cpu"
    assert Channelizer([0.0], 9.6e6, 0, device="cpu").device.type == "cpu"
    m = pmh.make_mesh(devices=["cpu"] * 4)
    assert m.shape == {"ch": 1, "time": 4}
