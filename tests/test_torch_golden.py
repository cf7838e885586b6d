"""The port's float64 golden receiver against the JAX package's, and the
port's receiver against it.

``sdr_tpu_torch.golden`` keeps its own copies of ``sdr_tpu.golden``'s
demod, PLL, spectrum and receiver modules, so that the receiver on the
card can be held to a float64 oracle on a machine without JAX
(``chip_smoke.py`` phase 6).  Two layers:

* the copies are exact: the same seeded inputs through both packages give
  equal arrays (``np.array_equal``), function by function and for
  ``receiver.run_file`` over 2-3 blocks of every mode (stereo; with RDS in
  modes 0 and 2), every output of every block and the final carries;
* the port's ``Receiver(device="cpu")`` against the port's golden
  receiver, the counterpart of ``tests/test_models_receiver.py``'s
  ``TestParityVsGolden`` in each mode, at the JAX package's tolerances:
  2e-4 on fm_demod and mono, 5e-3 on the PLL-driven left, right and
  rds_symbols.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sdr_tpu import config as jcfg
from sdr_tpu import golden as jgolden
from sdr_tpu.golden import demod as jdemod
from sdr_tpu.golden import pll as jpll
from sdr_tpu.golden import receiver as jgrx
from sdr_tpu.golden import spectrum as jspec

from sdr_tpu_torch import config as pcfg
from sdr_tpu_torch import golden as pgolden
from sdr_tpu_torch.golden import demod as pdemod
from sdr_tpu_torch.golden import pll as ppll
from sdr_tpu_torch.golden import receiver as pgrx
from sdr_tpu_torch.golden import spectrum as pspec
from sdr_tpu_torch.models import receiver as prx
from sdr_tpu_torch.utils import synth

torch.set_num_threads(1)

LINEAR_ATOL = 2e-4      # fm_demod, mono
PLL_ATOL = 5e-3         # left, right, rds_symbols
ARMS = ("fm_demod", "mono", "left", "right", "rds_symbols")
# mode -> (with RDS, blocks): stereo in every mode, RDS where the JAX
# package's receiver parity and the modes' RDS tables put it
CASES = {0: (True, 3), 1: (False, 3), 2: (True, 2), 3: (False, 3)}


@pytest.fixture(scope="module")
def captures():
    """mode -> (float I/Q of the case's blocks, raw u8, block size)."""
    out = {}
    for mode, (rds, n) in CASES.items():
        mc = pcfg.get_mode_config(mode)
        bs = mc.default_block_size(rds)
        res = synth.synthesize_fm(duration_s=(n + 0.5) * bs / 2 / mc.rf_fs,
                                  mode=mode, with_stereo=True, with_rds=rds,
                                  seed=6 + mode)
        u8 = res.iq_u8[:n * bs]
        out[mode] = (synth.u8_to_float(u8), u8, bs)
    return out


@pytest.fixture(scope="module")
def golden_outs(captures):
    """mode -> the port's golden ``run_file`` outputs."""
    return {mode: pgrx.run_file(captures[mode][0],
                                pcfg.get_mode_config(mode), stereo=True,
                                with_rds=CASES[mode][0],
                                block_size=captures[mode][2])
            for mode in CASES}


# --- the copies are exact -------------------------------------------------


def test_exports_match():
    names = [n for n in dir(jgolden) if not n.startswith("_")
             and not isinstance(getattr(jgolden, n), type(jgolden))]
    assert names
    for n in names:
        assert hasattr(pgolden, n), n


def test_demod_equal():
    rng = np.random.default_rng(1)
    i, q = rng.standard_normal((2, 4000))
    i[17] = q[17] = 0.0                     # the zero-power guard
    prev = rng.standard_normal(2)
    for a, b in zip(pdemod.fm_demod_quad(i, q, prev),
                    jdemod.fm_demod_quad(i, q, prev)):
        assert np.array_equal(a, b)
    pa = pdemod.fm_demod_arctan(i, q, 0.3)
    ja = jdemod.fm_demod_arctan(i, q, 0.3)
    assert np.array_equal(pa[0], ja[0]) and pa[1] == ja[1]


@pytest.mark.parametrize("kw", [
    dict(freq=19e3, fs=240e3, nco_scale=2.0),
    dict(freq=114e3, fs=240e3, nco_scale=0.5, phase_adjust=3 * np.pi / 8,
         norm_bandwidth=0.002)])
def test_pll_equal(kw):
    rng = np.random.default_rng(2)
    t = np.arange(3000) / kw["fs"]
    x = np.cos(2 * np.pi * kw["freq"] * t + 0.4) \
        + 0.1 * rng.standard_normal(t.size)
    p_state, j_state = ppll.PllState(nco_q_last=0.0), jpll.PllState(
        nco_q_last=0.0)
    for blk in np.split(x, 3):                      # carried over blocks
        pi, pq, p_state = ppll.fm_pll(blk, state=p_state, **kw)
        ji, jq, j_state = jpll.fm_pll(blk, state=j_state, **kw)
        assert np.array_equal(pi, ji) and np.array_equal(pq, jq)
        assert dataclasses.asdict(p_state) == dataclasses.asdict(j_state)
    assert dataclasses.asdict(p_state.copy()) == dataclasses.asdict(p_state)


def test_spectrum_equal():
    rng = np.random.default_rng(3)
    x = rng.standard_normal(64)
    assert np.array_equal(pspec.dft(x), jspec.dft(x))
    assert np.array_equal(pspec.idft(x + 1j * x), jspec.idft(x + 1j * x))
    assert np.array_equal(pspec.hann_sin2(100), jspec.hann_sin2(100))
    y = rng.standard_normal(5000)
    for a, b in zip(pspec.estimate_psd(y, 512, 240e3),
                    jspec.estimate_psd(y, 512, 240e3)):
        assert np.array_equal(a, b)


def _equal_trees(a, b, where: str) -> None:
    """Dataclass trees of numpy arrays and numbers equal, leaf by leaf."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _equal_trees(getattr(a, f.name), getattr(b, f.name),
                         f"{where}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("mode", list(CASES))
def test_design_and_init_equal(mode):
    p, j = pcfg.get_mode_config(mode), jcfg.get_mode_config(mode)
    _equal_trees(pgrx.design_coeffs(p), jgrx.design_coeffs(j), "coeffs")
    _equal_trees(pgrx.init_state(p), jgrx.init_state(j), "state")


@pytest.mark.parametrize("mode", list(CASES))
def test_run_file_equal(mode, captures, golden_outs):
    """Every output of every block (RDS bits and frame matches included)
    and the carries after the last block."""
    iq, _, bs = captures[mode]
    rds = CASES[mode][0]
    jouts = jgrx.run_file(iq, jcfg.get_mode_config(mode), stereo=True,
                          with_rds=rds, block_size=bs)
    assert len(golden_outs[mode]) == len(jouts) == CASES[mode][1]
    for b, (p, j) in enumerate(zip(golden_outs[mode], jouts)):
        _equal_trees(p, j, f"block {b}")
    # the carries, one block further by hand
    pc, jc = (pgrx.design_coeffs(pcfg.get_mode_config(mode)),
              jgrx.design_coeffs(jcfg.get_mode_config(mode)))
    ps, js = (pgrx.init_state(pcfg.get_mode_config(mode)),
              jgrx.init_state(jcfg.get_mode_config(mode)))
    for b in range(2):
        blk = iq[b * bs:(b + 1) * bs]
        _, ps = pgrx.process_block(blk, pc, ps, pcfg.get_mode_config(mode),
                                   stereo=True, with_rds=rds, block_count=b)
        _, js = jgrx.process_block(blk, jc, js, jcfg.get_mode_config(mode),
                                   stereo=True, with_rds=rds, block_count=b)
    _equal_trees(ps, js, "state")


# --- the port's receiver against the port's golden --------------------------


@pytest.mark.parametrize("kind", ["float", "u8"])
@pytest.mark.parametrize("mode", list(CASES))
def test_receiver_matches_golden(mode, kind, captures, golden_outs):
    """``Receiver(device="cpu")`` block by block against ``run_file`` on
    the float input, for float and raw u8 input (K5's and K1's plain
    versions)."""
    iq, u8, bs = captures[mode]
    rds = CASES[mode][0]
    x = iq if kind == "float" else u8
    r = prx.Receiver(mode, stereo=True, with_rds=rds, device="cpu")
    arms = ARMS if rds else ARMS[:4]
    for b, g in enumerate(golden_outs[mode]):
        out = r.process(x[b * bs:(b + 1) * bs])
        for arm in arms:
            np.testing.assert_allclose(
                getattr(out, arm).numpy(), getattr(g, arm), rtol=0,
                atol=LINEAR_ATOL if arm in ("fm_demod", "mono") else PLL_ATOL,
                err_msg=f"block {b} {arm}")


@pytest.mark.parametrize("mode", [1, 3])
def test_mono_receiver_matches_golden(mode, captures):
    """Mono only (no PLL), as ``TestParityVsGolden`` checks it."""
    iq, _, bs = captures[mode]
    mc = pcfg.get_mode_config(mode)
    gouts = pgrx.run_file(iq, mc, stereo=False, block_size=bs)
    r = prx.Receiver(mode, stereo=False, device="cpu")
    for b, g in enumerate(gouts):
        out = r.process(iq[b * bs:(b + 1) * bs])
        np.testing.assert_allclose(out.mono.numpy(), g.mono, rtol=0,
                                   atol=LINEAR_ATOL)
