"""The port's receiver in modes 1, 2 and 3 and a custom mode against the
JAX package's, on raw u8 and on float input, two chained blocks each.

Stereo in every mode, and stereo+RDS in mode 2 (the 147/800 audio
resampler with the RDS arms).  The custom mode (1.44 MS/s RF, 240 kS/s IF,
32 kHz audio) has RF decimation 6 and a 2/15 audio resampler.

Which JAX selection each input is held against:

* u8 input: ``mxu_fir=False``, the JAX package's exact fp32 normalize
  (its CPU default).  Not the TPU's u8 front-ends (``mxu_fir=True``, with
  or without ``pallas_frontend``): in block 0, while the RF FIR warms up,
  the signal power is near zero and the quadrature demod amplifies their
  bf16 hi/lo weight-split error, up to 1.7e-3 on fm_demod (mode 1) where
  the port, in full fp32, stays within 5e-5 of the exact path.
* float input: the JAX default (XLA FIR) and ``pallas_frontend=True,
  mxu_fir=False``, its K5 kernel (Pallas, interpreted), the counterpart of
  the port's K5 front-end.

Tolerances are those of tests/test_models_receiver.py: 2e-4 on fm_demod
and mono, 5e-3 on the PLL-driven arms; the RF tails must be equal.  Then
block-size invariance and batch consistency in that file's style.
"""

import numpy as np
import pytest
import torch

from torch_parity import assert_close, run_both, run_port

from sdr_tpu import config as cfg
from sdr_tpu.utils import synth
from sdr_tpu_torch.models import receiver as prx
from sdr_tpu_torch.ops import fir_decim

CUSTOM = cfg.custom_mode(rf_fs=1.44e6, if_fs=240e3, audio_fs=32e3)
MODES = {1: cfg.get_mode_config(1), 2: cfg.get_mode_config(2),
         3: cfg.get_mode_config(3), "custom": CUSTOM}


def _capture(name, n_bytes: int, seed: int = 7) -> np.ndarray:
    """A synthesized stereo (and, in mode 2, RDS) station, raw u8."""
    mc = MODES[name]
    if name != "custom":
        return synth.synthesize_fm(duration_s=n_bytes / 2 / mc.rf_fs,
                                   mode=name, seed=seed,
                                   with_rds=mc.rds is not None).iq_u8
    # synthesize_fm takes only the four modes: the same multiplex and
    # FM modulation at the custom rate
    n = n_bytes // 2
    mpx = synth._build_multiplex(n / mc.rf_fs, mc.rf_fs, mc,
                                 np.random.default_rng(seed), 800.0, 1500.0,
                                 True, False, 0.0)[0][:n]
    phase = 2 * np.pi * 75e3 * np.cumsum(mpx) / mc.rf_fs
    iq = np.empty(2 * n)
    iq[0::2], iq[1::2] = np.cos(phase), np.sin(phase)
    return np.clip(np.round(iq * 127.0 + 128.0), 0, 255).astype(np.uint8)


def _float(iq_u8: np.ndarray) -> np.ndarray:
    return (iq_u8.astype(np.float32) - 128.0) / 128.0


@pytest.mark.parametrize("name", [1, 2, 3, "custom"])
@pytest.mark.parametrize("dtype", ["u8", "float"])
def test_mode_two_blocks(name, dtype):
    mc = MODES[name]
    with_rds = mc.rds is not None
    bs = mc.default_block_size(with_rds)
    iq = _capture(name, 2 * bs)
    if dtype == "u8":
        jsels = [dict(mxu_fir=False)]
    else:
        iq = _float(iq)
        jsels = [{}, dict(pallas_frontend=True, mxu_fir=False)]
    port = run_port(iq, 2, bs, True, with_rds, mc=mc)
    if with_rds:
        assert port[0][0].rds_symbols.shape[-1] > 0
    for jsel in jsels:
        run_both(iq, 2, bs, True, with_rds, jsel, {}, mc=mc, port=port)


def test_block_size_invariance():
    """Mode 1 stereo, float input through K5: one double block equals two
    blocks (the overlap-save carries), as tests/test_models_receiver.py
    holds the JAX receiver."""
    mc = MODES[1]
    bs = mc.default_block_size()
    iq = _float(_capture(1, 2 * bs))
    small = run_port(iq, 2, bs, True, False, mc=mc)
    big = run_port(iq, 1, 2 * bs, True, False, mc=mc)
    left = torch.cat([o.left for o, _ in small])
    assert_close(big[0][0].left, left, 1e-4)
    for f in ("rf_i", "rf_q", "stereo_fir"):
        assert_close(getattr(big[0][1], f), getattr(small[1][1], f), 1e-6)


def test_batch_rows_match_single():
    """Mode 3 stereo, float input: each row of a (2, N) batch equals its
    own single-channel run."""
    mc = MODES[3]
    bs = mc.default_block_size()
    iq = np.stack([_float(_capture(3, bs, seed=s)) for s in (1, 2)])
    rows = run_port(iq, 1, bs, True, False, batch=(2,), mc=mc)[0][0]
    for k in range(2):
        one = run_port(iq[k], 1, bs, True, False, mc=mc)[0][0]
        for f in ("fm_demod", "mono", "left", "right"):
            assert_close(getattr(rows, f)[k], getattr(one, f), 1e-5, f)


def test_float_input_reaches_k5(monkeypatch):
    """Float input goes through K5's wrapper (u8 stays on K1's)."""
    calls = []
    real = fir_decim.fir_block_decim

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(fir_decim, "fir_block_decim", spy)
    mc = MODES["custom"]
    bs = mc.default_block_size()
    x = torch.from_numpy(_float(_capture("custom", bs)))
    prx.process_block(x, prx.design_coeffs(mc), prx.init_state(mc), mc,
                      False, False)
    assert calls == [(2, bs // 2)]
