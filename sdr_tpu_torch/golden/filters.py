"""Golden filter design + stateful streaming convolution (numpy, vectorized).

Reference semantics reproduced (with citations):

* ``lowpass_taps``    — sin^2-windowed sinc LPF, model/fmSupportLib.py:376-385
  (identical math to the C++ impulseResponseLPF, src/filter.cpp:103-114).
* ``bandpass_taps``   — windowed-sinc BPF via cosine modulation,
  model/fmSupportLib.py:358-371.
* ``rrc_taps``        — root-raised-cosine, T=1/2375, beta=0.90,
  model/fmSupportLib.py:251-287.
* ``block_fir*``      — overlap-save streaming FIR with a ``taps-1`` input
  tail as the inter-block state, matching convolveBlockFastFIR
  (src/filter.cpp:158-188) and convolveBlockResampleFIR
  (model/fmSupportLib.py:388-406).  The resampler applies the Python model's
  xU passband gain; the C++ x(U+1) variant (src/filter.cpp:213) is a
  documented C++/Python divergence (SURVEY.md section 2.5) that we do NOT
  reproduce.
* ``allpass_delay``   — pure (taps-1)/2-sample delay line,
  model/fmSupportLib.py:291-295.

All kernels are written as vectorized numpy (no per-sample Python loops) but
keep bit-for-bit the same arithmetic *definition* as the reference loops.

The port's own copy of ``sdr_tpu/golden/filters.py``, behaviour
unchanged, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Coefficient design
# ---------------------------------------------------------------------------

def _sin2_window(n_taps: int) -> np.ndarray:
    """The reference's sin^2(pi i / N) window (a Hann variant)."""
    i = np.arange(n_taps, dtype=np.float64)
    return np.sin(i * np.pi / n_taps) ** 2


def lowpass_taps(n_taps: int, fs: float, fc: float) -> np.ndarray:
    """Windowed-sinc low-pass FIR (ref: model/fmSupportLib.py:376-385)."""
    norm_fc = fc / (fs / 2.0)
    mid = (n_taps - 1) / 2.0
    i = np.arange(n_taps, dtype=np.float64)
    x = np.pi * norm_fc * (i - mid)
    with np.errstate(invalid="ignore"):
        h = norm_fc * np.sin(x) / x
    h = np.where(i == mid, norm_fc, h)
    return h * _sin2_window(n_taps)


def bandpass_taps(n_taps: int, fs: float, fb: float, fe: float) -> np.ndarray:
    """Windowed-sinc band-pass FIR (ref: model/fmSupportLib.py:358-371)."""
    norm_center = ((fe + fb) / 2.0) / (fs / 2.0)
    norm_pass = (fe - fb) / (fs / 2.0)
    mid = (n_taps - 1) / 2.0
    i = np.arange(n_taps, dtype=np.float64)
    x = np.pi * norm_pass / 2.0 * (i - mid)
    with np.errstate(invalid="ignore"):
        h = norm_pass * np.sin(x) / x
    h = np.where(i == mid, norm_pass, h)
    h = h * np.cos(i * np.pi * norm_center)
    return h * _sin2_window(n_taps)


def rrc_taps(fs: float, n_taps: int, beta: float = 0.90,
             symbol_rate: float = 2375.0) -> np.ndarray:
    """Root-raised-cosine pulse (ref: model/fmSupportLib.py:251-287).

    ``fs`` must be an integer multiple of the symbol rate (SPS * 2375 for
    RDS).  The 1/T_symbol scale factor is omitted, as in the reference.
    """
    t_sym = 1.0 / symbol_rate
    k = np.arange(n_taps, dtype=np.float64)
    t = (k - n_taps / 2.0) / fs

    num = (np.sin(np.pi * t * (1 - beta) / t_sym)
           + 4 * beta * (t / t_sym) * np.cos(np.pi * t * (1 + beta) / t_sym))
    den = np.pi * t * (1 - (4 * beta * t / t_sym) ** 2) / t_sym
    with np.errstate(invalid="ignore", divide="ignore"):
        h = num / den

    # singular points — exact float comparison like the reference
    # (model/fmSupportLib.py:278-281); with odd taps and N/2 centering the
    # grid never actually hits t == 0, which we preserve.
    h = np.where(t == 0.0, 1.0 + beta * (4 / np.pi - 1.0), h)
    t_sing = t_sym / (4 * beta)
    edge = (beta / np.sqrt(2.0)) * (
        (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
        + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
    h = np.where((t == t_sing) | (t == -t_sing), edge, h)
    return h


# ---------------------------------------------------------------------------
# Streaming FIR kernels — overlap-save with explicit state
# ---------------------------------------------------------------------------

def fir_full(h: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Single-pass full convolution, len(x)+len(h)-1 output
    (ref: src/filter.cpp:118-130, model/fmSupportLib.py:431-437)."""
    return np.convolve(x, h)


def block_fir(x: np.ndarray, h: np.ndarray,
              state: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Streaming FIR: y[n] = sum_k h[k] * xc[n + K-1 - k] with
    xc = [state, x]; state is the trailing K-1 input samples
    (ref: src/filter.cpp:133-154, model/fmSupportLib.py:440-463)."""
    return block_fir_decim(x, h, state, 1)


def block_fir_decim(x: np.ndarray, h: np.ndarray, state: np.ndarray,
                    decim: int) -> tuple[np.ndarray, np.ndarray]:
    """Streaming decimating FIR (ref: src/filter.cpp:158-188).

    Output j is the causal convolution evaluated at input index j*decim.
    ``len(x)`` must be a multiple of ``decim``.
    """
    k = len(h)
    assert len(state) == k - 1, (len(state), k)
    assert len(x) % decim == 0
    xc = np.concatenate([state, x])
    # y[j] = sum_n h[n] * xc[K-1 + j*decim - n]  ==  correlate(xc, h[::-1])
    y = np.convolve(xc, h, mode="valid")[::decim]
    new_state = xc[len(xc) - (k - 1):].copy()
    return y, new_state


def resample_state_len(n_taps: int, upsamp: int) -> int:
    """Natural-domain state length for the polyphase resampler:
    ceil(n_taps / upsamp) - 1 past input samples."""
    return -(-n_taps // upsamp) - 1


def block_fir_resample(x: np.ndarray, h: np.ndarray, state: np.ndarray,
                       decim: int, upsamp: int) -> tuple[np.ndarray, np.ndarray]:
    """Streaming polyphase rational resampler (xU then FIR then /D).

    Matches model/fmSupportLib.py:388-406 exactly (including the xU passband
    gain), but the inter-block state is kept in the *natural* input domain:
    the last ``ceil(K/U)-1`` raw input samples, which is the information the
    reference's upsampled-domain state vector actually carries (only its
    indices == U-1 (mod U) are ever written/read, src/filter.cpp:218-222).

    Definition: with xu the zero-stuffed upsampled stream of [state_tail, x],
        y[j] = U * sum_n h[n] * xu[j*D + U*(T-1) - n],  T = ceil(K/U)
    for j in range(len(x)*U // D).
    """
    k = len(h)
    t = -(-k // upsamp)  # taps per phase
    assert len(state) == t - 1, (len(state), t)
    n_out = len(x) * upsamp // decim
    assert n_out * decim == len(x) * upsamp, "block length must divide evenly"

    xc = np.concatenate([state, x])
    # Build an index/coefficient formulation: for output j,
    #   m = j*D (position on the upsampled grid of x alone)
    #   phase p = m % U; natural start index q = (m - p)//U + (T-1)
    #   y[j] = U * sum_{r=0..T-1, n=p+r*U < K} h[p + r*U] * xc[q - r]
    j = np.arange(n_out)
    m = j * decim
    p = m % upsamp
    q = (m - p) // upsamp + (t - 1)
    r = np.arange(t)
    n_idx = p[:, None] + r[None, :] * upsamp           # (n_out, T) tap index
    valid = n_idx < k
    hsel = np.where(valid, h[np.minimum(n_idx, k - 1)], 0.0)
    xsel = xc[q[:, None] - r[None, :]]
    y = upsamp * np.sum(hsel * xsel, axis=1)
    new_state = xc[len(xc) - (t - 1):].copy() if t > 1 else xc[:0]
    return y, new_state


def allpass_delay(x: np.ndarray,
                  state: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pure delay of len(state) samples — the reference's 'all-pass' used to
    phase-match the mono arm against the band-pass arms
    (ref: model/fmSupportLib.py:291-295, src/filter.cpp:14-29)."""
    d = len(state)
    y = np.concatenate([state, x[: len(x) - d]])
    new_state = x[len(x) - d:].copy()
    return y, new_state
