"""The plain reference: the FM receiver in float64 numpy, block by block.

A frozen copy of the port's float64 golden chain at commit 31744bf
(``sdr_tpu_torch/golden/filters.py``, ``demod.py``, ``pll.py`` and
``receiver.py::process_block`` up to the RDS matched filter; the symbol
decoder after it runs on the host and is not compared).  It reads the
mode from the configuration file, designs every filter itself and starts
from a zero state, so that it takes nothing that the program made: only
the same input bytes.  It imports numpy alone.

The pilot PLL's detector ``atan2(-v q, v i)`` turns half a circle with
the sign of its input ``v``, and where ``v`` passes within float32's
rounding of zero a sound float32 receiver may take that decision the
other way.  So the reference also returns, per row, a branch for each
such decision: ``|v[n]| < TAU * s[n]``, where ``s[n] = sum_k |h[k]|
|fm[n-k]|`` is the scale on which ``v`` is rounded (the same
overlap-save state as ``v``).  A branch is the same recurrence with that
one decision taken the other way (``v[n]``'s sign flipped for the
detector alone), rerun from the state saved at the start of its block
and followed until it has locked back onto the base run (``left`` and
``right`` within ``LOCKED`` of their peak for a whole block) or to the
row's last block; at most ``MAX_BRANCHES`` a row, those with the
smallest ``|v|/s``.  The RDS PLL is not branched.

The PLL is a per-sample Python loop, the literal atan2 recurrence, so a
block costs tens of milliseconds: :func:`run_rows` spreads the compared
rows over worker processes, each a plain child started and waited for
(``python3 -P -c`` on :func:`_worker`, its row in and its arms out as
pickles over pipes).  A ``multiprocessing`` pool is not used: its
resource tracker outlives the pool and even the process that started it.
"""

from __future__ import annotations

import concurrent.futures
import math
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

ARMS = ("fm_demod", "mono", "left", "right", "rds_symbols")
#: the arms that the pilot PLL feeds, which a branch carries
PILOT_ARMS = ("left", "right")

#: a pilot decision is ambiguous where |v| < TAU * s: 4x the widest
#: |v32 - v64| / s that the program's own pilot input read on the card,
#: rounded up to a power of two (``calibrate.py --pilot-input``)
TAU = 2.0 ** -11
#: the most branches followed in a row (the smallest |v| / s first)
MAX_BRANCHES = 8
#: a branch has locked back onto the base run once, for a whole block, its
#: left and right lie within this share of their peak of the base's:
#: float64's own rounding of the NCO's angle (about 3e5 rad late in a
#: row) leaves 1e-12 to 1e-11 between them after the loop has settled
LOCKED = 1e-9

_CP, _CI = 2.666, 3.555          # PI loop filter for damping 1/sqrt(2)


# --- filter design ----------------------------------------------------------


def _sin2_window(n: int) -> np.ndarray:
    return np.sin(np.arange(n, dtype=np.float64) * np.pi / n) ** 2


def lowpass_taps(n: int, fs: float, fc: float) -> np.ndarray:
    norm_fc = fc / (fs / 2.0)
    mid = (n - 1) / 2.0
    i = np.arange(n, dtype=np.float64)
    x = np.pi * norm_fc * (i - mid)
    with np.errstate(invalid="ignore"):
        h = norm_fc * np.sin(x) / x
    return np.where(i == mid, norm_fc, h) * _sin2_window(n)


def bandpass_taps(n: int, fs: float, fb: float, fe: float) -> np.ndarray:
    norm_center = ((fe + fb) / 2.0) / (fs / 2.0)
    norm_pass = (fe - fb) / (fs / 2.0)
    mid = (n - 1) / 2.0
    i = np.arange(n, dtype=np.float64)
    x = np.pi * norm_pass / 2.0 * (i - mid)
    with np.errstate(invalid="ignore"):
        h = norm_pass * np.sin(x) / x
    h = np.where(i == mid, norm_pass, h) * np.cos(i * np.pi * norm_center)
    return h * _sin2_window(n)


def rrc_taps(fs: float, n: int, beta: float = 0.90,
             symbol_rate: float = 2375.0) -> np.ndarray:
    t_sym = 1.0 / symbol_rate
    t = (np.arange(n, dtype=np.float64) - n / 2.0) / fs
    num = (np.sin(np.pi * t * (1 - beta) / t_sym)
           + 4 * beta * (t / t_sym) * np.cos(np.pi * t * (1 + beta) / t_sym))
    den = np.pi * t * (1 - (4 * beta * t / t_sym) ** 2) / t_sym
    with np.errstate(invalid="ignore", divide="ignore"):
        h = num / den
    h = np.where(t == 0.0, 1.0 + beta * (4 / np.pi - 1.0), h)
    t_sing = t_sym / (4 * beta)
    edge = (beta / np.sqrt(2.0)) * (
        (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
        + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
    return np.where((t == t_sing) | (t == -t_sing), edge, h)


def design(cfg: dict) -> dict:
    """Every filter of the configuration, in float64."""
    if_fs, f = cfg["if_fs"], cfg["cutoffs_hz"]
    audio_taps = cfg["audio_taps_base"] * cfg["audio_upsamp"]
    h = {
        "rf": lowpass_taps(cfg["rf_taps"], cfg["rf_fs"], f["rf"]),
        "audio": lowpass_taps(audio_taps, if_fs * cfg["audio_upsamp"],
                              f["audio"]),
        "pilot": bandpass_taps(cfg["stereo_taps"], if_fs, *f["pilot_bpf"]),
        "stereo": bandpass_taps(cfg["stereo_taps"], if_fs, *f["stereo_bpf"]),
    }
    if cfg["rds"]:
        h["rds_channel"] = bandpass_taps(cfg["rds_taps"], if_fs,
                                         *f["rds_channel_bpf"])
        h["rds_carrier"] = bandpass_taps(cfg["rds_taps"], if_fs,
                                         *f["rds_carrier_bpf"])
        h["rds_resampler"] = lowpass_taps(
            cfg["audio_taps_base"] * cfg["rds_upsamp"],
            if_fs * cfg["rds_upsamp"], f["rds_resampler"])
        h["rds_rrc"] = rrc_taps(cfg["rds_sps"] * 2375.0, cfg["rds_rrc_taps"])
    return h


# --- streaming kernels (overlap-save, explicit state) ----------------------


def fir_decim(x, h, state, decim: int):
    xc = np.concatenate([state, x])
    y = np.convolve(xc, h, mode="valid")[::decim]
    return y, xc[len(xc) - (len(h) - 1):].copy()


def resample_state_len(taps: int, up: int) -> int:
    return -(-taps // up) - 1


def fir_resample(x, h, state, decim: int, up: int):
    """Polyphase xU -> FIR -> /D with the xU passband gain; the state is
    the last ceil(K/U)-1 natural-domain inputs."""
    k = len(h)
    t = -(-k // up)
    n_out = len(x) * up // decim
    xc = np.concatenate([state, x])
    m = np.arange(n_out) * decim
    p = m % up
    q = (m - p) // up + (t - 1)
    r = np.arange(t)
    n_idx = p[:, None] + r[None, :] * up
    hsel = np.where(n_idx < k, h[np.minimum(n_idx, k - 1)], 0.0)
    y = up * np.sum(hsel * xc[q[:, None] - r[None, :]], axis=1)
    return y, (xc[len(xc) - (t - 1):].copy() if t > 1 else xc[:0])


def allpass_delay(x, state):
    d = len(state)
    return np.concatenate([state, x[: len(x) - d]]), x[len(x) - d:].copy()


def fm_demod_quad(i, q, prev):
    ip = np.concatenate([prev[:1], i[:-1]])
    qp = np.concatenate([prev[1:2], q[:-1]])
    num = i * (q - qp) - q * (i - ip)
    den = i * i + q * q
    with np.errstate(invalid="ignore", divide="ignore"):
        y = np.where(den == 0.0, 0.0, num / den)
    return y, np.array([i[-1], q[-1]])


def fm_pll(x, freq: float, fs: float, st: list, nco_scale: float = 2.0,
           phase_adjust: float = 0.0, bandwidth: float = 0.01):
    """The literal recurrence: atan2 detector, PI filter, NCO.  ``st`` is
    [integrator, phase, fb_i, fb_q, nco_last, trig, nco_q_last]; returns
    the n+1 NCO samples (index 0 the carried last one) and the state."""
    kp, ki = bandwidth * _CP, bandwidth * bandwidth * _CI
    w = 2.0 * math.pi * freq / fs
    integ, phase, fb_i, fb_q, nco_last, trig, nco_q_last = st
    args = np.empty(len(x))
    atan2, cos, sin = math.atan2, math.cos, math.sin
    for k, v in enumerate(x.tolist()):
        err = atan2(-v * fb_q, v * fb_i)
        integ += ki * err
        phase += kp * err + integ
        trig += 1.0
        a = w * trig + phase
        fb_i, fb_q = cos(a), sin(a)
        args[k] = a
    nco = np.concatenate([[nco_last], np.cos(args * nco_scale
                                             + phase_adjust)])
    nco_q = np.concatenate([[nco_q_last], np.sin(args * nco_scale
                                                 + phase_adjust)])
    return nco, [integ, phase, fb_i, fb_q, nco[-1], trig, nco_q[-1]]


# --- the receiver -------------------------------------------------------------


def init_state(cfg: dict) -> dict:
    z = np.zeros
    up = cfg["audio_upsamp"]
    audio_taps = cfg["audio_taps_base"] * up
    audio = (resample_state_len(audio_taps, up) if up > 1
             else audio_taps - 1)
    s = {"rf_i": z(cfg["rf_taps"] - 1), "rf_q": z(cfg["rf_taps"] - 1),
         "demod": z(2), "mono_allpass": z((cfg["stereo_taps"] - 1) // 2),
         "mono_fir": z(audio), "stereo_bpf": z(cfg["stereo_taps"] - 1),
         "pilot_bpf": z(cfg["stereo_taps"] - 1), "stereo_fir": z(audio),
         "pilot_pll": [0.0, 0.0, 1.0, 0.0, 1.0, 0.0, 0.0]}
    if cfg["rds"]:
        s.update(
            rds_channel=z(cfg["rds_taps"] - 1),
            rds_allpass=z((cfg["rds_taps"] - 1) // 2),
            rds_carrier=z(cfg["rds_taps"] - 1),
            rds_pll=[0.0, 0.0, 1.0, 0.0, 1.0, 0.0, 1.0],
            rds_resampler=z(resample_state_len(
                cfg["audio_taps_base"] * cfg["rds_upsamp"],
                cfg["rds_upsamp"])),
            rds_rrc=z(cfg["rds_rrc_taps"] - 1))
    return s


def _audio(x, h, state, cfg):
    if cfg["audio_upsamp"] > 1:
        return fir_resample(x, h, state, cfg["audio_decim"],
                            cfg["audio_upsamp"])
    return fir_decim(x, h, state, cfg["audio_decim"])


def process_block(iq: np.ndarray, h: dict, s: dict, cfg: dict,
                  flip: int = -1) -> dict:
    """One block of normalized float64 I/Q (interleaved); updates ``s`` in
    place and returns the arms.  ``flip``: the index in the block of the
    pilot PLL's decision taken the other way (-1: none)."""
    i_ds, s["rf_i"] = fir_decim(iq[0::2], h["rf"], s["rf_i"], cfg["rf_decim"])
    q_ds, s["rf_q"] = fir_decim(iq[1::2], h["rf"], s["rf_q"], cfg["rf_decim"])
    fm, s["demod"] = fm_demod_quad(i_ds, q_ds, s["demod"])
    delayed, s["mono_allpass"] = allpass_delay(fm, s["mono_allpass"])
    mono, s["mono_fir"] = _audio(delayed, h["audio"], s["mono_fir"], cfg)
    st_filt, s["stereo_bpf"] = fir_decim(fm, h["stereo"], s["stereo_bpf"], 1)
    pi_filt, s["pilot_bpf"] = fir_decim(fm, h["pilot"], s["pilot_bpf"], 1)
    if flip >= 0:
        pi_filt[flip] = -pi_filt[flip]
    nco, s["pilot_pll"] = fm_pll(pi_filt, cfg["pilot_hz"], cfg["if_fs"],
                                 s["pilot_pll"], nco_scale=2.0)
    st_final, s["stereo_fir"] = _audio(nco[:-1] * st_filt * 2.0, h["audio"],
                                       s["stereo_fir"], cfg)
    out = {"fm_demod": fm, "mono": mono, "left": mono + st_final,
           "right": mono - st_final}
    if cfg["rds"]:
        chan, s["rds_channel"] = fir_decim(fm, h["rds_channel"],
                                           s["rds_channel"], 1)
        chan_d, s["rds_allpass"] = allpass_delay(chan, s["rds_allpass"])
        carrier, s["rds_carrier"] = fir_decim(chan * chan, h["rds_carrier"],
                                              s["rds_carrier"], 1)
        nco, s["rds_pll"] = fm_pll(carrier, cfg["rds_carrier_hz"],
                                   cfg["if_fs"], s["rds_pll"],
                                   nco_scale=0.5,
                                   phase_adjust=3.0 * np.pi / 8.0,
                                   bandwidth=0.002)
        res, s["rds_resampler"] = fir_resample(
            nco[:-1] * chan_d * 2.0, h["rds_resampler"], s["rds_resampler"],
            cfg["rds_decim"], cfg["rds_upsamp"])
        out["rds_symbols"], s["rds_rrc"] = fir_decim(res, h["rds_rrc"],
                                                     s["rds_rrc"], 1)
    return out


def _block(row: np.ndarray, k: int, cfg: dict) -> np.ndarray:
    """Stream block ``k`` of a row read as a ring, normalized."""
    bs = cfg["block_bytes"]
    b = k % (len(row) // bs)
    return (row[b * bs:(b + 1) * bs].astype(np.float64) - 128.0) / 128.0


def _copy_state(s: dict) -> dict:
    return {k: v.copy() if isinstance(v, np.ndarray) else list(v)
            for k, v in s.items()}


def pilot_input(before: dict, fm: np.ndarray, h: dict
                ) -> tuple[np.ndarray, np.ndarray]:
    """(v, s) of one block: the pilot PLL's input, as ``process_block``
    makes it from the state ``before`` the block and its ``fm``, and the
    scale on which float32 rounds it, sum_k |h[k]| |fm[n-k]|."""
    xc = np.concatenate([before["pilot_bpf"], fm])
    return (np.convolve(xc, h["pilot"], mode="valid"),
            np.convolve(np.abs(xc), np.abs(h["pilot"]), mode="valid"))


def _follow(row, cfg, h, starts, base, block: int, index: int) -> dict:
    """The branch that takes the pilot decision at ``index`` of ``block``
    the other way: its left and right from that block on, until it has
    locked back onto ``base`` or the row ends."""
    s = _copy_state(starts[block])
    peak = {a: float(np.abs(base[a]).max()) or 1.0 for a in PILOT_ARMS}
    got = {a: [] for a in PILOT_ARMS}
    for k in range(block, len(starts)):
        out = process_block(_block(row, k, cfg), h, s, cfg,
                            index if k == block else -1)
        if k > block and all(np.abs(out[a] - base[a][k]).max()
                             <= LOCKED * peak[a] for a in PILOT_ARMS):
            break
        for a in PILOT_ARMS:
            got[a].append(out[a])
    return {"block": block, "index": index,
            **{a: np.stack(v) for a, v in got.items()}}


def run_row(row: np.ndarray, cfg: dict, n_blocks: int, tau: float = TAU,
            flip: tuple[int, int] | None = None,
            keep_pilot: bool = False) -> dict:
    """Blocks 0..n_blocks-1 of one channel's stream, the row read as a
    ring (block k is ring block k mod its length), from a zero state;
    each arm stacked (n_blocks, length).  Under ``"pilot"``: the
    ambiguous pilot decisions found at ``tau`` (``"ambiguous"``) and the
    branches followed (``"branches"``: each its block, its index in the
    block, its ``"ratio"`` |v|/s, and its left and right from that block
    on); with ``keep_pilot`` also every block's ``"v"`` and ``"s"``.
    ``flip`` (block, index): that pilot decision taken the other way in
    this run itself."""
    h, s = design(cfg), init_state(cfg)
    outs = {a: [] for a in ARMS}
    starts, found, vs, ss = [], [], [], []
    for k in range(n_blocks):
        starts.append(_copy_state(s))
        out = process_block(_block(row, k, cfg), h, s, cfg,
                            flip[1] if flip and flip[0] == k else -1)
        for a, y in out.items():
            outs[a].append(y)
        v, sc = pilot_input(starts[k], out["fm_demod"], h)
        ratio = np.abs(v) / np.where(sc > 0, sc, 1.0)
        found += [(ratio[n], k, int(n))
                  for n in np.flatnonzero(np.abs(v) < tau * sc)]
        if keep_pilot:
            vs.append(v)
            ss.append(sc)
    arms = {a: np.stack(v) for a, v in outs.items() if v}
    found.sort()
    pilot = {"ambiguous": len(found), "branches": [
        {**_follow(row, cfg, h, starts, arms, k, n), "ratio": float(r)}
        for r, k, n in found[:MAX_BRANCHES]]}
    if keep_pilot:
        pilot.update(v=np.stack(vs), s=np.stack(ss))
    return {**arms, "pilot": pilot}


def _worker() -> None:
    """A worker's body: (row, cfg, n_blocks, keyword arguments) pickled
    on standard input, :func:`run_row`'s result pickled on standard
    output."""
    row, cfg, n_blocks, kw = pickle.load(sys.stdin.buffer)
    pickle.dump(run_row(row, cfg, n_blocks, **kw), sys.stdout.buffer,
                protocol=pickle.HIGHEST_PROTOCOL)
    sys.stdout.buffer.flush()


#: a worker's command: the harness's parent on the path, nothing else
_BENCH = str(Path(__file__).resolve().parent.parent)
_WORKER = [sys.executable, "-P", "-c",
           f"import sys; sys.path.insert(0, {_BENCH!r}); "
           "from harness.reference import _worker; _worker()"]


def _run_in_child(row: np.ndarray, cfg: dict, n_blocks: int,
                  kw: dict) -> dict:
    """:func:`run_row` in a child process that has ended when this
    returns (``subprocess.run`` kills and waits for it on any way out)."""
    out = subprocess.run(
        _WORKER, input=pickle.dumps((row, cfg, n_blocks, kw),
                                    protocol=pickle.HIGHEST_PROTOCOL),
        stdout=subprocess.PIPE, check=False)
    if out.returncode != 0:
        raise RuntimeError(f"a reference worker exited {out.returncode}")
    return pickle.loads(out.stdout)


def run_rows(rows: list[np.ndarray], cfg: dict, n_blocks: list[int],
             workers: int, **kw) -> list[dict]:
    """:func:`run_row` (with keyword arguments ``kw``) for each row, over
    up to ``workers`` child processes (one: in this process); every child
    has ended when this returns, and one that fails raises here."""
    if workers <= 1 or len(rows) == 1:
        return [run_row(r, cfg, n, **kw) for r, n in zip(rows, n_blocks)]
    with concurrent.futures.ThreadPoolExecutor(
            min(workers, len(rows))) as pool:
        return list(pool.map(_run_in_child, rows, [cfg] * len(rows),
                             n_blocks, [kw] * len(rows)))
