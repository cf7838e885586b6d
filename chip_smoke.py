#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sdr_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line of output each (any failure raises and exits non-zero):

1. card and build: requires CUDA, prints the card's name and power limit,
   and builds the CUDA kernels from ``sdr_tpu_torch/csrc`` with nvcc;
2. kernels against their plain PyTorch versions at the paths' shapes:
   K1 ``fir_frontend_u8`` (C=1, C=512, a short block, a 4-block chain),
   K2 ``pll_angles`` (C=1 x 2 arms, 3 chained blocks), K3 ``pll_mixer``
   (C=512 x 2 arms), K5 ``fir_decim_f32`` (the receiver's float front-end
   at C=1 and C=512, the channelizer's FIR at C=2 and C=64 with D=4 and
   D=8, a 3-block chain), K4 ``fir_decim_i8`` (C=1, C=512, a short
   block), K6 ``halo_shift_right`` (S=8 shards on one card with C=1 and
   C=4 rows at mode 0's RDS halo, an odd halo, a 2 x 4 channel x time
   grid; bit-equal);
3. the paths, each with the launch counts set to 0 just before it and
   read just after: (a) ``sdr_tpu_torch.receive`` on a synthesized 1 s
   mode-0 stereo+RDS capture, then a 512-channel ``Receiver`` for 4 blocks
   whose channel 0 must match a single-channel run (K1, K2, K3); (b) the
   CLI, ``python -m sdr_tpu_torch.cli`` driven in process, with
   ``--wideband`` on a synthesized 1 s 9.6 MS/s capture of two stations
   (K5, K2); (c) the CLI on the single-station capture of (a) (K1, K2);
   (d) ``time_sharded_receive`` of a synthesized 4 s capture over 8 time
   shards on one card (K6, K5, K2), held to the JAX package's gates
   against a contiguous ``Receiver.run`` on the card, then its chunked
   variant (bit-equal), a ``channel_sharded_run`` of 8 channels over two
   shards of the card, and, with two or more cards, the same time-sharded
   run across two cards.  Stereo separation and RDS info words are
   checked against what each station transmitted;
4. timing with CUDA events: block time and IQ rate at C=1 and C=512, the
   wideband block (channelizer + receiver) at C=2 and C=64, each kernel
   against its plain version, and a 60 s capture time-sharded at S = 1,
   2, 4, 8 on the card against its contiguous run (host clock).

The last three lines are the card's name and power limit as ``nvidia-smi``
reports them, a JSON object with one entry per kernel, and
``{"ok": true, "device": {...}}``.  TF32 is turned off.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import sdr_tpu_torch
from sdr_tpu_torch import cli, stimulus
from sdr_tpu_torch.kernels import build
from sdr_tpu_torch.models import rds_decode
from sdr_tpu_torch.models import receiver as rx
from sdr_tpu_torch.models.channelizer import Channelizer
from sdr_tpu_torch.models.rds_groups import bits_to_int
from sdr_tpu_torch.ops import fir_decim, fir_frontend, pll_cuda
from sdr_tpu_torch.ops import pll as tpll
from sdr_tpu_torch.parallel import (Mesh, assemble_time_chunks,
                                    channel_sharded_run, default_block_if,
                                    gather_channels, time_sharded_receive,
                                    time_sharded_receive_chunked)
from sdr_tpu_torch.parallel import halo as khalo
from sdr_tpu import config as cfg
from sdr_tpu.utils import synth

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"     # captures and CLI outputs
MODE = 0
SEED = 20261016
K1_ATOL = 1e-5    # fp32 FIR, two summation orders (also K4, K5)
PLL_ATOL = 1e-4   # the JAX package's gate for its PLL kernel
ROW0_ATOL = 1e-4  # channel 0 of C=512 (K3) against a C=1 run (K2)
SEP_DB = 30.0
LINEAR_ATOL = 1e-5   # time-sharded fm_demod/mono against contiguous
SHARD0_ATOL = 1e-2   # shard 0's left channel against contiguous
RELOCK_RMS = 1e-4    # left after RELOCK_SKIP: RMS error / reference RMS
RELOCK_SKIP = 8000   # audio samples (tests/test_parallel.py)
CHANNEL_ATOL = 1e-4  # channel-sharded against per-channel runs
SHARDS = 8

KERNELS = {
    "fir_frontend_u8": dict(
        route="cuda", source="sdr_tpu_torch/csrc/fir_frontend_u8.cu",
        replaces="sdr_tpu/ops/pallas_fir_mxu.py:284",
        counter=fir_frontend.fir_frontend_u8),
    "pll_angles": dict(
        route="cuda", source="sdr_tpu_torch/csrc/pll.cu",
        replaces="sdr_tpu/ops/pallas_pll.py:101",
        counter=pll_cuda.pll_angles),
    "pll_mixer": dict(
        route="cuda", source="sdr_tpu_torch/csrc/pll.cu",
        replaces="sdr_tpu/ops/pallas_pll.py:356",
        counter=pll_cuda.pll_mixer),
    "fir_decim_i8": dict(
        route="cuda", source="sdr_tpu_torch/csrc/fir_decim.cu",
        replaces="sdr_tpu/ops/pallas_fir_mxu.py:132",
        counter=fir_frontend.fir_frontend_u8_deinterleaved),
    "fir_decim_f32": dict(
        route="cuda", source="sdr_tpu_torch/csrc/fir_decim.cu",
        replaces="sdr_tpu/ops/pallas_fir.py:173",
        counter=fir_decim.fir_block_decim),
    "halo_shift_right": dict(
        route="cuda", source="sdr_tpu_torch/csrc/halo.cu",
        replaces="sdr_tpu/parallel/pallas_halo.py:77",
        counter=khalo.halo_shift_right),
}
WIDE_FS = 9.6e6
WIDE_OFFSETS = (-1.5e6, 2.0e6)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the device, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


# --- phase 1 ----------------------------------------------------------------


def phase_card_and_build() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    rx.pin_fp32_matmul()
    smi = card()
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    path, secs = build.build()
    build.load()
    ptxas = [ln.strip() for ln in
             (path.parent / "build.log").read_text().splitlines()
             if "Used" in ln or "Compiling entry" in ln]
    print(f"build: {path.relative_to(ROOT)} compiled in {secs:.1f} s; "
          + " | ".join(ptxas))
    return smi


# --- phase 2 ----------------------------------------------------------------


def _u8_case(rng, c: int, n: int, k: int):
    u8 = rng.integers(0, 256, size=(c, 2 * n), dtype=np.uint8)
    st = rng.integers(-128, 128, size=(c, 2, k - 1)).astype(np.float32) / 128
    return (torch.from_numpy(u8).cuda(), torch.from_numpy(st).cuda())


def check_k1(h: torch.Tensor, rng) -> dict:
    """K1 against its plain version: outputs within K1_ATOL, states
    exactly equal."""
    mc = cfg.get_mode_config(MODE)
    n_block = mc.default_block_size(True) // 2          # 57,600 I/Q pairs
    k, d = h.shape[0], mc.rf_decim
    worst, shapes = 0.0, {}
    for name, c, n in (("C=1", 1, n_block), ("C=512", 512, n_block),
                       ("short N=140", 2, 140)):
        iq, st = _u8_case(rng, c, n, k)
        yk, sk = fir_frontend.fir_frontend_u8(iq, h, st, d)
        yp, sp = fir_frontend.fir_frontend_u8_plain(iq, h, st, d)
        torch.cuda.synchronize()
        err = max_err(yk, yp)
        if err > K1_ATOL or not torch.equal(sk, sp):
            raise AssertionError(f"K1 {name}: max err {err:.3g} > {K1_ATOL} "
                                 f"or state mismatch")
        worst = max(worst, err)
        shapes[name] = (iq, st)
    # a 4-block chain, each side carrying its own state
    iq, st = _u8_case(rng, 2, 4 * 5760, k)
    sk = sp = st
    for b in range(4):
        blk = iq[:, b * 2 * 5760:(b + 1) * 2 * 5760].contiguous()
        yk, sk = fir_frontend.fir_frontend_u8(blk, h, sk, d)
        yp, sp = fir_frontend.fir_frontend_u8_plain(blk, h, sp, d)
        err = max_err(yk, yp)
        if err > K1_ATOL or not torch.equal(sk, sp):
            raise AssertionError(f"K1 chain block {b}: max err {err:.3g} or "
                                 "state mismatch")
        worst = max(worst, err)
    print(f"K1 fir_frontend_u8 vs plain: C=1, C=512, short block, 4-block "
          f"chain: max abs err {worst:.3g} (atol {K1_ATOL}), states equal")
    return {"max_abs_err": worst, "cases": shapes}


def _pll_inputs(rng, c: int, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pilot-like and RDS-carrier-like PLL inputs (c, 2, n) with random
    phases and noise, plus random mixer operands."""
    x = stimulus.pll_tones(rng, c, n, cfg.get_mode_config(MODE).if_fs)
    mix = rng.standard_normal((c, 2, n))
    return (torch.from_numpy(x).cuda(),
            torch.tensor(mix, dtype=torch.float32).cuda())


def _pll_setup(x: torch.Tensor, mixer: bool):
    """Lane layout, constants and initial carry of one PLL call."""
    mc = cfg.get_mode_config(MODE)
    st0 = rx.init_state(mc, (x.shape[0],), device=x.device)
    st = tpll.stack_arms([st0.pilot_pll, st0.rds_pll])
    ly = pll_cuda.LaneLayout(x, (rx.pilot_pll_params(mc),
                                 rx.rds_pll_params(mc)))
    return ly, ly.consts(mixer), ly.carry0(st, mixer)


def check_k2(rng) -> dict:
    """K2 against its plain version over 3 chained 5,760-sample blocks at
    C=1 x 2 arms (pilot + RDS carrier)."""
    n = 5760
    x, _ = _pll_inputs(rng, 1, 3 * n)
    ly, consts, ck = _pll_setup(x[..., :n], mixer=False)
    cp = ck
    worst = 0.0
    for b in range(3):
        xs = ly.time_major(x[..., b * n:(b + 1) * n])
        ak, ck = pll_cuda.pll_angles(xs, ck, consts)
        ap, cp = pll_cuda.pll_angles_plain(xs, cp, consts)
        worst = max(worst, max_err(ak, ap), max_err(ck, cp))
    if worst > PLL_ATOL:
        raise AssertionError(f"K2: max err {worst:.3g} > {PLL_ATOL}")
    print(f"K2 pll_angles vs plain: C=1 x 2 arms, 3 chained blocks: max abs "
          f"err {worst:.3g} (atol {PLL_ATOL}; 0 means bit-equal)")
    return {"max_abs_err": worst, "case": (xs, ck, consts)}


def check_k3(rng) -> dict:
    """K3 against its plain version: C=512 x 2 arms, one 5,760 block."""
    n = 5760
    x, mix = _pll_inputs(rng, 512, n)
    ly, consts, c0 = _pll_setup(x, mixer=True)
    xs, ms = ly.time_major(x), ly.time_major(mix)
    mk, ck = pll_cuda.pll_mixer(xs, ms, c0, consts)
    mp, cp = pll_cuda.pll_mixer_plain(xs, ms, c0, consts)
    worst = max(max_err(mk, mp), max_err(ck, cp))
    if worst > PLL_ATOL:
        raise AssertionError(f"K3: max err {worst:.3g} > {PLL_ATOL}")
    print(f"K3 pll_mixer vs plain: C=512 x 2 arms, 1 block: max abs err "
          f"{worst:.3g} (atol {PLL_ATOL}; 0 means bit-equal)")
    return {"max_abs_err": worst, "case": (xs, ms, c0, consts)}


def _f32_case(rng, shape) -> torch.Tensor:
    return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device="cuda")


def _k5_pair(x, h, st, d, name: str) -> float:
    yk, sk = fir_decim.fir_block_decim(x, h, st, d)
    yp, sp = fir_decim.fir_block_decim_plain(x, h, st, d)
    torch.cuda.synchronize()
    err = max_err(yk, yp)
    if err > K1_ATOL or not torch.equal(sk, sp):
        raise AssertionError(f"K5 {name}: max err {err:.3g} > {K1_ATOL} or "
                             "state mismatch")
    return err


def check_k5(h_rf: torch.Tensor, rng) -> dict:
    """K5 against its plain version: the receiver's float RF front-end (the
    interleaved (C, 2N) block read as its (C, 2, N) view, element step 2)
    and the channelizer's anti-alias FIR on its (C, 2, N_wide) stack, then a
    3-block chain.  Outputs within K1_ATOL, states exactly equal."""
    mc = cfg.get_mode_config(MODE)
    n_block = mc.default_block_size(True) // 2          # 57,600 I/Q pairs
    worst, cases = 0.0, {}
    for c in (1, 512):
        x = _f32_case(rng, (c, 2 * n_block)).reshape(c, n_block,
                                                     2).movedim(-1, -2)
        st = _f32_case(rng, (c, 2, h_rf.shape[0] - 1))
        err = _k5_pair(x, h_rf, st, mc.rf_decim, f"front-end C={c}")
        worst = max(worst, err)
        cases[f"front-end C={c}"] = (x, h_rf, st, mc.rf_decim)
    for d in (4, 8):
        ch = Channelizer(WIDE_OFFSETS, d * mc.rf_fs, MODE, device="cuda")
        for c in (2, 64):
            x = _f32_case(rng, (c, 2, d * n_block))
            st = _f32_case(rng, (c, 2, ch.coeffs.shape[0] - 1))
            err = _k5_pair(x, ch.coeffs, st, d, f"channelizer C={c} D={d}")
            worst = max(worst, err)
            cases[f"channelizer C={c} D={d}"] = (x, ch.coeffs, st, d)
    x, h, st, d = cases["channelizer C=2 D=4"]
    sk = sp = st
    for b in range(3):
        blk = x[..., b * 4 * 5760:(b + 1) * 4 * 5760]
        yk, sk = fir_decim.fir_block_decim(blk, h, sk, d)
        yp, sp = fir_decim.fir_block_decim_plain(blk, h, sp, d)
        err = max_err(yk, yp)
        if err > K1_ATOL or not torch.equal(sk, sp):
            raise AssertionError(f"K5 chain block {b}: max err {err:.3g} or "
                                 "state mismatch")
        worst = max(worst, err)
    print(f"K5 fir_decim_f32 vs plain: front-end C=1, C=512 (step 2); "
          f"channelizer C=2, C=64 x D=4, D=8; 3-block chain: max abs err "
          f"{worst:.3g} (atol {K1_ATOL}), states equal")
    return {"max_abs_err": worst, "cases": cases}


def check_k4(h: torch.Tensor, rng) -> dict:
    """K4 against K1's plain version: C=1, C=512 and a short block.  No
    path runs K4, so these are its launches."""
    mc = cfg.get_mode_config(MODE)
    n_block = mc.default_block_size(True) // 2
    k4 = fir_frontend.fir_frontend_u8_deinterleaved
    k4.launches = 0
    worst, cases = 0.0, {}
    for name, c, n in (("C=1", 1, n_block), ("C=512", 512, n_block),
                       ("short N=140", 2, 140)):
        iq, st = _u8_case(rng, c, n, h.shape[0])
        yk, sk = k4(iq, h, st, mc.rf_decim)
        yp, sp = fir_frontend.fir_frontend_u8_plain(iq, h, st, mc.rf_decim)
        torch.cuda.synchronize()
        err = max_err(yk, yp)
        if err > K1_ATOL or not torch.equal(sk, sp):
            raise AssertionError(f"K4 {name}: max err {err:.3g} > {K1_ATOL} "
                                 "or state mismatch")
        worst = max(worst, err)
        cases[name] = (iq, st)
    launches = k4.launches
    print(f"K4 fir_decim_i8 vs plain: C=1, C=512, short block: max abs err "
          f"{worst:.3g} (atol {K1_ATOL}), states equal; {launches} launches")
    return {"max_abs_err": worst, "cases": cases, "launches": launches}


def _halo_rows(rng, grid: tuple[int, int], c: int, halo: int):
    """Shard buffers [halo | segment] on cuda:0 as ``grid`` (time rows x
    shards) of (c, 2*halo): random segments, NaN halo slots."""
    rows = []
    for _ in range(grid[0]):
        row = []
        for _ in range(grid[1]):
            buf = torch.full((c, 2 * halo), float("nan"), device="cuda")
            buf[:, halo:] = _f32_case(rng, (c, halo))
            row.append(buf)
        rows.append(row)
    return rows


def check_k6(rng) -> dict:
    """K6 against its plain version, bit for bit: S=8 shards on one card
    with C=1 and C=4 rows at mode 0's RDS halo, an odd halo (the scalar
    path), a 2 x 4 channel x time grid."""
    mc = cfg.get_mode_config(MODE)
    halo = 2 * default_block_if(mc, True) * 2 * mc.rf_decim    # 230,400
    cases = {}
    for name, grid, c, n in (("S=8 C=1", (1, SHARDS), 1, halo),
                             ("S=8 C=4", (1, SHARDS), 4, halo),
                             ("S=8 odd", (1, SHARDS), 2, 1_001),
                             ("2x4 grid", (2, 4), 2, halo)):
        rows = _halo_rows(rng, grid, c, n)
        want = [[b.clone() for b in row] for row in rows]
        khalo.halo_fill_plain(want, n)
        khalo.halo_shift_right(rows, n)
        torch.cuda.synchronize()
        if not all(torch.equal(b, w) for row, ref in zip(rows, want)
                   for b, w in zip(row, ref)):
            raise AssertionError(f"K6 {name}: differs from its plain version")
        cases[name] = (rows, want, n)
    print(f"K6 halo_shift_right vs plain: {', '.join(cases)} (halo {halo}; "
          "odd 1001): bit-equal")
    return {"max_abs_err": 0.0, "cases": cases}


# --- phase 3 ----------------------------------------------------------------


def _reset_counts() -> None:
    for spec in KERNELS.values():
        spec["counter"].launches = 0


def _read_counts(path: str, need: tuple[str, ...]) -> dict:
    """The launch counts of the path just driven; raises when a kernel of
    that path (``need``) never ran."""
    torch.cuda.synchronize()
    launches = {name: spec["counter"].launches
                for name, spec in KERNELS.items()}
    if min(launches[name] for name in need) == 0:
        raise AssertionError(f"{path}: a kernel of the path never ran: "
                             f"{launches}")
    return launches


def _tone_power(x: np.ndarray, fs: float, f: float) -> float:
    t = np.arange(len(x)) / fs
    return float(np.abs(np.mean(x * np.exp(-2j * np.pi * f * t))) ** 2)


def _separation_db(left, right, fs, tone_l, tone_r, skip=6000):
    l, r = np.asarray(left, np.float64)[skip:], np.asarray(right,
                                                           np.float64)[skip:]
    sep_l = _tone_power(l, fs, tone_l) / max(_tone_power(l, fs, tone_r),
                                             1e-30)
    sep_r = _tone_power(r, fs, tone_r) / max(_tone_power(r, fs, tone_l),
                                             1e-30)
    return 10 * math.log10(sep_l), 10 * math.log10(sep_r)


def _serving_batch(iq_u8: np.ndarray, c: int, n_bytes: int, rng):
    """(c, n_bytes): channel 0 is the start of the capture, the others the
    same station from random whole-I/Q-pair offsets."""
    offs = 2 * rng.integers(1, (len(iq_u8) - n_bytes) // 2, size=c - 1)
    return np.stack([iq_u8[:n_bytes]]
                    + [iq_u8[o:o + n_bytes] for o in offs])


def phase_main_path(rng) -> dict:
    mc = cfg.get_mode_config(MODE)
    res = synth.synthesize_fm(duration_s=1.0, mode=MODE, seed=SEED,
                              with_rds=True)
    bs = mc.default_block_size(True)
    batch = _serving_batch(res.iq_u8, 512, 4 * bs, rng)

    _reset_counts()
    out = sdr_tpu_torch.receive(res.iq_u8, mode=MODE, stereo=True, rds=True,
                                device="cuda")
    r512 = rx.Receiver(MODE, stereo=True, with_rds=True, batch_shape=(512,),
                       device="cuda")
    outs512 = r512.run(batch)
    launches = _read_counts("main path", ("fir_frontend_u8", "pll_angles",
                                          "pll_mixer"))

    sep_l, sep_r = _separation_db(out.left, out.right, mc.audio_fs, 800.0,
                                  1500.0)
    if not (np.all(np.isfinite(out.left)) and sep_l > SEP_DB
            and sep_r > SEP_DB):
        raise AssertionError(f"stereo separation L {sep_l:.1f} dB, R "
                             f"{sep_r:.1f} dB (need > {SEP_DB})")
    sent = {tuple(w) for g in res.rds_info_bits for w in g}
    words = [tuple(w) for w in out.rds_info_words]
    hits = sum(w in sent for w in words)
    n_groups = len(res.rds_info_bits)
    if hits != len(words) or len(words) < n_groups:
        raise AssertionError(f"RDS: {hits} of {len(words)} info words were "
                             f"transmitted; need all, and >= {n_groups}")
    print(f"main path: receive() 1 s capture: separation L {sep_l:.1f} dB, "
          f"R {sep_r:.1f} dB; RDS {len(words)} frames, all info words "
          f"transmitted ({n_groups} groups sent); C=512 x 4 blocks; "
          f"launches {launches}")

    # channel 0 of the batch against a single-channel run of the same bytes
    r1 = rx.Receiver(MODE, stereo=True, with_rds=True, device="cuda")
    outs1 = r1.run(batch[0])
    errs = []
    for b in range(outs1.left.shape[0]):
        e = max(max_err(getattr(outs512, f)[b, 0], getattr(outs1, f)[b])
                for f in ("fm_demod", "mono", "left", "right", "rds_symbols"))
        if not e <= ROW0_ATOL:
            raise AssertionError(f"C=512 channel 0 vs C=1, block {b}: max "
                                 f"err {e:.3g} > {ROW0_ATOL}")
        errs.append(e)
    print("main path: C=512 channel 0 vs C=1 per block max abs err "
          + ", ".join(f"{e:.3g}" for e in errs) + f" (atol {ROW0_ATOL})")
    return {"launches": launches, "capture": res}


def _read_wav(path: Path) -> tuple[np.ndarray, np.ndarray]:
    """(left, right) of a 16-bit stereo wav written by the CLI."""
    pcm = np.frombuffer(path.read_bytes()[44:], dtype=np.int16)
    return pcm[0::2] / 16384.0, pcm[1::2] / 16384.0


def _check_station(label: str, wav: Path, dec, sent_groups, tone_l: float,
                   tone_r: float) -> str:
    """Stereo separation at the station's own tones, and every info word
    of every RDS group the CLI decoded was transmitted to this station."""
    mc = cfg.get_mode_config(MODE)
    left, right = _read_wav(wav)
    sep_l, sep_r = _separation_db(left, right, mc.audio_fs, tone_l, tone_r)
    if not (len(left) > 0.9 * mc.audio_fs and sep_l > SEP_DB
            and sep_r > SEP_DB):
        raise AssertionError(f"{label}: {len(left)} samples, separation L "
                             f"{sep_l:.1f} dB, R {sep_r:.1f} dB (need > "
                             f"{SEP_DB})")
    sent = {tuple(w) for g in sent_groups for w in g}
    words = [tuple(w) for g in dec.groups for w in g.words]
    # the synthesized groups are random, each with its own block-A word
    pis_sent = {bits_to_int(g[0]) for g in sent_groups}
    st = dec.station_info()
    if not words or not all(w in sent for w in words) \
            or st.pi not in pis_sent:
        raise AssertionError(f"{label}: {len(words)} RDS info words, "
                             f"{sum(w in sent for w in words)} transmitted; "
                             f"PI {st.pi} not among those sent")
    return (f"{label}: separation L {sep_l:.1f} dB, R {sep_r:.1f} dB "
            f"({tone_l:.0f}/{tone_r:.0f} Hz); RDS {dec.n_matches} frames, "
            f"{len(dec.groups)} groups, all {len(words)} info words "
            f"transmitted, PI={st.pi:04X}")


def phase_cli(res) -> dict:
    """The CLI in process: ``--wideband`` on a 1 s two-station capture,
    then single-station on the capture of the main path.  Launch counts
    are set to 0 before each and read after."""
    WORK.mkdir(parents=True, exist_ok=True)
    wb = synth.synthesize_wideband(duration_s=1.0, fs_wide=WIDE_FS,
                                   offsets_hz=list(WIDE_OFFSETS), mode=MODE,
                                   seed=SEED + 2, with_rds=True)
    raw = WORK / "wideband.raw"
    wb.iq_u8.tofile(raw)
    decs: list = []
    _reset_counts()
    rc = cli.main(["--device", "cuda", "--mode", str(MODE), "--stereo",
                   "--rds", "--wideband", str(int(WIDE_FS)),
                   "--offsets=" + ",".join(str(int(f)) for f in WIDE_OFFSETS),
                   str(raw), "--wav", "-o", str(WORK / "station")],
                  rds_decoders=decs)
    wide = _read_counts("wideband CLI", ("fir_decim_f32", "pll_angles"))
    if rc != 0 or len(decs) != len(WIDE_OFFSETS):
        raise AssertionError(f"wideband CLI exited {rc} with {len(decs)} "
                             "RDS decoders")
    for k in range(len(WIDE_OFFSETS)):
        # synth.synthesize_wideband's tones: 600 + 300k Hz left,
        # 2300 - 400k Hz right
        print("wideband CLI " + _check_station(
            f"station {k} @ {WIDE_OFFSETS[k] / 1e6:+.1f} MHz",
            WORK / f"station_{k}.wav", decs[k],
            wb.stations[k].rds_info_bits, 600.0 + 300.0 * k,
            2300.0 - 400.0 * k))
    print(f"wideband CLI: launches {wide}")

    raw = WORK / "single.raw"
    res.iq_u8.tofile(raw)
    decs = []
    _reset_counts()
    rc = cli.main(["--device", "cuda", "--mode", str(MODE), "--stereo",
                   "--rds", str(raw), "--wav", "-o", str(WORK / "single.wav")],
                  rds_decoders=decs)
    single = _read_counts("single-station CLI", ("fir_frontend_u8",
                                                 "pll_angles"))
    if rc != 0 or len(decs) != 1:
        raise AssertionError(f"single-station CLI exited {rc}")
    print("single-station CLI " + _check_station(
        "1 s capture", WORK / "single.wav", decs[0], res.rds_info_bits,
        800.0, 1500.0) + f"; launches {single}")
    return {"launches": wide}


def _sharded_gates(label: str, out, ref) -> str:
    """The JAX package's gates for a time-sharded run against a contiguous
    one: linear arms within LINEAR_ATOL, shard 0's left within SHARD0_ATOL,
    the left channel's RMS error after RELOCK_SKIP samples below RELOCK_RMS
    of the reference RMS."""
    errs = {a: max_err(getattr(out, a), getattr(ref, a).reshape(-1))
            for a in ("fm_demod", "mono")}
    left, ref_left = out.left.cpu().numpy(), ref.left.reshape(-1).cpu().numpy()
    first = len(ref_left) // SHARDS
    err0 = float(np.abs(left[:first] - ref_left[:first]).max())
    d = left[RELOCK_SKIP:] - ref_left[RELOCK_SKIP:]
    rel = float(np.sqrt(np.mean(d ** 2))
                / np.sqrt(np.mean(ref_left[RELOCK_SKIP:] ** 2)))
    if not (max(errs.values()) <= LINEAR_ATOL and err0 <= SHARD0_ATOL
            and rel < RELOCK_RMS):
        raise AssertionError(f"{label}: fm/mono err {errs} (atol "
                             f"{LINEAR_ATOL}), shard 0 left {err0:.3g} (atol "
                             f"{SHARD0_ATOL}), relock RMS {rel:.3g} (< "
                             f"{RELOCK_RMS})")
    return (f"fm_demod {errs['fm_demod']:.3g}, mono {errs['mono']:.3g} "
            f"(atol {LINEAR_ATOL}); shard 0 left {err0:.3g} (atol "
            f"{SHARD0_ATOL}); relock RMS {rel:.3g} of the reference "
            f"(< {RELOCK_RMS})")


def phase_time_sharded(rng) -> dict:
    """Path (d): a 4 s mode-0 stereo+RDS capture, normalized and trimmed to
    8 segments of 20 blocks, time-sharded over 8 shards on cuda:0."""
    mc = cfg.get_mode_config(MODE)
    res = synth.synthesize_fm(duration_s=4.0, mode=MODE, seed=SEED + 3,
                              with_rds=True)
    block_raw = default_block_if(mc, True) * 2 * mc.rf_decim
    iq = synth.u8_to_float(res.iq_u8)[: SHARDS * 20 * block_raw]
    mesh = Mesh(["cuda:0"] * SHARDS, ("time",))

    _reset_counts()
    out = time_sharded_receive(iq, mesh, MODE, stereo=True, with_rds=True)
    launches = _read_counts("time-sharded path", ("halo_shift_right",
                                                  "fir_decim_f32",
                                                  "pll_angles"))
    ref = rx.Receiver(MODE, stereo=True, with_rds=True,
                      device="cuda").run(iq, block_size=block_raw)
    gates = _sharded_gates("time-sharded", out, ref)
    sep_l, sep_r = _separation_db(out.left.cpu().numpy(),
                                  out.right.cpu().numpy(), mc.audio_fs,
                                  800.0, 1500.0)
    if not sep_l > SEP_DB or not sep_r > SEP_DB:
        raise AssertionError(f"time-sharded separation L {sep_l:.1f} dB, R "
                             f"{sep_r:.1f} dB (need > {SEP_DB})")
    dec = rds_decode.decode_robust(out.rds_symbols.cpu().numpy(),
                                   mc.rds.sps)
    sent = {tuple(w) for g in res.rds_info_bits for w in g}
    words = [tuple(w) for w in dec.info_words]
    n_groups = len(res.rds_info_bits)
    hits = sum(w in sent for w in words)
    if hits != len(words) or len(words) < n_groups:
        raise AssertionError(f"time-sharded RDS: {hits} of {len(words)} info "
                             f"words were transmitted; need all, and >= "
                             f"{n_groups}")
    print(f"time-sharded path: 4 s capture, {SHARDS} shards x 20 blocks on "
          f"cuda:0 vs contiguous on the card: {gates}; separation L "
          f"{sep_l:.1f} dB, R {sep_r:.1f} dB; RDS {len(words)} frames, all "
          f"info words transmitted ({n_groups} groups sent); launches "
          f"{launches}")

    chunks = list(time_sharded_receive_chunked(iq, mesh, MODE, stereo=True,
                                               with_rds=True, chunk_blocks=7))
    got = assemble_time_chunks(chunks)
    for arm in ("fm_demod", "mono", "left", "right", "rds_symbols"):
        if not np.array_equal(got[arm], getattr(out, arm).cpu().numpy()):
            raise AssertionError(f"time-sharded chunked {arm} differs from "
                                 "the single-shot run")
    print(f"time-sharded chunked (7-block chunks, halos sliced on the host): "
          f"{len(chunks)} chunks, bit-equal to the single-shot run")

    # 8 channels: the capture from 8 whole-I/Q-pair offsets, 4 blocks each
    offs = 2 * rng.integers(0, (len(iq) - 4 * block_raw) // 2, size=8)
    chans = np.stack([iq[o:o + 4 * block_raw] for o in offs])
    outs, _ = gather_channels(channel_sharded_run(
        chans, Mesh(["cuda:0"] * 2, ("ch",)), MODE, stereo=True,
        with_rds=True))
    worst = 0.0
    for c in range(8):
        one = rx.Receiver(MODE, stereo=True, with_rds=True,
                          device="cuda").run(chans[c])
        worst = max(worst, *(max_err(getattr(outs, a)[:, c], getattr(one, a))
                             for a in ("fm_demod", "mono", "left", "right",
                                       "rds_symbols")))
    if not worst <= CHANNEL_ATOL:
        raise AssertionError(f"channel-sharded: max err {worst:.3g} > "
                             f"{CHANNEL_ATOL}")
    print(f"channel-sharded: 8 channels x 4 blocks over 2 shards of cuda:0 "
          f"vs per-channel runs: max abs err {worst:.3g} (atol "
          f"{CHANNEL_ATOL})")

    if torch.cuda.device_count() >= 2:
        two = Mesh(["cuda:0"] * (SHARDS // 2) + ["cuda:1"] * (SHARDS // 2),
                   ("time",))
        before = khalo.halo_shift_right.launches
        out2 = time_sharded_receive(iq, two, MODE, stereo=True,
                                    with_rds=True)
        n = khalo.halo_shift_right.launches - before
        print(f"time-sharded across two cards (4 shards each, K6 reading "
              f"over peer access): ran, {n} K6 launches; "
              + _sharded_gates("two cards", out2, ref))
    else:
        print("time-sharded across two cards: not run (1 CUDA device)")
    return {"launches": launches}


# --- phase 4 ----------------------------------------------------------------


def _time_wideband(smi: str, c: int, fs_wide: float, offsets, rng,
                   reps: int) -> None:
    """One wideband block of random u8 (one mode-0 RDS block after
    decimation) through the channelizer and a C-station receiver."""
    mc = cfg.get_mode_config(MODE)
    ch = Channelizer(offsets, fs_wide, MODE, device="cuda")
    r = rx.Receiver(MODE, stereo=True, with_rds=True, batch_shape=(c,),
                    device="cuda")
    n_bytes = mc.default_block_size(True) * ch.decim
    blk = torch.from_numpy(rng.integers(0, 256, size=n_bytes,
                                        dtype=np.uint8)).cuda()
    base = ch.process(blk)
    ms = cuda_ms(lambda: r.process(ch.process(blk)), reps, warmup=3)
    ms_ch = cuda_ms(lambda: ch.process(blk), reps)
    ms_rx = cuda_ms(lambda: r.process(base), reps)
    block_ms = n_bytes / 2 / fs_wide * 1e3
    print(f"timing [{smi}]: wideband block, C={c} stations at "
          f"{fs_wide / 1e6:.1f} MS/s (D={ch.decim}): {ms:.3f} ms/block "
          f"(channelizer {ms_ch:.3f}, receiver {ms_rx:.3f}), "
          f"{n_bytes / 2 / ms / 1e3:.2f} wideband Msamples/s, "
          f"{block_ms / ms:.1f}x real time")


def _time_sharding(smi: str, rng) -> None:
    """A 60 s mode-0 stereo+RDS capture (random u8, normalized, trimmed to
    whole blocks in 8 segments) through ``time_sharded_receive_chunked``
    at S = 1, 2, 4, 8 on cuda:0 and through a contiguous
    ``Receiver.run`` of the same capture; host clock, each run ending in
    host numpy or a synchronize."""
    mc = cfg.get_mode_config(MODE)
    block_raw = default_block_if(mc, True) * 2 * mc.rf_decim
    n = int(60 * mc.rf_fs * 2) // (SHARDS * block_raw) * SHARDS * block_raw
    iq = rng.integers(0, 256, size=n, dtype=np.uint8).astype(np.float32)
    iq /= 128.0
    iq -= 1.0                           # exact: (u8 - 128) / 128
    secs = n / 2 / mc.rf_fs
    t0 = time.perf_counter()
    rx.Receiver(MODE, stereo=True, with_rds=True, device="cuda").run(
        iq, block_size=block_raw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"timing [{smi}]: {secs:.2f} s capture contiguous Receiver.run: "
          f"{wall:.3f} s, {wall / secs * 1e3:.2f} ms per second of signal, "
          f"{secs / wall:.1f}x real time")
    for s in (1, 2, 4, 8):
        t0 = time.perf_counter()
        for _ in time_sharded_receive_chunked(
                iq, Mesh(["cuda:0"] * s, ("time",)), MODE, stereo=True,
                with_rds=True):
            pass
        wall = time.perf_counter() - t0
        print(f"timing [{smi}]: {secs:.2f} s capture time-sharded chunked "
              f"S={s} on cuda:0: {wall:.3f} s, {wall / secs * 1e3:.2f} ms "
              f"per second of signal, {secs / wall:.1f}x real time")


def phase_timing(smi: str, k1: dict, k2: dict, k3: dict, k4: dict,
                 k5: dict, k6: dict) -> dict:
    mc = cfg.get_mode_config(MODE)
    bs = mc.default_block_size(True)
    n_iq = bs // 2
    rng = np.random.default_rng(SEED + 1)
    for c, reps in ((1, 30), (512, 10)):
        r = rx.Receiver(MODE, stereo=True, with_rds=True,
                        batch_shape=(c,) if c > 1 else (), device="cuda")
        blk = torch.from_numpy(rng.integers(
            0, 256, size=((c,) if c > 1 else ()) + (bs,),
            dtype=np.uint8)).cuda()
        ms = cuda_ms(lambda: r.process(blk), reps, warmup=3)
        print(f"timing [{smi}]: mode-0 stereo+RDS block at C={c}: "
              f"{ms:.3f} ms/block, {c * n_iq / ms / 1e3:.2f} IQ Msamples/s "
              f"({24.0 / ms * c:.1f}x real time over all channels)")
    h = rx.design_coeffs(mc, device="cuda").rf
    times = {}
    for name in ("C=1", "C=512"):
        iq, st = k1["cases"][name]
        kms = cuda_ms(lambda: fir_frontend.fir_frontend_u8(iq, h, st, 10), 50)
        pms = cuda_ms(lambda: fir_frontend.fir_frontend_u8_plain(iq, h, st,
                                                                 10), 20)
        print(f"timing [{smi}]: K1 fir_frontend_u8 {name}: kernel {kms:.4f} "
              f"ms, plain {pms:.4f} ms")
        times["fir_frontend_u8"] = (kms, pms)
    xs, c0, consts = k2["case"]
    kms = cuda_ms(lambda: pll_cuda.pll_angles(xs, c0, consts), 20)
    pms = cuda_ms(lambda: pll_cuda.pll_angles_plain(xs, c0, consts), 2)
    print(f"timing [{smi}]: K2 pll_angles C=1 x 2 arms x 5760: kernel "
          f"{kms:.4f} ms, plain {pms:.4f} ms")
    times["pll_angles"] = (kms, pms)
    xs, ms_, c0, consts = k3["case"]
    kms = cuda_ms(lambda: pll_cuda.pll_mixer(xs, ms_, c0, consts), 10)
    pms = cuda_ms(lambda: pll_cuda.pll_mixer_plain(xs, ms_, c0, consts), 1)
    print(f"timing [{smi}]: K3 pll_mixer C=512 x 2 arms x 5760: kernel "
          f"{kms:.4f} ms, plain {pms:.4f} ms")
    times["pll_mixer"] = (kms, pms)
    # each PLL kernel at the other batch too (kernel only): separates what
    # the lane count costs from what the NCO + mixer work costs
    for c, mixer in ((512, False), (1, True)):
        x, mix = _pll_inputs(rng, c, 5760)
        ly, consts, c0 = _pll_setup(x, mixer)
        xs = ly.time_major(x)
        if mixer:
            ms_ = ly.time_major(mix)
            kms = cuda_ms(lambda: pll_cuda.pll_mixer(xs, ms_, c0, consts), 10)
        else:
            kms = cuda_ms(lambda: pll_cuda.pll_angles(xs, c0, consts), 10)
        print(f"timing [{smi}]: {'K3 pll_mixer' if mixer else 'K2 pll_angles'}"
              f" C={c} x 2 arms x 5760: kernel {kms:.4f} ms")
    for name in ("C=1", "C=512"):
        iq, st = k4["cases"][name]
        kms = cuda_ms(lambda: fir_frontend.fir_frontend_u8_deinterleaved(
            iq, h, st, 10), 50)
        pms = cuda_ms(lambda: fir_frontend.fir_frontend_u8_plain(iq, h, st,
                                                                 10), 20)
        print(f"timing [{smi}]: K4 fir_decim_i8 {name}: kernel {kms:.4f} ms, "
              f"plain {pms:.4f} ms")
        times["fir_decim_i8"] = (kms, pms)
    # the JSON line keeps the last case: the channelizer at C=64, D=8
    for name, (x, hk, st, d) in k5["cases"].items():
        kms = cuda_ms(lambda: fir_decim.fir_block_decim(x, hk, st, d), 20)
        pms = cuda_ms(lambda: fir_decim.fir_block_decim_plain(x, hk, st, d),
                      10)
        print(f"timing [{smi}]: K5 fir_decim_f32 {name}: kernel {kms:.4f} ms, "
              f"plain {pms:.4f} ms")
        times["fir_decim_f32"] = (kms, pms)
    _time_wideband(smi, 2, WIDE_FS, WIDE_OFFSETS, rng, 10)
    _time_wideband(smi, 64, 2 * WIDE_FS,
                   [(k - 32) * 200e3 for k in range(64)], rng, 5)
    rows, plain, halo = k6["cases"]["S=8 C=1"]
    kms = cuda_ms(lambda: khalo.halo_shift_right(rows, halo), 50)
    pms = cuda_ms(lambda: khalo.halo_fill_plain(plain, halo), 50)
    print(f"timing [{smi}]: K6 halo_shift_right S=8 C=1 halo {halo}: kernel "
          f"{kms:.4f} ms, plain {pms:.4f} ms")
    times["halo_shift_right"] = (kms, pms)
    _time_sharding(smi, rng)
    return times


def main() -> int:
    smi = phase_card_and_build()
    rng = np.random.default_rng(SEED)
    h = rx.design_coeffs(cfg.get_mode_config(MODE), device="cuda").rf
    k1 = check_k1(h, rng)
    k2 = check_k2(rng)
    k3 = check_k3(rng)
    k5 = check_k5(h, rng)
    k4 = check_k4(h, rng)
    k6 = check_k6(rng)
    main_path = phase_main_path(rng)
    wideband = phase_cli(main_path["capture"])
    sharded = phase_time_sharded(rng)
    times = phase_timing(smi, k1, k2, k3, k4, k5, k6)
    errs = {"fir_frontend_u8": k1["max_abs_err"],
            "pll_angles": k2["max_abs_err"], "pll_mixer": k3["max_abs_err"],
            "fir_decim_i8": k4["max_abs_err"],
            "fir_decim_f32": k5["max_abs_err"],
            "halo_shift_right": k6["max_abs_err"]}
    # each kernel's launches on its path: K1-K3 on the main path, K5 on the
    # wideband CLI, K6 on the time-sharded path, K4 (on no path) in its
    # phase-2 check
    launches = dict(main_path["launches"],
                    fir_decim_i8=k4["launches"],
                    fir_decim_f32=wideband["launches"]["fir_decim_f32"],
                    halo_shift_right=sharded["launches"]["halo_shift_right"])
    kernels = [{"name": name, "route": spec["route"],
                "source": spec["source"], "replaces": spec["replaces"],
                "launches": launches[name],
                "max_abs_err": errs[name], "ms": times[name][0],
                "plain_ms": times[name][1]}
               for name, spec in KERNELS.items()]
    print(card())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
