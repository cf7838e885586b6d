#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sdr_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line of output each (any failure raises and exits non-zero):

1. card and build: requires CUDA, prints the card's name and power limit,
   and builds the CUDA kernels from ``sdr_tpu_torch/csrc`` with nvcc;
2. kernels against their plain PyTorch versions at the paths' shapes:
   K1 ``fir_frontend_u8`` (C=1, C=512, a short block, a 4-block chain),
   K2 ``pll_angles`` and K3 ``pll_mixer`` bit-equal (C=1 x 2 arms over 3
   chained blocks, C=512 x 2 arms, the time-sharded step's 16 lanes, and
   ragged lane and step counts), the chain floor against K2's recurrence,
   K5 ``fir_decim_f32`` (the receiver's float front-end
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
   against its plain version, its bound and, where one PyTorch call
   computes the same function, that call (K5: ``conv1d`` at stride D; K6:
   one ``copy_``); the PLL chain floor and K2/K3 at 2, 16 and 1,024
   lanes; and a 60 s capture time-sharded at S = 1, 2, 4, 8 on the card
   against its contiguous run (host clock).

A kernel's bound is the larger of its bytes over 3.35 TB/s and its fp32
operations over 67 TFLOP/s (the H100 SXM's published peaks), and for the
serial PLL kernels K2/K3 the larger of that and the measured chain floor.

The last three lines are the card's name and power limit as ``nvidia-smi``
reports them, a JSON object with one entry per kernel (launches on its path
and per block of it, max abs error against the plain version, kernel,
plain, bound and library-call milliseconds), and ``{"ok": true, "device":
{...}}``.  TF32 is turned off.
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
from sdr_tpu_torch import config as cfg
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
from sdr_tpu_torch.utils import synth

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"     # captures and CLI outputs
MODE = 0
SEED = 20261016
K1_ATOL = 1e-5    # fp32 FIR, two summation orders (also K4, K5)
ROW0_ATOL = 1e-4  # channel 0 of C=512 (K3) against a C=1 run (K2)
SEP_DB = 30.0
LINEAR_ATOL = 1e-5   # time-sharded fm_demod/mono against contiguous
SHARD0_ATOL = 1e-2   # shard 0's left channel against contiguous
RELOCK_RMS = 1e-4    # left after RELOCK_SKIP: RMS error / reference RMS
RELOCK_SKIP = 8000   # audio samples (tests/test_parallel.py)
CHANNEL_ATOL = 1e-4  # channel-sharded against per-channel runs
SHARDS = 8
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
# float operations of one step of one PLL lane as csrc/pll.cu writes them:
# K2's chain (3 multiplies, 9 adds or subtracts, the wraps' included); K3
# adds the NCO's multiply-add, a cosf (counted as 20) and the mixer's
# two multiplies
PLL_STEP_OPS = {"pll_angles": 12, "pll_mixer": 12 + 2 + 20 + 2}

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


def _wild(carry: torch.Tensor) -> torch.Tensor:
    """A carry whose phases lie far outside [0, m) and whose wrapped angle
    lies outside [-pi, pi): the kernels' first tile leaves the shortcuts'
    ranges and is replayed exactly."""
    carry = carry.clone()
    carry[1] = 100.0 + torch.arange(carry.shape[1], device=carry.device)
    carry[2, ::2] = -37.5
    carry[3] = 9.0
    return carry


def _pll_chain(kind: str, x, mix, blocks: int, n: int,
               wild: bool = False) -> float:
    """``blocks`` chained blocks of ``n`` steps of K2 (``kind`` "K2") or K3
    against the plain version, each side carrying its own state (``wild``:
    from :func:`_wild`'s carry): outputs and carries must be equal
    (torch.equal); returns the max abs error (0.0)."""
    mixer = kind == "K3"
    ly, consts, ck = _pll_setup(x[..., :n], mixer)
    if wild:
        ck = _wild(ck)
    cp = ck
    for b in range(blocks):
        xs = ly.time_major(x[..., b * n:(b + 1) * n])
        if mixer:
            ms = ly.time_major(mix[..., b * n:(b + 1) * n])
            ok, ck = pll_cuda.pll_mixer(xs, ms, ck, consts)
            op, cp = pll_cuda.pll_mixer_plain(xs, ms, cp, consts)
        else:
            ok, ck = pll_cuda.pll_angles(xs, ck, consts)
            op, cp = pll_cuda.pll_angles_plain(xs, cp, consts)
        torch.cuda.synchronize()
        if not (torch.equal(ok, op) and torch.equal(ck, cp)):
            raise AssertionError(
                f"{kind} lanes {xs.shape[1]} n {n} block {b}: differs from "
                f"its plain version (max abs err "
                f"{max(max_err(ok, op), max_err(ck, cp)):.3g})")
    return max(max_err(ok, op), max_err(ck, cp))


def check_pll(rng) -> dict:
    """K2 and K3 against their plain versions, bit for bit (torch.equal on
    outputs and carries): the main path's shapes (K2 at C=1 x 2 arms over
    3 chained blocks, K3 at C=512 x 2 arms), the time-sharded step's 16
    lanes (S=8 x 2 arms, K2, 3 chained blocks), and ragged shapes: 6 and
    1,030 lanes (neither a multiple of 32 nor of 4: padded rows), 960-step
    blocks chained across the kernels' 64-step tiles, N = 1, a 5,760 +
    37-step tail block, and a carry out of the shortcuts' ranges (the
    kernels' exact replay).  Then the chain floor against K2's recurrence
    on the floor's own input pattern."""
    n = 5760
    cases = []
    for kind, c, steps, blocks, wild in (
            ("K2", 1, n, 3, False), ("K3", 512, n, 1, False),
            ("K2", 8, n, 3, False), ("K2", 3, 960, 3, False),
            ("K3", 3, 960, 3, False), ("K2", 515, 960, 2, False),
            ("K3", 515, 960, 2, False), ("K2", 1, 1, 3, False),
            ("K3", 1, 1, 3, False), ("K2", 2, n + 37, 1, False),
            ("K3", 2, n + 37, 1, False), ("K3", 1, n, 2, False),
            ("K2", 3, 960, 2, True), ("K3", 3, 960, 2, True)):
        x, mix = _pll_inputs(rng, c, steps * blocks)
        _pll_chain(kind, x, mix, blocks, steps, wild)
        cases.append(f"{kind} {2 * c}x{steps}x{blocks}"
                     + (" (out-of-range carry: replayed)" if wild else ""))
    print("K2 pll_angles / K3 pll_mixer vs plain, bit-equal (torch.equal, "
          "outputs and carries; lanes x steps x chained blocks): "
          + ", ".join(cases))
    x, mix = _pll_inputs(rng, 1, n)
    ly, consts, c0 = _pll_setup(x, mixer=False)
    k2_case = (ly.time_major(x), c0, consts)
    x, mix = _pll_inputs(rng, 512, n)
    ly, consts3, c03 = _pll_setup(x, mixer=True)
    k3_case = (ly.time_major(x), ly.time_major(mix), c03, consts3)
    # the chain floor computes K2's recurrence on its own input pattern
    got = pll_cuda.chain_floor(c0, consts, n)
    want = pll_cuda.chain_floor_plain(c0, consts, n)
    if not torch.equal(got, want):
        raise AssertionError("chain floor differs from K2's recurrence")
    print(f"chain floor (one warp, {n} steps, 2 lanes): carry bit-equal to "
          "the plain loop on its input pattern")
    return {"max_abs_err": 0.0, "k2": k2_case, "k3": k3_case,
            "floor": (c0, consts, n)}


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
    return {"max_abs_err": worst, "cases": cases, "launches": launches,
            "calls": len(cases)}


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

    # blocks of the path: receive() runs the capture's whole blocks and its
    # tail as one more (K1 and K2 at C=1), the batch 4 blocks (K1 and K3)
    gran = mc.if_block_multiple(True) * 2 * mc.rf_decim
    usable = len(res.iq_u8) // gran * gran
    c1_blocks = -(-usable // bs)
    per_block = {"fir_frontend_u8": launches["fir_frontend_u8"]
                 / (c1_blocks + 4),
                 "pll_angles": launches["pll_angles"] / c1_blocks,
                 "pll_mixer": launches["pll_mixer"] / 4}

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
    return {"launches": launches, "per_block": per_block, "capture": res}


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
    mc = cfg.get_mode_config(MODE)
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
    blocks = len(wb.iq_u8) // (mc.default_block_size(True)
                               * int(round(WIDE_FS / mc.rf_fs)))
    print(f"wideband CLI: launches {wide} over {blocks} wideband blocks")

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
    return {"launches": wide,
            "per_block": wide["fir_decim_f32"] / blocks}


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

    # 8 channels: the capture from 8 whole-I/Q-pair offsets, 4 blocks each,
    # drawn from a generator of their own so that they do not move with the
    # draws of earlier phases
    offs = 2 * np.random.default_rng(SEED + 4).integers(
        0, (len(iq) - 4 * block_raw) // 2, size=8)
    chans = np.stack([iq[o:o + 4 * block_raw] for o in offs])
    outs, _ = gather_channels(channel_sharded_run(
        chans, Mesh(["cuda:0"] * 2, ("ch",)), MODE, stereo=True,
        with_rds=True))
    errs = {}
    for c in range(8):
        one = rx.Receiver(MODE, stereo=True, with_rds=True,
                          device="cuda").run(chans[c])
        for a in ("fm_demod", "mono", "left", "right", "rds_symbols"):
            errs[a] = max(errs.get(a, 0.0),
                          max_err(getattr(outs, a)[:, c], getattr(one, a)))
    worst = max(errs.values())
    if not worst <= CHANNEL_ATOL:
        raise AssertionError(f"channel-sharded: max err {worst:.3g} > "
                             f"{CHANNEL_ATOL} (per arm {errs}; offsets "
                             f"{offs.tolist()})")
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
    return {"launches": launches, "calls": 1}


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


def _roofline(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time for ``nbytes`` moved and ``ops`` fp32 operations at
    the card's published peaks, and which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bound(nbytes: float, ops: float, floor_ms: float | None = None
           ) -> tuple[float, str, str, float]:
    """(bound ms, bound_by, kind, roofline ms): the roofline of
    :func:`_roofline`, or for the serial PLL kernels the measured chain
    floor where that is larger (kind "hbm", "fp32" or "serial")."""
    roof_ms, by = _roofline(nbytes, ops)
    if floor_ms is not None and floor_ms > roof_ms:
        return floor_ms, "operations", "serial", roof_ms
    return roof_ms, by, "hbm" if by == "bytes" else "fp32", roof_ms


def _pll_work(kind: str, numel: int) -> tuple[float, float]:
    """(bytes, operations) of one K2 or K3 call over ``numel`` lane-steps:
    one float in and one out per lane-step (K3: two in)."""
    name = "pll_mixer" if kind == "K3" else "pll_angles"
    return (3 if kind == "K3" else 2) * 4 * numel, PLL_STEP_OPS[name] * numel


def _fir_work(n_in: int, in_size: int, n_out: int, taps: int,
              state: int) -> tuple[float, float]:
    """(bytes, operations) of a decimating FIR: each input read once, each
    output written once, the state read and written, one multiply-add per
    tap and output."""
    return (n_in * in_size + 4 * n_out + 8 * state + 4 * taps,
            2.0 * taps * n_out)


def _conv1d_ms(x: torch.Tensor, h: torch.Tensor, st: torch.Tensor,
               d: int) -> tuple[float, float]:
    """The library yardstick of K5: ``torch.nn.functional.conv1d`` at
    stride ``d`` over each row's [state | block] (the concatenation made
    outside the timing), TF32 off.  Returns (ms, max abs difference from
    K5)."""
    rows = x.shape[0] * x.shape[1]
    inp = torch.cat([st, x], dim=-1).reshape(rows, 1, -1).contiguous()
    w = h.flip(0).reshape(1, 1, -1).contiguous()
    conv = lambda: torch.nn.functional.conv1d(inp, w, stride=d)
    ms = cuda_ms(conv, 20)
    y, _ = fir_decim.fir_block_decim(x, h, st, d)
    return ms, max_err(conv().reshape(y.shape), y)


def _time_pll(smi: str, rng, kind: str, c: int, reps: int,
              floor_ms: float) -> float:
    """One 5,760-step block of K2 or K3 at c channels x 2 arms, beside its
    bound."""
    n = 5760
    x, mix = _pll_inputs(rng, c, n)
    mixer = kind == "K3"
    ly, consts, c0 = _pll_setup(x, mixer)
    xs, ms_ = ly.time_major(x), ly.time_major(mix)
    if mixer:
        kms = cuda_ms(lambda: pll_cuda.pll_mixer(xs, ms_, c0, consts), reps)
    else:
        kms = cuda_ms(lambda: pll_cuda.pll_angles(xs, c0, consts), reps)
    bound, _, bkind, _ = _bound(*_pll_work(kind, xs.numel()), floor_ms)
    print(f"timing [{smi}]: {kind} {'pll_mixer' if mixer else 'pll_angles'} "
          f"{2 * c} lanes x {n}: kernel {kms:.4f} ms "
          f"({kms / n * 1e6:.1f} ns/step); bound {bound:.4f} ms ({bkind}), "
          f"{bound / kms:.1%} of it")
    return kms


def phase_timing(smi: str, k1: dict, pll: dict, k4: dict, k5: dict,
                 k6: dict) -> dict:
    """Each kernel against its plain version and, where one exists, one
    PyTorch call computing the same function; the chain floor; block times.
    Returns per kernel the JSON line's timing and bound fields, at the last
    shape timed."""
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
    out = {}

    def record(name, kms, pms, nbytes, ops, library_ms=None, floor_ms=None):
        bound, by, kind, roof_ms = _bound(nbytes, ops, floor_ms)
        out[name] = dict(ms=kms, plain_ms=pms, bound_ms=bound, bound_by=by,
                         bound_kind=kind, roofline_ms=roof_ms,
                         floor_ms=floor_ms, library_ms=library_ms)
        print(f"timing [{smi}]: {name}: bound {bound:.4f} ms ({kind}; "
              f"roofline {roof_ms:.4f} ms by {by}); share of bound "
              f"{bound / kms:.1%}; library call "
              + (f"{library_ms:.4f} ms" if library_ms is not None
                 else "none"))

    for key, label, kernel, cases in (
            ("fir_frontend_u8", "K1 fir_frontend_u8",
             fir_frontend.fir_frontend_u8, k1),
            ("fir_decim_i8", "K4 fir_decim_i8",
             fir_frontend.fir_frontend_u8_deinterleaved, k4)):
        for name in ("C=1", "C=512"):
            iq, st = cases["cases"][name]
            kms = cuda_ms(lambda: kernel(iq, h, st, 10), 50)
            pms = cuda_ms(lambda: fir_frontend.fir_frontend_u8_plain(
                iq, h, st, 10), 20)
            n_out = iq.shape[0] * 2 * (iq.shape[1] // 2 // 10)
            work = _fir_work(iq.numel(), 1, n_out, h.shape[0], st.numel())
            bound, _, bkind, _ = _bound(*work)
            print(f"timing [{smi}]: {label} {name}: kernel {kms:.4f} ms, "
                  f"plain {pms:.4f} ms; bound {bound:.4f} ms ({bkind}), "
                  f"{bound / kms:.1%} of it")
        record(key, kms, pms, *work)

    # the PLLs: the serial floor first, then each kernel at its shapes
    c0, consts, n = pll["floor"]
    floor_ms = cuda_ms(lambda: pll_cuda.chain_floor(c0, consts, n), 20)
    print(f"timing [{smi}]: chain floor (one warp, inputs in registers) "
          f"{n} steps: {floor_ms:.4f} ms ({floor_ms / n * 1e6:.1f} "
          "ns/step)")
    for kind, c in (("K2", 1), ("K2", 8), ("K2", 512), ("K3", 1),
                    ("K3", 512)):
        _time_pll(smi, rng, kind, c, 20 if c < 512 else 10, floor_ms)
    xs, c0, consts = pll["k2"]
    kms = cuda_ms(lambda: pll_cuda.pll_angles(xs, c0, consts), 20)
    pms = cuda_ms(lambda: pll_cuda.pll_angles_plain(xs, c0, consts), 2)
    print(f"timing [{smi}]: K2 pll_angles C=1 x 2 arms x 5760: kernel "
          f"{kms:.4f} ms, plain {pms:.4f} ms")
    record("pll_angles", kms, pms, *_pll_work("K2", xs.numel()),
           floor_ms=floor_ms)
    xs, ms_, c0, consts = pll["k3"]
    kms = cuda_ms(lambda: pll_cuda.pll_mixer(xs, ms_, c0, consts), 10)
    pms = cuda_ms(lambda: pll_cuda.pll_mixer_plain(xs, ms_, c0, consts), 1)
    print(f"timing [{smi}]: K3 pll_mixer C=512 x 2 arms x 5760: kernel "
          f"{kms:.4f} ms, plain {pms:.4f} ms")
    record("pll_mixer", kms, pms, *_pll_work("K3", xs.numel()),
           floor_ms=floor_ms)

    # K5 at every case; the JSON line keeps the last: the channelizer at
    # C=64, D=8
    for name, (x, hk, st, d) in k5["cases"].items():
        kms = cuda_ms(lambda: fir_decim.fir_block_decim(x, hk, st, d), 20)
        pms = cuda_ms(lambda: fir_decim.fir_block_decim_plain(x, hk, st, d),
                      10)
        lib_ms, lib_err = _conv1d_ms(x, hk, st, d)
        work = _fir_work(x.numel(), 4, x.numel() // d, hk.shape[0],
                         st.numel())
        bound, _, bkind, _ = _bound(*work)
        print(f"timing [{smi}]: K5 fir_decim_f32 {name}: kernel {kms:.4f} "
              f"ms, plain {pms:.4f} ms, conv1d {lib_ms:.4f} ms (max abs "
              f"diff from K5 {lib_err:.3g}); bound {bound:.4f} ms "
              f"({bkind}), {bound / kms:.1%} of it")
    record("fir_decim_f32", kms, pms, *work, library_ms=lib_ms)

    _time_wideband(smi, 2, WIDE_FS, WIDE_OFFSETS, rng, 10)
    _time_wideband(smi, 64, 2 * WIDE_FS,
                   [(k - 32) * 200e3 for k in range(64)], rng, 5)
    rows, plain, halo = k6["cases"]["S=8 C=1"]
    kms = cuda_ms(lambda: khalo.halo_shift_right(rows, halo), 50)
    pms = cuda_ms(lambda: khalo.halo_fill_plain(plain, halo), 50)
    # the library yardstick: the S shards as rows of one buffer, every
    # prefix filled from the row above's tail by one copy_ (shard 0's zero
    # fill would be a second call)
    s, c = len(rows[0]), rows[0][0].shape[0]
    big = torch.cat([b for b in rows[0]])
    lib_ms = cuda_ms(lambda: big[c:, :halo].copy_(big[:-c, -halo:]), 50)
    print(f"timing [{smi}]: K6 halo_shift_right S=8 C=1 halo {halo}: kernel "
          f"{kms:.4f} ms, plain {pms:.4f} ms, one copy_ {lib_ms:.4f} ms")
    record("halo_shift_right", kms, pms, 4 * halo * c * (2 * s - 1), 0.0,
           library_ms=lib_ms)
    _time_sharding(smi, rng)
    return out


def main() -> int:
    smi = phase_card_and_build()
    rng = np.random.default_rng(SEED)
    h = rx.design_coeffs(cfg.get_mode_config(MODE), device="cuda").rf
    k1 = check_k1(h, rng)
    pll = check_pll(rng)
    k5 = check_k5(h, rng)
    k4 = check_k4(h, rng)
    k6 = check_k6(rng)
    main_path = phase_main_path(rng)
    wideband = phase_cli(main_path["capture"])
    sharded = phase_time_sharded(rng)
    timing = phase_timing(smi, k1, pll, k4, k5, k6)
    errs = {"fir_frontend_u8": k1["max_abs_err"],
            "pll_angles": pll["max_abs_err"],
            "pll_mixer": pll["max_abs_err"],
            "fir_decim_i8": k4["max_abs_err"],
            "fir_decim_f32": k5["max_abs_err"],
            "halo_shift_right": k6["max_abs_err"]}
    # each kernel's launches on its path: K1-K3 on the main path, K5 on the
    # wideband CLI, K6 on the time-sharded path, K4 (on no path) in its
    # phase-2 check; and per block of that path (per call for K4 and K6)
    launches = dict(main_path["launches"],
                    fir_decim_i8=k4["launches"],
                    fir_decim_f32=wideband["launches"]["fir_decim_f32"],
                    halo_shift_right=sharded["launches"]["halo_shift_right"])
    per_block = dict(main_path["per_block"],
                     fir_decim_i8=k4["launches"] / k4["calls"],
                     fir_decim_f32=wideband["per_block"],
                     halo_shift_right=sharded["launches"][
                         "halo_shift_right"] / sharded["calls"])
    kernels = [{"name": name, "route": spec["route"],
                "source": spec["source"], "replaces": spec["replaces"],
                "launches": launches[name],
                "launches_per_block": per_block[name],
                "max_abs_err": errs[name], **timing[name]}
               for name, spec in KERNELS.items()]
    print(card())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
