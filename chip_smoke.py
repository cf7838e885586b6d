#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sdr_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line of output each (any failure raises and exits non-zero):

1. card and build: requires CUDA, prints the card's name and power limit,
   and builds the CUDA kernels from ``sdr_tpu_torch/csrc`` with nvcc;
2. kernels against their plain PyTorch versions at the paths' shapes:
   K1 ``fir_frontend_u8`` (C=1, C=7, C=512, a short block, a 4-block
   chain; row 0 of C=512 bit-equal to the row alone and at C=4),
   K2 ``pll_angles`` and K3 ``pll_mixer`` bit-equal (C=1 x 2 arms over 3
   chained blocks, C=512 x 2 arms, the time-sharded step's 16 lanes, and
   ragged lane and step counts), the chain floor against K2's recurrence,
   K5 ``fir_decim_f32`` (the receiver's float front-end
   at C=1 and C=512, the channelizer's FIR at C=2 and C=64 with D=4 and
   D=8, a block shorter than K-1, a 3-block chain on the kernel's own
   states; states bit-equal to ``tail()``), K4 ``fir_decim_i8`` (C=1,
   C=7, C=512, a short block), K6 ``halo_shift_right`` bit-equal: its
   row-block entry (S=8 shards as row blocks of one tensor with C=1 and
   C=4 rows at mode 0's RDS halo, a 2 x 4 grid) and its table entry (the
   tensor at an odd halo, a 2 x 4 grid handed over as views of one
   buffer, S=8 separate buffers with C=1 and C=4 rows, an odd halo, a
   2 x 4 channel x time grid);
3. the paths, each with the launch counts set to 0 just before it and
   read just after: (a) ``sdr_tpu_torch.receive`` on a synthesized 1 s
   mode-0 stereo+RDS capture, then a 512-channel ``Receiver`` for
   SCAN_BLOCKS + 2 blocks (a chunk graph and a tail) whose channel 0 must
   match a single-channel run (K1, K2, K3; the
   linear arms at 1e-5, the PLL-driven ones at 5e-3); (b) the
   CLI, ``python -m sdr_tpu_torch.cli`` driven in process, with
   ``--wideband`` on a synthesized 1 s 9.6 MS/s capture of two stations
   (K5, K2); (c) the CLI on the single-station capture of (a) (K1, K2);
   (d) ``time_sharded_receive`` of a synthesized 4 s capture over 8 time
   shards on one card (K6 through its row-block entry, K5, K2), held to
   the JAX package's gates
   against a contiguous ``Receiver.run`` on the card and torch.equal to
   the same run on the per-block program, then its chunked variant
   (bit-equal), a ``channel_sharded_run`` of 8 channels over two shards of
   the card (torch.equal to the per-block program), and, with two or more
   cards, the same time-sharded
   run across two cards; (e) the mesh spanning 2 processes on cuda:0
   (``multihost.setup``, gloo), through
   ``scripts/torch_multihost_scaling.py``: the C=512 u8 batch as
   2 x 256 channels (K1, K3 in each process) against one-process runs of
   the same rows, and (d)'s station time-sharded over 2 processes x 4
   shards, the halo inside each process (K6's row-block entry, K5, K2)
   and across the process edge (point-to-point), each row held to the
   JAX package's gates against a contiguous run, and the edge exchange's
   time per call printed beside K6's; every process must exit 0 within
   its timeout.  Stereo separation and RDS info words are
   checked against what each station transmitted.  Every entry point
   runs block programs (``models.program``): ``receive()``,
   ``Receiver.run``/``iter_run``, channel and time sharding a CUDA graph
   of ``receiver.SCAN_BLOCKS`` chained blocks per whole chunk (a chunk
   graph, ``Program.scan``) and the block's graph for the rest, so these
   gates hold the programs too; the main path fails unless a chunk graph
   ran and prints host graph launches per block; the launch counts
   include each program's eager warm-up, and per block they are read over
   the block runs (the blocks the replays ran, and warm-ups);
4. block programs: each against the eager block, torch.equal on every
   output and state leaf over 8 chained blocks (u8 at C=1 and C=512,
   float at C=1 and 8 rows, mode 2, stereo without RDS, ``rds_debug_q``;
   the channelizer's program at C=64 over 3 blocks); each chunk program
   against the per-block program, torch.equal, over a chunk and a tail
   (u8 at C=1 and C=512, float at C=1, mode 2, mode 1's 50,040-byte
   blocks) and ``process``/``run``/``process`` on one ``Receiver``; then
   four cells timed in turns, eager, program, chunk, chunk, program, eager
   (mode-0 stereo+RDS u8 at C=1 and C=512, the time-sharded step at S=8;
   the wideband block of C=64 stations at 19.2 MS/s without the chunk
   turns): wall per block by CUDA events, device busy, idle share, device
   events and host launches per block under ``torch.profiler``, and each
   program's capture time and pool bytes, after the card's name and power
   limit;
5. timing with CUDA events: block time and IQ rate at C=1 and C=512, the
   wideband block (channelizer + receiver) at C=2 and C=64, each kernel
   against its plain version, its bound and, where one PyTorch call
   computes the same function, that call (K1, K4, K5: ``conv1d`` at stride
   D; K6: one ``copy_``), K1, K4, K5 and K6 also as their kernels' device
   time under ``torch.profiler`` (K6 with L2 flushed before each launch);
   the PLL chain floor and K2/K3 at 2, 16 and 1,024 lanes; and a 60 s
   capture time-sharded at S = 1, 2, 4, 8 on the card against its
   contiguous run (host clock);
6. (a) the four modes against the port's float64 golden receiver
   (``golden.receiver.run_file`` on the host), the card's counterpart of
   the JAX package's parity tests (tests/test_models_receiver.py): mode 0
   stereo+RDS on a 0.3 s capture (seed 11) and modes 1, 2, 3 stereo on
   0.12 s captures (seed 6), each through ``Receiver.run`` on the card
   twice, on the normalized float input (K5) and on the raw u8 input (K1
   at ``rf_decim`` 10, 5, 10 and 3), held per block over the blocks those
   tests compare (6 in mode 0, 3 in the others) at their tolerances:
   fm_demod and mono at 2e-4, left, right and rds_symbols at 5e-3; the
   launch counts set to 0 just before and read just after (K1, K5, K2 in
   mode 0, K3 in the stereo-only modes); (b) ``profiling.profile_stages``
   per mode at C=1 (ms per block beside the real-time budget) and one
   per-stage line of mode 0 at C=512 (``scripts/torch_profile_stages.py``);
7. on one line: (a) ``models.run_blocks_scan`` on SCAN_BLOCKS + 2 blocks
   of a C=512 mode-0 stereo+RDS u8 batch on the card, torch.equal to
   ``run_blocks`` over the same blocks, the caller's state torch.equal to
   itself before the call, K1 and K3 launched (the counts set to 0 just
   before and read just after), a repeat call chained from the first
   call's state with no graph capture and the first call's outputs and
   state untouched, and wall ms per block of ``run_blocks_scan`` and
   ``run_blocks`` (a program captured before) in turns; (b) zero-block
   runs: ``Receiver.run`` of a 100-byte capture at C=1 and C=512,
   ``run_blocks_scan`` of (0, 512, 115200) and ``channel_sharded_run`` of
   8 channels over two shards of the card give every arm float32 on the
   card with ``receiver.block_out_lengths``' lengths, the states as they
   were, and launch no kernel; (c) ``ops.pll.pll_block(use_atan2=True)``
   (plain PyTorch, no kernel) over two chained 2,000-sample blocks of
   tests/test_ops.py's 19,020 Hz tone against K2's path
   (``pll_cuda.pll_block_kernel``) at 5e-3.
8. ``bench_torch.py`` at a reduced size in process (``bench_torch.bench``:
   mode 0 only, the single stream, dispatch latency and a sweep of C=512,
   16 blocks a call, 2 timed calls), with its gates (every arm finite, row
   0 of the batch against the single stream at 1e-5 and 5e-3, each
   regime's kernel launches), the launch counts set to 0 just before and
   read just after (K1, K2 at C=1, K3 at C=512); prints the card's name
   and power limit, then the bench's one-line record, and fails unless its
   value is finite and positive.  Its detail goes to
   ``build/chip_smoke/bench_detail.json``.

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

import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

import bench_torch
import sdr_tpu_torch
from sdr_tpu_torch import cli, stimulus
from sdr_tpu_torch import config as cfg
from sdr_tpu_torch.kernels import build
from sdr_tpu_torch.models import channelizer as chan
from sdr_tpu_torch.models import program, rds_decode
from sdr_tpu_torch.models import receiver as rx
from sdr_tpu_torch.models.channelizer import Channelizer
from sdr_tpu_torch.models.rds_groups import bits_to_int
from sdr_tpu_torch.ops import fir_decim, fir_frontend, pll_cuda
from sdr_tpu_torch.ops import pll as tpll
from sdr_tpu_torch.parallel import (Mesh, assemble_time_chunks,
                                    channel_sharded_run, default_block_if,
                                    gather_channels, halo_raw,
                                    time_sharded_receive,
                                    time_sharded_receive_chunked)
from sdr_tpu_torch.golden import receiver as grx
from sdr_tpu_torch.parallel import halo as khalo
from sdr_tpu_torch.utils import profiling, synth
from sdr_tpu_torch.utils.metrics import stereo_separation_db

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"     # captures and CLI outputs
MODE = 0
SEED = 20261016
K1_ATOL = 1e-5    # fp32 FIR, two summation orders (also K4, K5)
SEP_DB = 30.0
# A row run in a batch against the same row alone (channel 0 of C=512
# against C=1; channel-sharded against per-channel runs).  K1 gives a row
# the same bits at any batch size, but the fp32 cuBLAS products of ops/fir.py
# (the band-passes, the audio low-pass, the RDS filters) choose their
# kernel by shape, so a row's sums round differently in another batch
# (scripts/torch_row_invariance.py, PERF.md section 7.4), and the PLL
# loops amplify those ulps near a detector sign change (3.53e-3 once).
# Making the products batch-invariant would cost a product per row, so
# the gates are split as the JAX package splits them
# (tests/test_models_receiver.py): the linear arms fm_demod and mono at
# LINEAR_ATOL, the PLL-driven left, right and rds_symbols at PLL_ATOL.
LINEAR_ATOL = 1e-5   # also time-sharded fm_demod/mono against contiguous
PLL_ATOL = 5e-3
ARM_ATOL = {"fm_demod": LINEAR_ATOL, "mono": LINEAR_ATOL, "left": PLL_ATOL,
            "right": PLL_ATOL, "rds_symbols": PLL_ATOL}
SHARD0_ATOL = 1e-2   # shard 0's left channel against contiguous
RELOCK_RMS = 1e-4    # left after RELOCK_SKIP: RMS error / reference RMS
RELOCK_SKIP = 8000   # audio samples (tests/test_parallel.py)
SHARDS = 8
MP_PROCS = 2             # processes of the multi-process phase, on cuda:0
MP_TIMEOUT_S = 300.0     # each of its configurations
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
# float operations of one step of one PLL lane as csrc/pll.cu writes them:
# K2's chain (3 multiplies, 9 adds or subtracts, the wraps' included); K3
# adds the NCO's multiply-add, a cosf (counted as 20) and the mixer's
# two multiplies
PLL_STEP_OPS = {"pll_angles": 12, "pll_mixer": 12 + 2 + 20 + 2}

KERNELS = {
    "fir_frontend_u8": dict(
        route="cuda", source="sdr_tpu_torch/csrc/fir_decim.cu",
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


def device_ms(fn, reps: int, match: str, before=None) -> float:
    """Mean device time per call of the kernels whose name holds ``match``,
    from ``torch.profiler``'s device events over ``reps`` calls of ``fn``
    (each after ``before()``, when given, outside the match)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation and match in e.name
               ) / reps / 1e3


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
    exactly equal; and row 0 of the C=512 batch bit-equal (torch.equal,
    output and state) to the same row run alone and in a C=4 batch."""
    mc = cfg.get_mode_config(MODE)
    n_block = mc.default_block_size(True) // 2          # 57,600 I/Q pairs
    k, d = h.shape[0], mc.rf_decim
    worst, shapes = 0.0, {}
    for name, c, n in (("C=1", 1, n_block), ("C=7", 7, n_block),
                       ("C=512", 512, n_block), ("short N=140", 2, 140)):
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
        if c == 512:
            for rows in (1, 4):
                yr, sr = fir_frontend.fir_frontend_u8(
                    iq[:rows].clone(), h, st[:rows].clone(), d)
                torch.cuda.synchronize()
                if not (torch.equal(yr[:1], yk[:1])
                        and torch.equal(sr[:1], sk[:1])):
                    raise AssertionError(f"K1: row 0 at C={rows} is not "
                                         "bit-equal to row 0 at C=512")
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
    print(f"K1 fir_frontend_u8 vs plain: C=1, C=7, C=512, short block, "
          f"4-block chain: max abs err {worst:.3g} (atol {K1_ATOL}), states "
          "equal; row 0 of C=512 bit-equal to C=1 and C=4 (torch.equal)")
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
    worst = max(worst, _k5_pair(x[..., :4 * 13], h, st, d,
                                "short block N=52 < K-1"))
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
          f"channelizer C=2, C=64 x D=4, D=8; a block shorter than K-1; "
          f"3-block chain on the kernel's states: max abs err {worst:.3g} "
          f"(atol {K1_ATOL}), states equal")
    return {"max_abs_err": worst, "cases": cases}


def check_k4(h: torch.Tensor, rng) -> dict:
    """K4 against K1's plain version: C=1, C=7, C=512 and a short block.
    No path runs K4, so these are its launches."""
    mc = cfg.get_mode_config(MODE)
    n_block = mc.default_block_size(True) // 2
    k4 = fir_frontend.fir_frontend_u8_deinterleaved
    k4.launches = 0
    worst, cases = 0.0, {}
    for name, c, n in (("C=1", 1, n_block), ("C=7", 7, n_block),
                       ("C=512", 512, n_block), ("short N=140", 2, 140)):
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
    print(f"K4 fir_decim_i8 vs plain: C=1, C=7, C=512, short block: max abs "
          f"err {worst:.3g} (atol {K1_ATOL}), states equal; {launches} "
          "launches")
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


def _ext(rng, t: int, s: int, c: int, halo: int) -> torch.Tensor:
    """A time_sharded_receive-style buffer on cuda:0: cells (b, k) of a
    t x s grid, b-major, each c rows of [halo | segment], random segments,
    NaN halo slots."""
    buf = torch.full((t * s * c, 2 * halo), float("nan"), device="cuda")
    buf[:, halo:] = _f32_case(rng, (t * s * c, halo))
    return buf


def check_k6(rng) -> dict:
    """K6 against its plain version, bit for bit.  The row-block entry: a
    (T, S, rows, L) tensor of S=8 shards with C=1 and C=4 rows at mode 0's
    RDS halo, and a 2 x 4 grid (bulk copies).  The table entry: the same
    tensor at an odd halo (no 16-byte multiple), a 2 x 4 grid handed over
    as views of one buffer, S=8 separate buffers with C=1 and C=4 rows, an
    odd halo, a 2 x 4 channel x time grid."""
    mc = cfg.get_mode_config(MODE)
    halo = halo_raw(mc, default_block_if(mc, True))             # 230,400
    k6 = khalo.halo_shift_right
    rows_before = k6.row_block_launches
    cases = {}
    for name, t, c, n in (("rows S=8 C=1", 1, 1, halo),
                          ("rows S=8 C=4", 1, 4, halo),
                          ("rows 2x4 C=2", 2, 2, halo),
                          ("table S=8 odd tensor", 1, 2, 1_001),
                          ("table 2x4 views", 2, 2, halo)):
        s = SHARDS // t
        ext = _ext(rng, t, s, c, n)
        views = lambda e: [[e[(b * s + k) * c:(b * s + k + 1) * c]
                            for k in range(s)] for b in range(t)]
        want = ext.clone()
        khalo.halo_fill_plain(views(want), n)
        arg = ext.view(t, s, c, 2 * n)
        if name.endswith("views"):
            k6(views(ext), n)
        else:
            k6(arg, n)
        torch.cuda.synchronize()
        if not torch.equal(ext, want):
            raise AssertionError(f"K6 {name}: differs from its plain version")
        cases[name] = (ext, arg, want, n)
    if k6.row_block_launches - rows_before != 3:
        raise AssertionError("K6: the row-block cases did not take the "
                             "row-block entry, or a table case did")
    for name, grid, c, n in (("table S=8 C=1", (1, SHARDS), 1, halo),
                             ("table S=8 C=4", (1, SHARDS), 4, halo),
                             ("table S=8 odd", (1, SHARDS), 2, 1_001),
                             ("table 2x4 grid", (2, 4), 2, halo)):
        rows = _halo_rows(rng, grid, c, n)
        want = [[b.clone() for b in row] for row in rows]
        khalo.halo_fill_plain(want, n)
        k6(rows, n)
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
    program.reset_counts()


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
    # a chunk graph of the batch and two blocks of its tail
    n_batch = rx.SCAN_BLOCKS + 2
    batch = _serving_batch(res.iq_u8, 512, n_batch * bs, rng)

    _reset_counts()
    out = sdr_tpu_torch.receive(res.iq_u8, mode=MODE, stereo=True, rds=True,
                                device="cuda")
    c1_runs = program.counts["blocks"] + program.counts["warm_ups"]
    r512 = rx.Receiver(MODE, stereo=True, with_rds=True, batch_shape=(512,),
                       device="cuda")
    outs512 = r512.run(batch)
    launches = _read_counts("main path", ("fir_frontend_u8", "pll_angles",
                                          "pll_mixer"))
    runs = program.counts["blocks"] + program.counts["warm_ups"]
    graphs = program.counts["captures"]
    replays, blocks = program.counts["replays"], program.counts["blocks"]
    chunks = [c.blocks for c in r512.program.captures]
    if replays >= blocks or rx.SCAN_BLOCKS not in chunks:
        raise AssertionError(f"main path: {replays} graph replays for "
                             f"{blocks} blocks, C=512 captures of {chunks} "
                             "blocks: no chunk graph ran")

    sep_l, sep_r = stereo_separation_db(out.left, out.right, mc.audio_fs,
                                        800.0, 1500.0)
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
          f"transmitted ({n_groups} groups sent); C=512 x {n_batch} "
          f"blocks; {graphs} graphs captured (C=512: of {chunks} blocks), "
          f"{blocks} blocks in {replays} graph replays ("
          f"{replays / blocks:.3f} host graph launches per block; chunk "
          f"graphs of {rx.SCAN_BLOCKS} blocks), {runs} block runs with "
          f"each capture's eager warm-up; launches {launches}")

    # block runs of the path: receive()'s blocks (K1 and K2 at C=1), the
    # batch's (K1 and K3), each counting its program's warm-up
    per_block = {"fir_frontend_u8": launches["fir_frontend_u8"] / runs,
                 "pll_angles": launches["pll_angles"] / c1_runs,
                 "pll_mixer": launches["pll_mixer"] / (runs - c1_runs)}

    # channel 0 of the batch against a single-channel run of the same bytes
    r1 = rx.Receiver(MODE, stereo=True, with_rds=True, device="cuda")
    outs1 = r1.run(batch[0])
    errs = {a: max_err(getattr(outs512, a)[:, 0], getattr(outs1, a))
            for a in ARM_ATOL}
    if not all(errs[a] <= ARM_ATOL[a] for a in ARM_ATOL):
        raise AssertionError(f"C=512 channel 0 vs C=1: max err {errs} (atol "
                             f"{ARM_ATOL})")
    print(f"main path: C=512 channel 0 vs C=1 over {n_batch} blocks, max "
          "abs err "
          + ", ".join(f"{a} {e:.3g} (atol {ARM_ATOL[a]})"
                      for a, e in errs.items()))
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
    sep_l, sep_r = stereo_separation_db(left, right, mc.audio_fs, tone_l,
                                        tone_r)
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
    # each wideband block runs the channelizer's program and the
    # receiver's; each program also ran its capture's eager warm-up
    wide_runs = (program.counts["blocks"] + program.counts["warm_ups"]) / 2
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
    print(f"wideband CLI: launches {wide} over {blocks} wideband blocks "
          f"({wide_runs:.0f} runs of each block program, its warm-up "
          "included)")

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
            "per_block": wide["fir_decim_f32"] / wide_runs}


def _sharded_gates(label: str, out, ref, shards: int = SHARDS) -> str:
    """The JAX package's gates for a time-sharded run of ``shards`` shards
    against a contiguous one: linear arms within LINEAR_ATOL, shard 0's
    left within SHARD0_ATOL, the left channel's RMS error after
    RELOCK_SKIP samples below RELOCK_RMS of the reference RMS."""
    errs = {a: max_err(getattr(out, a), getattr(ref, a).reshape(-1))
            for a in ("fm_demod", "mono")}
    left, ref_left = out.left.cpu().numpy(), ref.left.reshape(-1).cpu().numpy()
    first = len(ref_left) // shards
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


def _station_gates(label: str, out, sent_groups, need_words: int) -> str:
    """Stereo separation above SEP_DB at the synthesized tones, and every
    RDS info word decoded from the soft symbols transmitted, at least
    ``need_words`` of them."""
    mc = cfg.get_mode_config(MODE)
    sep_l, sep_r = stereo_separation_db(out.left.cpu().numpy(),
                                        out.right.cpu().numpy(), mc.audio_fs,
                                        800.0, 1500.0)
    if not sep_l > SEP_DB or not sep_r > SEP_DB:
        raise AssertionError(f"{label} separation L {sep_l:.1f} dB, R "
                             f"{sep_r:.1f} dB (need > {SEP_DB})")
    dec = rds_decode.decode_robust(out.rds_symbols.cpu().numpy(),
                                   mc.rds.sps)
    sent = {tuple(w) for g in sent_groups for w in g}
    words = [tuple(w) for w in dec.info_words]
    hits = sum(w in sent for w in words)
    if hits != len(words) or len(words) < need_words:
        raise AssertionError(f"{label} RDS: {hits} of {len(words)} info "
                             f"words were transmitted; need all, and >= "
                             f"{need_words}")
    return (f"separation L {sep_l:.1f} dB, R {sep_r:.1f} dB; RDS "
            f"{len(words)} frames, all info words transmitted")


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
    khalo.halo_shift_right.row_block_launches = 0
    out = time_sharded_receive(iq, mesh, MODE, stereo=True, with_rds=True)
    replays = program.counts["replays"]
    launches = _read_counts("time-sharded path", ("halo_shift_right",
                                                  "fir_decim_f32",
                                                  "pll_angles"))
    row_blocks = khalo.halo_shift_right.row_block_launches
    if row_blocks < 1:
        raise AssertionError("time-sharded path: K6 never took its "
                             "row-block entry")
    ref = rx.Receiver(MODE, stereo=True, with_rds=True,
                      device="cuda").run(iq, block_size=block_raw)
    gates = _sharded_gates("time-sharded", out, ref)
    n_groups = len(res.rds_info_bits)
    station = _station_gates("time-sharded", out, res.rds_info_bits,
                             n_groups)
    print(f"time-sharded path: 4 s capture, {SHARDS} shards x 20 blocks on "
          f"cuda:0 vs contiguous on the card: {gates}; {station} "
          f"({n_groups} groups sent); launches {launches}, K6 through the "
          f"row-block entry {row_blocks}")

    per_block = _per_block(lambda: time_sharded_receive(
        iq, mesh, MODE, stereo=True, with_rds=True))
    bad = _departs(out, per_block)
    if bad or replays != 1 + 20 // rx.SCAN_BLOCKS + 20 % rx.SCAN_BLOCKS:
        raise AssertionError(f"time-sharded: {replays} graph replays; chunk "
                             f"graphs vs the per-block program: {bad}")
    print(f"time-sharded on chunk graphs (the warm-up's 2 blocks as one "
          f"graph, 20 blocks a shard as {20 // rx.SCAN_BLOCKS} graph(s) of "
          f"{rx.SCAN_BLOCKS} and {20 % rx.SCAN_BLOCKS} of one; {replays} "
          "replays): torch.equal to the per-block program")

    chunk_blocks = rx.SCAN_BLOCKS + 3
    chunks = list(time_sharded_receive_chunked(
        iq, mesh, MODE, stereo=True, with_rds=True,
        chunk_blocks=chunk_blocks))
    got = assemble_time_chunks(chunks)
    for arm in ("fm_demod", "mono", "left", "right", "rds_symbols"):
        if not np.array_equal(got[arm], getattr(out, arm).cpu().numpy()):
            raise AssertionError(f"time-sharded chunked {arm} differs from "
                                 "the single-shot run")
    print(f"time-sharded chunked ({chunk_blocks}-block chunks, halos sliced "
          f"on the host, copied into the chunk graphs' static inputs): "
          f"{len(chunks)} chunks, bit-equal to the single-shot run")

    # 8 channels: the capture from 8 whole-I/Q-pair offsets, a chunk graph
    # and 2 blocks each, drawn from a generator of their own so that they
    # do not move with the draws of earlier phases
    n_ch = rx.SCAN_BLOCKS + 2
    offs = 2 * np.random.default_rng(SEED + 4).integers(
        0, (len(iq) - n_ch * block_raw) // 2, size=8)
    chans = np.stack([iq[o:o + n_ch * block_raw] for o in offs])
    sharded_run = lambda: gather_channels(channel_sharded_run(
        chans, Mesh(["cuda:0"] * 2, ("ch",)), MODE, stereo=True,
        with_rds=True))
    outs, st = sharded_run()
    bad = _departs((outs, st), _per_block(sharded_run))
    if bad:
        raise AssertionError(f"channel-sharded: chunk graphs vs the "
                             f"per-block program: {bad}")
    errs = {}
    for c in range(8):
        one = rx.Receiver(MODE, stereo=True, with_rds=True,
                          device="cuda").run(chans[c])
        for a in ARM_ATOL:
            errs[a] = max(errs.get(a, 0.0),
                          max_err(getattr(outs, a)[:, c], getattr(one, a)))
    if not all(errs[a] <= ARM_ATOL[a] for a in ARM_ATOL):
        raise AssertionError(f"channel-sharded: max err {errs} (atol "
                             f"{ARM_ATOL}; offsets {offs.tolist()})")
    print(f"channel-sharded: 8 channels x {n_ch} blocks over 2 shards of "
          "cuda:0, torch.equal to the per-block program; vs per-channel "
          "runs: max abs err "
          + ", ".join(f"{a} {e:.3g} (atol {ARM_ATOL[a]})"
                      for a, e in errs.items()))

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
    return {"launches": launches, "calls": 1, "capture": res}


def _script(name: str):
    """``scripts/<name>.py``, loaded as a module (the scripts' directory on
    the path, for the helpers they share)."""
    scripts = str(ROOT / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _children_ran(label: str, results: list, need: tuple[str, ...]) -> list:
    """Each process's launch counts (set to 0 just before its run of the
    path, read just after); raises when a kernel of the path (``need``)
    never ran in one."""
    for r in results:
        if min(r["launches"][name] for name in need) == 0:
            raise AssertionError(f"{label}: process {r['process_id']}: a "
                                 f"kernel of the path never ran: "
                                 f"{r['launches']}")
    return [{k: v for k, v in r["launches"].items() if v}
            for r in results]


def phase_multi_process(main_res, sharded_res) -> None:
    """Path (e): the mesh spanning MP_PROCS processes on cuda:0, joined by
    ``multihost.setup`` (gloo: two processes share the card), through
    ``scripts/torch_multihost_scaling.py``: (a) the C=512 mode-0
    stereo+RDS u8 batch as 2 x 256 channels, 4 blocks, each process's rows
    against a one-process run of the same rows; (b) a capture of (d)'s
    station in 2 rows, 4 shards of 20 blocks in each process, the halo
    inside each process; (c) the same signal in 4 rows of 2 shards, every
    time row across the process edge.  (b) and (c) are held to the JAX
    package's gates against a contiguous run of each row on the card, to
    the stereo separation and to the transmitted RDS words."""
    mod = _script("torch_multihost_scaling")
    mc = cfg.get_mode_config(MODE)
    work = WORK / "multi_process"
    work.mkdir(parents=True, exist_ok=True)
    bs = mc.default_block_size(True)
    cap = work / "channels.npz"
    mod.write_capture(cap, main_res.iq_u8, 512, 4 * bs)
    ra = mod.run_config(work / "channel", MP_PROCS, 1, device="cuda",
                        ch_per_proc=256, rds=True, blocks=4, rounds=3,
                        capture=cap, timeout_s=MP_TIMEOUT_S)
    launches = _children_ran("multi-process channel mesh", ra["results"],
                             ("fir_frontend_u8", "pll_mixer"))
    errs = {a: max(r["max_abs_err_vs_one_process"][a] for r in ra["results"])
            for a in ARM_ATOL}
    if ra["backend"] != "gloo" or not all(errs[a] <= ARM_ATOL[a]
                                          for a in ARM_ATOL):
        raise AssertionError(f"multi-process channel mesh ({ra['backend']}):"
                             f" max err {errs} (atol {ARM_ATOL})")
    print(f"multi-process (a) channel mesh: {MP_PROCS} processes on cuda:0 "
          f"({ra['backend']}), C=512 raw u8 as 2 x 256, 4 blocks; each "
          "process's rows vs a one-process run of the same rows: max abs err "
          + ", ".join(f"{a} {e:.3g} (atol {ARM_ATOL[a]})"
                      for a, e in errs.items())
          + f"; {ra['aggregate_samples_per_s'] / 1e6:.2f} IQ Msamples/s "
          f"summed over the processes (host clock, best of 3); launches "
          f"{launches}")

    block_raw = default_block_if(mc, True) * 2 * mc.rf_decim
    n = 80 * block_raw
    cap = work / "station.npz"
    mod.write_capture(cap, sharded_res.iq_u8, 4, n)
    iq_rows = synth.u8_to_float(mod.capture_rows(cap, range(4)))
    refs = [rx.Receiver(MODE, stereo=True, with_rds=True, device="cuda").run(
        row, block_size=block_raw) for row in iq_rows]
    # RDS: 1187.5 bit/s in groups of 104 bits
    need_words = int(n / 2 / mc.rf_fs * 1187.5 / 104)
    timing = {}
    for label, cross, blocks, edge_messages in (
            ("(b) time axis, halo inside each process", False, 20, 0),
            ("(c) time axis, halo across the process edge", True, 40, 4)):
        out_dir = work / ("cross" if cross else "local")
        r = mod.run_time_axis(out_dir, MP_PROCS, 4, device="cuda",
                              cross=cross, rds=True, blocks=blocks,
                              rounds=3, reps=20, capture=cap,
                              save_outputs=True, timeout_s=MP_TIMEOUT_S)
        launches = _children_ran(
            f"multi-process {label}", r["results"],
            ("fir_decim_f32", "pll_angles", "halo_shift_right"))
        ok_edges = all(res["edge_messages"] == edge_messages
                       and (cross or res["launches"]["halo_row_blocks"])
                       for res in r["results"])
        if r["backend"] != "gloo" or r["halo_intra_process"] == cross \
                or not ok_edges:
            raise AssertionError(f"multi-process {label}: backend "
                                 f"{r['backend']}, halo inside the process "
                                 f"{r['halo_intra_process']}, launches "
                                 f"{launches}")
        full = np.load(out_dir / "outputs.npz")
        shards = r["mesh_shape"]["time"]
        for row in range(r["mesh_shape"]["ch"]):
            out = SimpleNamespace(**{f: torch.from_numpy(full[f][row]).cuda()
                                     for f in full.files})
            gates = _sharded_gates(f"multi-process {label} row {row}", out,
                                   refs[row], shards)
            station = _station_gates(f"multi-process {label} row {row}",
                                     out, sharded_res.rds_info_bits,
                                     need_words)
        timing[cross] = r["results"]
        print(f"multi-process {label}: mesh {r['mesh_shape']} over "
              f"{MP_PROCS} processes on cuda:0 ({r['backend']}), "
              f"{blocks} blocks a shard; every row vs its contiguous run on "
              f"the card within the gates (last row: {gates}; {station}); "
              f"{r['aggregate_samples_per_s'] / 1e6:.2f} IQ Msamples/s "
              f"summed (host clock, best of 3); launches {launches}, edge "
              f"messages {[res['edge_messages'] for res in r['results']]}")
    halo = timing[True][0]["halo_raw"]
    print(f"multi-process edge exchange per call (gloo, pinned host staging, "
          f"4 rows x {halo} floats from process 0 to process 1, host clock "
          f"around a synchronize): "
          + ", ".join(f"{res['edge_ms']:.4f} ms" for res in timing[True])
          + "; beside K6 per call in the same processes (CUDA events; "
          "(c): the zero fill of 4 one-shard rows) "
          + ", ".join(f"{res['k6_ms']:.4f} ms" for res in timing[True])
          + ", and in (b)'s (S=4 shards of one row) "
          + ", ".join(f"{res['k6_ms']:.4f} ms" for res in timing[False]))


# --- phase 4: block programs --------------------------------------------------

# (mode, channels, stereo, with_rds, rds_debug_q, float input), as the card
# tests' cases
PROGRAM_CASES = {
    "u8 C=1 (K1, K2)": (0, 1, True, True, False, False),
    "u8 C=512 (K1, K3)": (0, 512, True, True, False, False),
    "float C=1 (K5, K2)": (0, 1, True, True, False, True),
    "float 8 rows, the time-sharded step (K5, K2)": (0, 8, True, True, False,
                                                    True),
    "mode 2 (44.1 kHz resampler)": (2, 1, True, True, False, False),
    "stereo without RDS (K3, one arm)": (0, 1, True, False, False, False),
    "rds_debug_q (K2 unfused)": (0, 1, True, True, True, False),
}
# the runtime calls that launch work on the card, as the profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def _per_block(fn):
    """``fn()`` with every block through the per-block program
    (``receiver.SCAN_BLOCKS`` 0): what the chunk graphs are held to."""
    k = rx.SCAN_BLOCKS
    rx.SCAN_BLOCKS = 0
    try:
        return fn()
    finally:
        rx.SCAN_BLOCKS = k


def _departs(got, want) -> str | None:
    """None when every leaf is torch.equal, else where the first differs."""
    for i, (a, b) in enumerate(zip(program.tree_leaves(got),
                                   program.tree_leaves(want))):
        if a.shape != b.shape or not torch.equal(a, b):
            return (f"leaf {i} {tuple(a.shape)}: max abs diff "
                    f"{max_err(a.float(), b.float()) if a.numel() else 0:.3g}")
    return None


def check_programs(rng) -> None:
    """Every block program against the eager block, bit for bit
    (torch.equal on every output arm and state leaf): the receiver's at the
    paths' kernel and arm combinations over 8 chained blocks, each side
    carrying its own state, and the channelizer's (C=64 at 19.2 MS/s) over
    3 blocks."""
    for case, (mode, c, stereo, rds, debug_q, as_float) in \
            PROGRAM_CASES.items():
        mc = cfg.get_mode_config(mode)
        bs = mc.default_block_size(rds and mc.rds is not None)
        lead = (c,) if c > 1 else ()
        iq = torch.from_numpy(rng.integers(0, 256, lead + (8 * bs,),
                                           dtype=np.uint8)).cuda()
        if as_float:
            iq = fir_frontend.normalize_u8(iq)
        coeffs = rx.design_coeffs(mc, device="cuda")
        fn = rx.make_block_fn(mc, stereo, rds, rds_debug_q=debug_q)
        s_eager = s_prog = rx.init_state(mc, lead, device="cuda")
        for b in range(8):
            blk = iq[..., b * bs:(b + 1) * bs].contiguous()
            o_eager, s_eager = rx.process_block(blk, coeffs, s_eager, mc,
                                                stereo, rds,
                                                rds_debug_q=debug_q)
            o_prog, s_prog = fn(blk, coeffs, s_prog)
            bad = _departs(o_prog, o_eager) or _departs(s_prog, s_eager)
            if bad:
                raise AssertionError(f"block program {case}, block {b}: "
                                     f"departs from the eager block ({bad})")
    ch = Channelizer([(k - 32) * 200e3 for k in range(64)], 2 * WIDE_FS,
                     MODE, device="cuda")
    n_bytes = cfg.get_mode_config(MODE).default_block_size(True) * ch.decim
    st = ch.state
    for b in range(3):
        blk = torch.from_numpy(rng.integers(0, 256, n_bytes,
                                            dtype=np.uint8)).cuda()
        out = ch.process(blk)
        want, st = chan._channelize_block(blk, ch.coeffs, st, *ch.mixer,
                                          ch.phase_step(n_bytes // 2),
                                          ch.decim)
        bad = _departs(out, want) or _departs(ch.state, st)
        if bad:
            raise AssertionError(f"channelizer program block {b}: departs "
                                 f"from the eager block ({bad})")
    print("block programs vs the eager block, torch.equal on every output "
          "and state leaf over 8 chained blocks: " + "; ".join(PROGRAM_CASES)
          + "; the channelizer's program, C=64 at 19.2 MS/s, 3 blocks")


# (mode, channels, float input): the chunk graphs' kernel and layout cases
CHUNK_CASES = {
    "u8 C=1 (K1, K2)": (0, 1, False),
    "u8 C=512 (K1, K3)": (0, 512, False),
    "float C=1 (K5, K2)": (0, 1, True),
    "mode 2 (44.1 kHz resampler)": (2, 1, False),
    "mode 1 u8, 50,040-byte blocks (not a multiple of 16 bytes)": (1, 1,
                                                                   False),
}


def check_chunks(rng) -> None:
    """Every chunk program against the per-block program on the same
    blocks, torch.equal on every output arm and the state: ``run_blocks``
    over SCAN_BLOCKS + 3 blocks (one chunk graph, then a tail of 3
    blocks) for each case of CHUNK_CASES (stereo, and RDS where the mode
    has it), and on one ``Receiver`` a host recording as ``process()`` of
    one block, ``run()`` of 2 * SCAN_BLOCKS + 3 (through pinned staging),
    ``process()`` of one more.  The time-sharded and channel-sharded runs
    are held the same way in path (d)."""
    k = rx.SCAN_BLOCKS
    for case, (mode, c, as_float) in CHUNK_CASES.items():
        mc = cfg.get_mode_config(mode)
        rds = mc.rds is not None
        bs = mc.default_block_size(rds)
        lead = (c,) if c > 1 else ()
        xs = torch.from_numpy(rng.integers(0, 256, (k + 3,) + lead + (bs,),
                                           dtype=np.uint8)).cuda()
        if as_float:
            xs = fir_frontend.normalize_u8(xs)
        coeffs = rx.design_coeffs(mc, device="cuda")
        fn = rx.make_block_fn(mc, True, rds)
        got = rx.run_blocks(xs, coeffs, rx.init_state(mc, lead, device="cuda"),
                            mc, True, rds, fn=fn)
        want = _per_block(lambda: rx.run_blocks(
            xs, coeffs, rx.init_state(mc, lead, device="cuda"), mc, True,
            rds))
        bad = _departs(got, want)
        chunks = sorted(cap.blocks for cap in fn.captures)
        if bad or chunks != [1, k]:
            raise AssertionError(f"chunk program {case}: graphs of {chunks} "
                                 f"blocks; vs the per-block program: {bad}")
        del xs, got, want
    mc = cfg.get_mode_config(MODE)
    bs = mc.default_block_size(True)
    n = 2 * k + 5
    iq = rng.integers(0, 256, n * bs, dtype=np.uint8)
    r = rx.Receiver(MODE, stereo=True, with_rds=True, device="cuda")
    got = (r.process(iq[:bs]), r.run(iq[bs:(n - 1) * bs]),
           r.process(iq[(n - 1) * bs:]))
    ref = rx.Receiver(MODE, stereo=True, with_rds=True, device="cuda")
    want = _per_block(lambda: (ref.process(iq[:bs]),
                               ref.run(iq[bs:(n - 1) * bs]),
                               ref.process(iq[(n - 1) * bs:])))
    bad = _departs((got, r.state), (want, ref.state))
    if bad:
        raise AssertionError(f"process/run/process on one Receiver: {bad}")
    print(f"chunk programs (graphs of {k} blocks) vs the per-block program, "
          f"torch.equal on every output and state leaf over {k} + 3 blocks "
          "(a chunk, then a tail): " + "; ".join(CHUNK_CASES)
          + f"; process() -> run() of {n - 2} host blocks -> process() on "
          "one Receiver")


def _busy_ms(intervals: list[tuple[float, float]]) -> float:
    """Union length of (start, end) microsecond intervals, in ms."""
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def _profiled_block(fn, reps: int) -> dict:
    """Under ``torch.profiler`` over ``reps`` blocks: device busy per block
    (the union of the device events' intervals), device events per block,
    and host launches per block (the runtime calls of LAUNCH_CALLS)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    # a span's device side (``utils.profiling.span``) is an annotation
    # over the kernels it launched, not work
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation]
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name in LAUNCH_CALLS]
    return {"busy_ms": _busy_ms([(e.time_range.start, e.time_range.end)
                                 for e in dev]) / reps,
            "events": len(dev) / reps, "host_launches": len(host) / reps}


def _cells(rng) -> dict:
    """The four cells, each as (eager block, program block, reps, the
    programs whose captures it reports, chunk) where chunk is None or
    (the chunk program's call, its blocks K): mode-0 stereo+RDS u8 at C=1
    and C=512, the wideband block (channelizer and receiver) of C=64
    stations at 19.2 MS/s (no chunk: the wideband path streams block by
    block, as the JAX package's does), and the time-sharded step at S=8 (8
    rows of one 115,200-sample float block, K2 pinned as the time-sharded
    path pins it).  A chunk call runs K = ``receiver.SCAN_BLOCKS`` random
    blocks on the card through one replay of ``Program.scan``."""
    mc = cfg.get_mode_config(MODE)
    bs = mc.default_block_size(True)
    k = rx.SCAN_BLOCKS
    cells = {}

    def receiver_cell(name, xs, reps, fused=None):
        blk = xs[0]
        coeffs = rx.design_coeffs(mc, device="cuda")
        fn = rx.make_block_fn(mc, True, True, fused_mixer=fused)
        fk = rx.make_block_fn(mc, True, True, fused_mixer=fused)
        st = [rx.init_state(mc, blk.shape[:-1], device="cuda")] * 3

        def eager():
            st[0] = rx.process_block(blk, coeffs, st[0], mc, True, True,
                                     fused_mixer=fused)[1]

        def graph():
            st[1] = fn(blk, coeffs, st[1])[1]

        def chunk():
            st[2] = fk.scan(xs, coeffs, st[2])[1]
        cells[name] = (eager, graph, reps, [fn, fk], (chunk, k))

    u8 = lambda lead: torch.from_numpy(rng.integers(
        0, 256, (k,) + lead + (bs,), dtype=np.uint8)).cuda()
    receiver_cell("C=1", u8(()), 50)
    receiver_cell("C=512", u8((512,)), 20)
    ch = Channelizer([(k - 32) * 200e3 for k in range(64)], 2 * WIDE_FS,
                     MODE, device="cuda")
    r = rx.Receiver(MODE, stereo=True, with_rds=True, batch_shape=(64,),
                    device="cuda")
    wide = torch.from_numpy(rng.integers(0, 256, bs * ch.decim,
                                         dtype=np.uint8)).cuda()
    step = ch.phase_step(bs * ch.decim // 2)
    wst = [ch.state, r.state]

    def wide_eager():
        out, wst[0] = chan._channelize_block(wide, ch.coeffs, wst[0],
                                             *ch.mixer, step, ch.decim)
        wst[1] = rx.process_block(out, r.coeffs, wst[1], mc, True, True)[1]
    cells["wideband C=64"] = (wide_eager, lambda: r.process(ch.process(wide)),
                              10, [ch.program, r.program], None)
    block_raw = default_block_if(mc, True) * 2 * mc.rf_decim
    receiver_cell(f"time-sharded step S={SHARDS}", fir_frontend.normalize_u8(
        torch.from_numpy(rng.integers(0, 256, (k, SHARDS, block_raw),
                                      dtype=np.uint8)).cuda()), 30,
        fused=rx.fused_mixer_policy(1, 2))
    return cells


def time_programs(smi: str, rng) -> dict:
    """Each cell in turns, eager, program, chunk, chunk, program, eager
    (eager, program, program, eager for the wideband cell), in this one
    call: wall per block by CUDA events over back-to-back calls (a chunk
    call's wall over its K blocks), then under ``torch.profiler`` device
    busy, idle share (1 - busy / wall), device events and host launches
    per block; and each program's capture (its blocks, eager warm-up and
    capture seconds, host clock; bytes its pool reserved)."""
    print(f"card for the block-program timing: {smi}")
    res = {}
    for name, (eager, graph, reps, fns, chunk) in _cells(rng).items():
        order = ("eager", "program", "program", "eager") if chunk is None \
            else ("eager", "program", "chunk", "chunk", "program", "eager")
        turns = []
        for kind in order:
            if kind == "chunk":
                fn, blocks = chunk
                n = -(-2 * reps // blocks)
            else:
                fn, blocks, n = eager if kind == "eager" else graph, 1, reps
            wall = cuda_ms(fn, n, warmup=2) / blocks
            prof = {key: v / blocks for key, v in
                    _profiled_block(fn, 2 if blocks > 1 else 5).items()}
            turns.append(dict(kind=kind, blocks=blocks, wall_ms=wall,
                              idle_share=1.0 - prof["busy_ms"] / wall,
                              **prof))
        caps = [cap._asdict() for f in fns for cap in f.captures]
        for cap in caps:
            cap.update(shape=list(cap["shape"]), dtype=str(cap["dtype"]),
                       device=str(cap["device"]))
        res[name] = {"turns": turns, "captures": caps}
        print(f"block programs [{smi}] {name}: " + "; ".join(
            f"{t['kind']} wall {t['wall_ms']:.4f} ms, busy "
            f"{t['busy_ms']:.4f} ms, idle share {t['idle_share']:.3f}, "
            f"{t['events']:.1f} device events, {t['host_launches']:.2f} "
            f"host launches" for t in turns) + " (per block); capture "
            + ", ".join(
                f"{c['blocks']} block(s): {c['warm_up_s']:.3f} s warm-up + "
                f"{c['capture_s']:.3f} s capture, pool "
                f"{c['pool_bytes'] / 2 ** 20:.1f} MiB (live "
                f"{c['allocated_bytes'] / 2 ** 20:.1f} MiB)" for c in caps))
    print("block programs json: " + json.dumps(res))
    return res


# --- phase 5 ----------------------------------------------------------------


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


def _u8_conv1d_ms(iq: torch.Tensor, h: torch.Tensor, st: torch.Tensor,
                  d: int) -> tuple[float, float]:
    """The library yardstick of K1 and K4: ``conv1d`` at stride ``d`` over
    each arm's normalized, deinterleaved [state | block] (made outside the
    timing), TF32 off.  Returns (ms, max abs difference from K1)."""
    c = iq.shape[0]
    x2 = fir_frontend.normalize_u8(iq.reshape(c, -1, 2).movedim(-1, -2))
    inp = torch.cat([st, x2], dim=-1).reshape(2 * c, 1, -1).contiguous()
    w = h.flip(0).reshape(1, 1, -1).contiguous()
    conv = lambda: torch.nn.functional.conv1d(inp, w, stride=d)
    ms = cuda_ms(conv, 20)
    y, _ = fir_frontend.fir_frontend_u8(iq, h, st, d)
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
        print(f"timing [{smi}]: mode-0 stereo+RDS block program at C={c}: "
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

    # K1 and K4: the call, the kernel alone (device time under
    # torch.profiler), the plain version and conv1d, at C=1 and C=512; the
    # JSON line keeps C=512
    for key, label, kernel, cases, match in (
            ("fir_frontend_u8", "K1 fir_frontend_u8",
             fir_frontend.fir_frontend_u8, k1, "U8In"),
            ("fir_decim_i8", "K4 fir_decim_i8",
             fir_frontend.fir_frontend_u8_deinterleaved, k4, "I8In")):
        for name in ("C=1", "C=512"):
            iq, st = cases["cases"][name]
            call = lambda: kernel(iq, h, st, 10)
            kms = cuda_ms(call, 50)
            dms = device_ms(call, 10, match)
            pms = cuda_ms(lambda: fir_frontend.fir_frontend_u8_plain(
                iq, h, st, 10), 20)
            lib_ms, lib_err = _u8_conv1d_ms(iq, h, st, 10)
            n_out = iq.shape[0] * 2 * (iq.shape[1] // 2 // 10)
            work = _fir_work(iq.numel(), 1, n_out, h.shape[0], st.numel())
            bound, _, bkind, _ = _bound(*work)
            print(f"timing [{smi}]: {label} {name}: call {kms:.4f} ms "
                  f"(kernel alone {dms:.4f} ms), plain {pms:.4f} ms, conv1d "
                  f"{lib_ms:.4f} ms (max abs diff {lib_err:.3g}); bound "
                  f"{bound:.4f} ms ({bkind}), {bound / kms:.1%} of it "
                  f"(kernel alone {bound / dms:.1%}); "
                  f"{'no slower than' if kms <= lib_ms else 'SLOWER than'} "
                  "conv1d")
        record(key, kms, pms, *work, library_ms=lib_ms)

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
        k5_call = lambda: fir_decim.fir_block_decim(x, hk, st, d)
        kms = cuda_ms(k5_call, 20)
        dms = device_ms(k5_call, 10, "F32In")
        pms = cuda_ms(lambda: fir_decim.fir_block_decim_plain(x, hk, st, d),
                      10)
        lib_ms, lib_err = _conv1d_ms(x, hk, st, d)
        work = _fir_work(x.numel(), 4, x.numel() // d, hk.shape[0],
                         st.numel())
        bound, _, bkind, _ = _bound(*work)
        print(f"timing [{smi}]: K5 fir_decim_f32 {name}: call {kms:.4f} ms "
              f"(kernel alone {dms:.4f} ms), plain {pms:.4f} ms, conv1d "
              f"{lib_ms:.4f} ms (max abs diff from K5 {lib_err:.3g}); bound "
              f"{bound:.4f} ms ({bkind}), {bound / kms:.1%} of it; "
              f"{'no slower than' if kms <= lib_ms else 'SLOWER than'} "
              "conv1d")
    record("fir_decim_f32", kms, pms, *work, library_ms=lib_ms)

    _time_wideband(smi, 2, WIDE_FS, WIDE_OFFSETS, rng, 10)
    _time_wideband(smi, 64, 2 * WIDE_FS,
                   [(k - 32) * 200e3 for k in range(64)], rng, 5)
    # K6 as time_sharded_receive calls it on one card: the row-block entry
    # over S=8 shards of one buffer; beside it the table entry over S=8
    # separate buffers, the plain version, and one copy_ of the tails into
    # the prefixes (shard 0's zero fill would be a second call)
    ext, arg, _, halo = k6["cases"]["rows S=8 C=1"]
    rows, plain, _ = k6["cases"]["table S=8 C=1"]
    s, c = SHARDS, 1
    kms = cuda_ms(lambda: khalo.halo_shift_right(arg, halo), 50)
    tms = cuda_ms(lambda: khalo.halo_shift_right(rows, halo), 50)
    pms = cuda_ms(lambda: khalo.halo_fill_plain(plain, halo), 50)
    lib_ms = cuda_ms(lambda: ext[c:, :halo].copy_(ext[:-c, -halo:]), 50)
    flush = torch.empty(16 * 2 ** 20, device="cuda")      # 64 MB > L2
    rb = khalo.row_blocks_of(arg, halo)
    cold = device_ms(lambda: khalo.launch_row_blocks(rb, 0), 20, "halo",
                     before=lambda: flush.fill_(1.0))
    nbytes = 4 * halo * c * (2 * s - 1)
    print(f"timing [{smi}]: K6 halo_shift_right S=8 C=1 halo {halo}: "
          f"row-block call {kms:.4f} ms, table call {tms:.4f} ms, plain "
          f"{pms:.4f} ms, one copy_ {lib_ms:.4f} ms; "
          f"{'no slower than' if kms <= lib_ms else 'SLOWER than'} copy_; "
          f"kernel alone, L2 flushed before each launch: {cold:.4f} ms, "
          f"against the bound {_bound(nbytes, 0.0)[0]:.4f} ms")
    record("halo_shift_right", kms, pms, nbytes, 0.0, library_ms=lib_ms)
    _time_sharding(smi, rng)
    return out


# --- phase 6 ----------------------------------------------------------------

# (mode, capture seconds, seed, with RDS, blocks compared): the JAX
# package's parity cases against its golden receiver
# (tests/test_models_receiver.py:34-60)
GOLDEN_CASES = ((0, 0.3, 11, True, 6), (1, 0.12, 6, False, 3),
                (2, 0.12, 6, False, 3), (3, 0.12, 6, False, 3))
# sdr_tpu's own tolerances there: the linear arms, then the PLL-driven ones
GOLDEN_ATOL = {"fm_demod": 2e-4, "mono": 2e-4, "left": 5e-3, "right": 5e-3,
               "rds_symbols": 5e-3}


def phase_golden() -> None:
    """Phase 6 (a): each case's float and u8 runs on the card against the
    float64 golden receiver, per block and arm."""
    _reset_counts()
    lines = []
    for mode, seconds, seed, rds, n_cmp in GOLDEN_CASES:
        mc = cfg.get_mode_config(mode)
        res = synth.synthesize_fm(duration_s=seconds, mode=mode,
                                  with_stereo=True, with_rds=rds, seed=seed)
        iq = synth.u8_to_float(res.iq_u8)
        bs = mc.default_block_size(rds)
        gold = grx.run_file(iq, mc, stereo=True, with_rds=rds,
                            block_size=bs)[:n_cmp]
        arms = [a for a in GOLDEN_ATOL if rds or a != "rds_symbols"]
        for kind, x in (("float", iq), ("u8", res.iq_u8)):
            outs = rx.Receiver(mode, stereo=True, with_rds=rds,
                               device="cuda").run(x[:len(gold) * bs])
            errs = {}
            for a in arms:
                got = getattr(outs, a).cpu().numpy()
                want = np.stack([getattr(g, a) for g in gold])
                if got.shape != want.shape:
                    raise AssertionError(f"golden mode {mode} {kind}: {a} "
                                         f"shape {got.shape}, golden "
                                         f"{want.shape}")
                errs[a] = float(np.abs(got - want).max())
            bad = {a: e for a, e in errs.items() if not e <= GOLDEN_ATOL[a]}
            if bad:
                raise AssertionError(f"golden mode {mode} {kind}: max abs "
                                     f"err {bad} over atol {GOLDEN_ATOL}")
            lines.append(f"mode {mode} {kind} {len(gold)} blocks: "
                         + ", ".join(f"{a} {e:.3g}" for a, e in errs.items()))
    launches = _read_counts("golden parity", (
        "fir_frontend_u8", "fir_decim_f32", "pll_angles", "pll_mixer"))
    ran = {k: v for k, v in launches.items() if v}
    print(f"golden parity on the card (max abs err against "
          f"golden.receiver.run_file, atol {GOLDEN_ATOL}): "
          + "; ".join(lines) + f"; launches {ran}")


def phase_profile(smi: str) -> None:
    """Phase 6 (b): the per-arm profile of each mode at C=1, then the
    stages of mode 0 at C=512."""
    for mode in range(4):
        p = profiling.profile_stages(mode=mode, n_blocks=20, device="cuda")
        if not all(np.isfinite(v) for v in p.values()) or p["mono_ms"] <= 0:
            raise AssertionError(f"profile_stages mode {mode}: {p}")
        print(f"profile [{smi}] mode {mode} C=1, ms per block (block "
              "program): " + ", ".join(f"{k} {v:.4f}" for k, v in p.items()))
    res = _script("torch_profile_stages").profile_case(
        MODE, 512, torch.device("cuda"))
    t = res["timings_ms"]
    if not (res["stage_sum_default_kernels_ms"] > 0
            and t["chunk_graph"] > 0):
        raise AssertionError(f"stage profile mode {MODE} C=512: {t}")
    print(f"stages [{smi}] mode {MODE} C=512 ({res['pll_kernel']}), ms per "
          "block: " + ", ".join(f"{n} {v:.4f}" for n, v in t.items())
          + f"; stage sum {res['stage_sum_default_kernels_ms']:.4f}, less "
          f"the consuming sums {res['stage_sum_less_sums_ms']}")


# --- phase 7 ----------------------------------------------------------------

SHORT_CAPTURE = 100     # bytes: less than one block in every mode
ZERO_BATCH = 512
TIMED_CALLS = 3         # of run_blocks_scan and of run_blocks, in turns


def _wall_s(fn):
    """``fn()``'s result and its host wall seconds, the card idle before
    and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _clone(tree):
    return program.tree_map(torch.clone, tree)


def _check_empty(label: str, outs, lead: tuple, lengths) -> None:
    """Every arm empty, float32 on the card, with ``lengths``' out
    lengths."""
    for name, n in zip(outs._fields, lengths):
        a = getattr(outs, name)
        if (tuple(a.shape) != lead + (n,) or a.device.type != "cuda"
                or a.dtype != torch.float32):
            raise AssertionError(f"{label}: {name} {tuple(a.shape)} "
                                 f"{a.dtype} on {a.device}, want "
                                 f"{lead + (n,)} float32 on cuda")


def _scan_full_width(smi: str, capture, rng) -> str:
    """Phase 7 (a): ``run_blocks_scan`` on SCAN_BLOCKS + 2 blocks of the
    C=512 u8 batch on the card."""
    mc = cfg.get_mode_config(MODE)
    bs = mc.default_block_size(True)
    n = rx.SCAN_BLOCKS + 2
    batch = _serving_batch(capture.iq_u8, ZERO_BATCH, n * bs, rng)
    blocks = torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        batch.reshape(ZERO_BATCH, n, bs), 1, 0))).cuda()
    del batch
    coeffs = rx.design_coeffs(mc, device="cuda")
    init = lambda: rx.init_state(mc, (ZERO_BATCH,), device="cuda")
    state = init()
    before = _clone(state)

    _reset_counts()
    (outs, st), first_s = _wall_s(lambda: rx.run_blocks_scan(
        blocks, coeffs, state, MODE, True, True))
    launches = _read_counts("run_blocks_scan", ("fir_frontend_u8",
                                                "pll_mixer"))
    first_captures = program.counts["captures"]
    bad = _departs(state, before)
    if bad:
        raise AssertionError(f"run_blocks_scan changed the caller's state: "
                             f"{bad}")
    want = rx.run_blocks(blocks, coeffs, init(), mc, True, True)
    bad = _departs((outs, st), want)
    if bad:
        raise AssertionError(f"run_blocks_scan vs run_blocks: {bad}")
    del want

    # a repeat call chained from the first call's state: no capture, and
    # the first call's outputs and state stay as they were
    kept = _clone((outs, st))
    program.reset_counts()
    (outs2, st2), repeat_s = _wall_s(lambda: rx.run_blocks_scan(
        blocks, coeffs, st, MODE, True, True))
    repeat_captures = program.counts["captures"]
    bad = _departs((outs, st), kept)
    if bad or repeat_captures:
        raise AssertionError(f"run_blocks_scan repeat call: {repeat_captures}"
                             f" captures; the first call's results: {bad}")
    del outs2, st2, kept

    # wall per block in turns: run_blocks_scan (its kept program) and
    # run_blocks on a program of its own, captured before the turns
    fn = rx.make_block_fn(mc, True, True)
    rx.run_blocks(blocks, coeffs, init(), mc, True, True, fn=fn)
    scan_ms, run_ms = [], []
    for _ in range(TIMED_CALLS):
        scan_ms.append(_wall_s(lambda: rx.run_blocks_scan(
            blocks, coeffs, state, MODE, True, True))[1] * 1e3 / n)
        fresh = init()
        run_ms.append(_wall_s(lambda: rx.run_blocks(
            blocks, coeffs, fresh, mc, True, True, fn=fn))[1] * 1e3 / n)
    caps = rx._scan_program(mc, True, True).captures
    cap_s = ", ".join(f"{c.blocks} blocks: warm-up {c.warm_up_s:.3f} s + "
                      f"capture {c.capture_s:.3f} s" for c in caps)
    return (f"(a) run_blocks_scan mode {MODE} stereo+RDS u8 C={ZERO_BATCH} x "
            f"{n} blocks torch.equal to run_blocks, the caller's state "
            f"unchanged; first call {first_s:.3f} s with {first_captures} "
            f"graph captures ({cap_s}); repeat call {repeat_s:.4f} s, "
            f"{repeat_captures} captures, the first call's outputs and state "
            f"unchanged; launches {launches}; [{smi}] wall ms per block in "
            f"turns, run_blocks_scan {[round(v, 4) for v in scan_ms]}, "
            f"run_blocks {[round(v, 4) for v in run_ms]}")


def _zero_blocks() -> str:
    """Phase 7 (b): runs of zero blocks on the card launch nothing and
    return empty arms on the card with the states as they were."""
    mc = cfg.get_mode_config(MODE)
    bs = mc.default_block_size(True)
    lengths = rx.block_out_lengths(mc, bs, True, True)
    short = np.arange(SHORT_CAPTURE, dtype=np.uint8)
    _reset_counts()
    for c in (1, ZERO_BATCH):
        lead = (c,) if c > 1 else ()
        r = rx.Receiver(MODE, stereo=True, with_rds=True, batch_shape=lead,
                        device="cuda")
        state, before = r.state, _clone(r.state)
        outs = r.run(np.broadcast_to(short, lead + short.shape).copy())
        _check_empty(f"Receiver.run C={c}", outs, (0,) + lead, lengths)
        bad = _departs(r.state, before)
        if r.state is not state or bad:
            raise AssertionError(f"Receiver.run C={c} of zero blocks changed "
                                 f"its state: {bad}")
    state = rx.init_state(mc, (ZERO_BATCH,), device="cuda")
    before = _clone(state)
    outs, st = rx.run_blocks_scan(
        torch.empty((0, ZERO_BATCH, bs), dtype=torch.uint8, device="cuda"),
        rx.design_coeffs(mc, device="cuda"), state, MODE, True, True)
    _check_empty("run_blocks_scan", outs, (0, ZERO_BATCH), lengths)
    bad = _departs((state, st), (before, before))
    if bad:
        raise AssertionError(f"run_blocks_scan of zero blocks: {bad}")
    shards = channel_sharded_run(np.zeros((8, SHORT_CAPTURE), np.uint8),
                                 Mesh(["cuda:0"] * 2, ("ch",)), MODE,
                                 stereo=True, with_rds=True)
    init = rx.init_state(mc, (4,), device="cuda")
    for d, (outs, st) in enumerate(zip(shards.outputs, shards.states)):
        _check_empty(f"channel_sharded_run shard {d}", outs, (0, 4), lengths)
        bad = _departs(st, init)
        if bad:
            raise AssertionError(f"channel_sharded_run shard {d}: {bad}")
    torch.cuda.synchronize()
    launches = {name: spec["counter"].launches
                for name, spec in KERNELS.items()}
    if any(launches.values()) or any(program.counts.values()):
        raise AssertionError(f"zero blocks launched {launches}, programs "
                             f"{program.counts}")
    return (f"(b) zero blocks on the card: Receiver.run of {SHORT_CAPTURE} "
            f"bytes at C=1 and C={ZERO_BATCH}, run_blocks_scan of (0, "
            f"{ZERO_BATCH}, {bs}), channel_sharded_run of 8 channels over 2 "
            f"shards: arms {dict(zip(rx.BlockOutputs._fields, lengths))} "
            "long, float32 on cuda, states as they were; launches "
            f"{launches}, programs {program.counts}")


def _pll_atan2() -> str:
    """Phase 7 (c): the literal atan2 PLL on the card against K2's path
    over two chained blocks of the tests/test_ops.py tone."""
    fs, n = 240e3, 2000
    t = np.arange(2 * n) / fs
    x = torch.from_numpy((0.4 * np.sin(2 * np.pi * 19020 * t + 0.3)
                          + 0.01 * np.sin(2 * np.pi * 700 * t)
                          ).astype(np.float32)).cuda()
    params = tpll.PllParams(freq=19e3, fs=fs, nco_scale=2.0)

    def chain(block_fn) -> list:
        st, outs = tpll.pll_init(nco_q_last=0.0, device="cuda"), []
        for b in range(2):
            i, q, st = block_fn(x[b * n:(b + 1) * n], st, params)
            outs.append((i, q))
        return outs

    _reset_counts()
    atan2, atan2_s = _wall_s(lambda: chain(
        lambda *a: tpll.pll_block(*a, use_atan2=True)))
    atan2_launches = {name: spec["counter"].launches
                      for name, spec in KERNELS.items()}
    if any(atan2_launches.values()):
        raise AssertionError(f"pll_block(use_atan2=True) launched "
                             f"{atan2_launches}")
    err = max(max_err(a, b) for got, want in
              zip(atan2, chain(pll_cuda.pll_block_kernel))
              for a, b in zip(got, want))
    k2 = pll_cuda.pll_angles.launches
    if not k2 or not err <= PLL_ATOL:
        raise AssertionError(f"atan2 PLL vs K2: max abs err {err:.3g} (atol "
                             f"{PLL_ATOL}), K2 launches {k2}")
    return (f"(c) pll_block(use_atan2=True) on the card, 2 x {n} samples, "
            f"launches nothing ({atan2_s:.3f} s), vs K2's path "
            f"(pll_cuda.pll_block_kernel, {k2} launches): max abs err "
            f"{err:.3g} on nco_i/nco_q (atol {PLL_ATOL})")


def phase_scan_and_zero_blocks(smi: str, capture) -> None:
    """Phase 7: run_blocks_scan at full width, zero-block runs, and the
    literal atan2 PLL, on one line."""
    print("scan and zero blocks: " + "; ".join((
        _scan_full_width(smi, capture, np.random.default_rng(SEED + 8)),
        _zero_blocks(), _pll_atan2())))


# --- phase 8 ----------------------------------------------------------------

BENCH_CHANNELS = [512]
BENCH_BLOCKS = 16
BENCH_REPS = 2


def phase_bench(smi: str) -> None:
    """Phase 8: ``bench_torch.bench`` at a reduced size, mode 0 only; its
    gates raise."""
    _reset_counts()
    record, detail = bench_torch.bench(
        "cuda", BENCH_BLOCKS, BENCH_REPS, BENCH_CHANNELS, modes=[0],
        c_mode=128, latency_calls=bench_torch.LATENCY_CALLS)
    launches = _read_counts("bench_torch", ("fir_frontend_u8", "pll_angles",
                                            "pll_mixer"))
    if not (math.isfinite(record["value"]) and record["value"] > 0):
        raise AssertionError(f"bench_torch: value {record['value']}")
    WORK.mkdir(parents=True, exist_ok=True)
    (WORK / "bench_detail.json").write_text(json.dumps(detail, indent=2))
    row = detail["aggregate_sweep"][0]
    print(f"bench_torch: {BENCH_BLOCKS} blocks a call, best of "
          f"{BENCH_REPS}: single stream {detail['single_stream_msps']:.1f} "
          "MS/s ("
          f"{detail['single_stream_ms_per_block_device']:.4f} ms/blk), "
          f"C={row['channels']} {row['msps']:.1f} MS/s "
          f"({row['ms_per_block']:.4f} ms/blk), row 0 max abs err "
          f"{row['row0_max_abs_err']}; dispatch latency "
          f"{detail['dispatch_latency_ms']:.4f} ms; launches {launches}")
    print(f"bench_torch card: {smi}")
    print(f"bench_torch record: {json.dumps(record)}")


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
    phase_multi_process(main_path["capture"], sharded["capture"])
    check_programs(np.random.default_rng(SEED + 5))
    check_chunks(np.random.default_rng(SEED + 7))
    time_programs(card(), np.random.default_rng(SEED + 6))
    timing = phase_timing(smi, k1, pll, k4, k5, k6)
    phase_golden()
    phase_profile(smi)
    phase_scan_and_zero_blocks(smi, main_path["capture"])
    phase_bench(smi)
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
