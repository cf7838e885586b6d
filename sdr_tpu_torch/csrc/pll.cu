// PLL recurrence kernels: K2 `pll_angles` and K3 `pll_mixer`, and the
// chain-floor probe `sdr_pll_chain_floor`.
//
// Replaces (sdr_tpu/ops/pallas_pll.py):
//   K2  _pll_args_pallas / _kernel, reached by pll_block_fused_pallas and
//       pll_block_pallas: the recurrence emits the oscillator angle of
//       every step; cos/sin, the N+1 concat and the new PllState are
//       computed outside (sdr_tpu_torch/ops/pll_cuda.py).
//   K3  pll_mixer_fused_pallas / _mix_kernel: the same recurrence plus the
//       NCO cos and the mixer product mixer[t] = nco[t-1] * mix[t] * 2,
//       with nco[-1] the carried previous NCO, so the angle and NCO arrays
//       never reach device memory.
//
// What bounds it on this card: the recurrence is serial in time, so a
// block of N steps costs at least N times the latency of one step of the
// feedback chain (aw -> err -> integrator, phase -> wrap -> arg -> turns ->
// aw).  Bytes (one float in, one out per lane and step; two in for K3) and
// operations are far below the card's rates.  `sdr_pll_chain_floor` runs
// that chain alone, inputs in registers and no memory traffic per step,
// and its time is the floor both kernels are held against (PERF.md).
//
// The design, and what each part removes from the chain:
//
// * Staging (memory off the chain).  A loader warp copies the next tiles
//   of T = kRows steps x 32 lanes of `xs` (and, for K3, `mix`) into a ring
//   of kStages shared-memory stages, one mbarrier per stage counting the
//   bytes: one TMA copy per tile through a 2-D tensor map of the
//   time-major (N, ld) array, or, when one block holds every lane (ld <=
//   32) and a tile is one contiguous span, one cp.async.bulk.  Rows are ld
//   floats apart, ld a multiple of 4 (LaneLayout pads the lanes), as
//   tensor maps and bulk copies need 16-byte strides.  The chain warp
//   waits once per tile and then reads its input from shared memory ahead
//   of use (one step for K2, a group of eight for K3), so no load sits
//   between two steps.  Outputs
//   leave through shared memory too: K2's angles are stored by a helper
//   warp with coalesced 16-byte stores; K3's products by its NCO warps.
// * Lanes across the card.  One chain warp per 32 lanes, one block per
//   chain warp: 1,024 lanes run on 32 SMs.
// * Exact shortcuts, and no branch in a step.  The phase wrap
//   torch.remainder(x, m) (fmodf, plus m for a negative remainder) is x on
//   [0, m), x - m on [m, 2m) (exact by Sterbenz's lemma), x + m rounded on
//   (-m, 0).  The turn count floor(fl(fl(arg / 2pi) + 0.5)) is a
//   non-decreasing step function of arg, so on [0, 2m], where every arg of
//   the chain lies, it is the number of breakpoints b1..b4 <= arg.  The
//   breakpoints are computed on the host in float32 (the least float whose
//   turn count reaches k) and passed as constant rows.  Both shortcuts give
//   the same bits as the operations they replace.  A compare that feeds a
//   predicated select or a branch costs the chain far more than an add on
//   this card, so every compare of a step writes 1.0 or 0.0 to a register
//   (PTX set.f32) and is consumed by adds and exact multiply-adds: the
//   wrap is x - m * ([x >= m] - [x < 0]) rounded once, the turn count a
//   sum of four compares, the detector's pi - aw / -pi - aw a multiply-add
//   on [aw > 0].  Each step only records whether a value left the
//   shortcuts' ranges; a warp that finds one at the end of a tile replays
//   the tile from its saved carry with selects, fmodf and the division
//   where they are needed (NaN included), so no branch sits on the chain.
// * K3's NCO off the chain.  The chain warp writes each step's angle to a
//   shared-memory ring and goes on; NCO warps of the same block compute
//   cos(arg * scale + adj) and the mixer product over each finished tile
//   with all their threads and store it.  Row 0 of each tile's angle ring
//   is the previous tile's last angle, so nco[t-1] needs no carry between
//   the NCO warps.
//
// Rounding: the plain PyTorch loop (sdr_tpu_torch/ops/pll.py) rounds each
// operation on its own.  Every add, multiply and divide of the recurrence
// here is an explicit round-to-nearest intrinsic, which nvcc never
// contracts into an FMA, and the library is built with --fmad=false, so
// the kernels are bit-equal to the plain loop on the card.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr float kPi = 3.14159265358979323846f;      // float(pi)
constexpr float kHalfPi = 1.57079632679489661923f;  // float(pi / 2)
constexpr float kTwoPi = 6.28318530717958647692f;   // float(2 pi)

constexpr int kLanes = 32;                  // lanes per block: one chain warp
constexpr int kRows = 64;                   // time steps per tile
constexpr int kStages = 4;                  // tiles in the shared-memory ring
constexpr int kTile = kRows * kLanes;       // floats of one staged tile
constexpr int kArgTile = (kRows + 1) * kLanes;  // K3 angle ring: + carried row
constexpr int kNcoWarps = 12;               // K3's NCO / mixer warps
constexpr int kBarBytes = 128;              // 3 x kStages mbarriers, padded
constexpr int kMaxDevices = 64;

// Warp roles.  K2: warp 0 runs the chain, warp 1 stores the angles, warp 2
// loads.  K3 (16 warps): warp 0 runs the chain and warp 4 loads, on the
// scheduler they share (warp % 4), where the loader mostly sleeps on its
// barriers and warps 8 and 12 do nothing; the twelve warps on the other
// three schedulers compute the NCO and mixer, each cosf's latency hidden
// by the others.
template <bool MIX>
struct Shape {
  static constexpr int kHelpers = MIX ? kNcoWarps : 1;
  static constexpr int kLoader = MIX ? 4 : 2;
  static constexpr int kThreads = MIX ? 32 * 16 : 32 * 3;
  // steps whose inputs the chain reads ahead, as one group: with fewer,
  // nvcc issues K3's shared-memory loads late enough that their latency
  // lands on the chain; K2 ran fastest reading one step ahead (PERF.md)
  static constexpr int kAhead = MIX ? 8 : 1;
  static constexpr int kSmem =
      kBarBytes + static_cast<int>(sizeof(float)) * kStages *
                      (MIX ? 2 * kTile + kArgTile : 2 * kTile);
};

// --- mbarriers and bulk copies (bulk_copy.cuh) ------------------------------

using bulk::bar_arrive;
using bulk::bar_expect;
using bulk::bar_init;
using bulk::bar_wait;
using bulk::smem_addr;

// The [kRows x kLanes] box of `map` at lane `c0`, step `c1` into shared
// memory (rows kLanes floats apart; outside the array zeros), counted on
// `bar`: one TMA copy.
__device__ __forceinline__ void tile_load(float* dst, const CUtensorMap* map,
                                          int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// --- the feedback chain ------------------------------------------------------

// 1.0f when the comparison holds, else 0.0f: a compare that writes a
// register, which the chain consumes with adds and multiplies instead of a
// predicated select or a branch.
__device__ __forceinline__ float set_gt(float a, float b) {
  float d;
  asm("set.gt.f32.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float set_ge(float a, float b) {
  float d;
  asm("set.ge.f32.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float set_lt(float a, float b) {
  float d;
  asm("set.lt.f32.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// torch.remainder(x, m) for m > 0 outside the fast range (and NaN)
__device__ __noinline__ float remainder_slow(float x, float m) {
  const float r = fmodf(x, m);
  return r < 0.0f ? __fadd_rn(r, m) : r;
}

// floor(fl(fl(arg / 2pi) + 0.5)) outside [0, 2m] (and NaN)
__device__ __noinline__ float turns_slow(float arg) {
  return floorf(__fadd_rn(__fdiv_rn(arg, kTwoPi), 0.5f));
}

// One lane's loop state and constants.
//   carry rows: 0 integrator, 1 phase estimate, 2 oscillator phase, 3 last
//     angle wrapped to [-pi, pi); K3 adds 4 previous NCO value, 5 last angle.
//   const rows: 0 kp, 1 ki, 2 w, 3 modulus m; K3 adds 4 NCO scale, 5 phase
//     adjust; then the four turn breakpoints (rows 4-7, K3 6-9).
struct Chain {
  float integ, phase, psi, aw;
  float kp, ki, w, m, m2, b1, b2, b3, b4;

  __device__ Chain(const float* carry0, const float* consts, int lanes,
                   int l, int bp_row) {
    integ = carry0[l];
    phase = carry0[lanes + l];
    psi = carry0[2 * lanes + l];
    aw = carry0[3 * lanes + l];
    kp = consts[l];
    ki = consts[lanes + l];
    w = consts[2 * lanes + l];
    m = consts[3 * lanes + l];
    m2 = __fmul_rn(m, 2.0f);  // exact
    b1 = consts[bp_row * lanes + l];
    b2 = consts[(bp_row + 1) * lanes + l];
    b3 = consts[(bp_row + 2) * lanes + l];
    b4 = consts[(bp_row + 3) * lanes + l];
  }

  // torch.remainder(x, m) for x in (-m, 2m): x - m * s rounded once, s
  // = 1 on [m, 2m) (exact), -1 on (-m, 0) (x + m rounded), else 0 (x, the
  // sign of zero kept: x + -0)
  __device__ __forceinline__ float wrap_fast(float x) const {
    return __fmaf_rn(-m, __fsub_rn(set_ge(x, m), set_lt(x, 0.0f)), x);
  }

  // floor(fl(fl(arg / 2pi) + 0.5)) for arg in [0, 2m]: the breakpoints
  // at or below arg, four compares and adds (exact small integers)
  __device__ __forceinline__ float turns_fast(float arg) const {
    return __fadd_rn(__fadd_rn(set_ge(arg, b1), set_ge(arg, b2)),
                     __fadd_rn(set_ge(arg, b3), set_ge(arg, b4)));
  }

  // The phase detector, as ops/pll.py writes it: -aw for xk > 0, pi - aw
  // or -pi - aw (by the sign of aw) for xk < 0, and for xk == 0 (or NaN)
  // 0 when |aw| < pi/2, else -pi or pi.  `pos` and `nz` depend on the input
  // alone; the rest is compares written to registers, adds and exact
  // multiply-adds: c = -0 for xk > 0 (so -0 - aw is -aw, zeros included),
  // else 2pi * [aw > 0] - pi.
  __device__ __forceinline__ float error(float xk) const {
    const bool pos = xk > 0.0f;
    const bool nz = pos || xk < 0.0f;
    const float up = set_gt(aw, 0.0f);
    const float c = __fmaf_rn(pos ? -0.0f : kTwoPi, up, pos ? -0.0f : -kPi);
    const float e = __fsub_rn(c, aw);
    const float far = set_ge(fabsf(aw), kHalfPi);   // 0 when |aw| < pi/2
    const float e0 = __fadd_rn(__fmul_rn(__fmaf_rn(-kTwoPi, up, kPi), far),
                               0.0f);
    return nz ? e : e0;
  }

  // The same detector with selects, exact for every aw (NaN included).
  __device__ float error_exact(float xk) const {
    const float e_neg = aw > 0.0f ? __fsub_rn(kPi, aw) : __fsub_rn(-kPi, aw);
    const float e_zero =
        fabsf(aw) < kHalfPi ? 0.0f : (aw > 0.0f ? -kPi : kPi);
    return xk > 0.0f ? -aw : (xk < 0.0f ? e_neg : e_zero);
  }

  // One step on input sample xk through the shortcuts alone, with no
  // branch and no predicated select on the chain; returns the oscillator
  // angle.  `bad` is set when a wrapped value or the angle left the range
  // where the shortcuts are exact (NaN included): the caller then replays
  // the steps from a saved carry with step_exact.
  __device__ __forceinline__ float step_fast(float xk, bool& bad) {
    const float err = error(xk);
    integ = __fadd_rn(integ, __fmul_rn(ki, err));
    const float x = __fadd_rn(__fadd_rn(phase, __fmul_rn(kp, err)), integ);
    const float y = __fadd_rn(psi, w);
    phase = wrap_fast(x);
    psi = wrap_fast(y);
    const float arg = __fadd_rn(psi, phase);
    aw = __fsub_rn(arg, __fmul_rn(kTwoPi, turns_fast(arg)));
    bad |= !(x > -m && x < m2) | !(y > -m && y < m2) |
           !(arg >= 0.0f && arg <= m2);
    return arg;
  }

  // The same step, exact for every input: the shortcuts where they hold,
  // fmodf and the division elsewhere.
  __device__ float step_exact(float xk) {
    const float err = error_exact(xk);
    integ = __fadd_rn(integ, __fmul_rn(ki, err));
    const float x = __fadd_rn(__fadd_rn(phase, __fmul_rn(kp, err)), integ);
    const float y = __fadd_rn(psi, w);
    phase = (x > -m && x < m2) ? wrap_fast(x) : remainder_slow(x, m);
    psi = (y > -m && y < m2) ? wrap_fast(y) : remainder_slow(y, m);
    const float arg = __fadd_rn(psi, phase);
    const float t =
        (arg >= 0.0f && arg <= m2) ? turns_fast(arg) : turns_slow(arg);
    aw = __fsub_rn(arg, __fmul_rn(kTwoPi, t));
    return arg;
  }

  __device__ void store(float* carry_out, int lanes, int l) const {
    carry_out[l] = integ;
    carry_out[lanes + l] = phase;
    carry_out[2 * lanes + l] = psi;
    carry_out[3 * lanes + l] = aw;
  }
};

// --- warp roles --------------------------------------------------------------

struct Ring {
  uint64_t* full;   // loader -> readers: the tile's bytes have landed
  uint64_t* empty;  // readers -> loader: the stage may be refilled
  uint64_t* ready;  // chain -> helpers: the tile's angles are in the ring
  float* xs;        // kStages x kTile
  float* mix;       // kStages x kTile (K3)
  float* res;       // K2: kStages x kTile angles; K3: kStages x kArgTile
};

// The loader warp (one thread issues): keeps the ring full.  A block that
// holds every lane (ld <= 32) copies a tile as one contiguous span with
// cp.async.bulk, rows `stride` = ld floats apart in shared memory; the
// blocks of a wider array each copy their [kRows x 32] box with one TMA
// copy through a tensor map, rows `stride` = 32 floats apart.
template <bool MIX>
__device__ void load_tiles(const Ring& ring, const float* xs,
                           const float* mix, const CUtensorMap* map_x,
                           const CUtensorMap* map_m, int n, int ld,
                           int lane0, int width, int lane) {
  if (lane != 0) return;
  const bool whole = width == ld;
  const int tiles = (n + kRows - 1) / kRows;
  for (int i = 0; i < tiles; ++i) {
    const int slot = i % kStages;
    if (i >= kStages) bar_wait(&ring.empty[slot], ((i / kStages) + 1) & 1);
    const int t0 = i * kRows;
    const int rows = min(kRows, n - t0);
    // a TMA box always lands whole, its part outside the array as zeros
    const uint32_t bytes = whole ? rows * width * sizeof(float)
                                 : kTile * sizeof(float);
    bar_expect(&ring.full[slot], (MIX ? 2 : 1) * bytes);
    float* dx = ring.xs + slot * kTile;
    float* dm = ring.mix + slot * kTile;
    if (whole) {
      const size_t at = static_cast<size_t>(t0) * ld;
      bulk::load(dx, xs + at, bytes, &ring.full[slot]);
      if (MIX) bulk::load(dm, mix + at, bytes, &ring.full[slot]);
    } else {
      tile_load(dx, map_x, lane0, t0, &ring.full[slot]);
      if (MIX) tile_load(dm, map_m, lane0, t0, &ring.full[slot]);
    }
  }
}

// Warp 0: the recurrence, one lane per PLL lane.  Lanes at and beyond
// `width` (a block narrower than a warp) step along on the last real
// lane's constants and store nothing.
template <bool MIX>
__device__ void run_chain(const Ring& ring, const float* carry0,
                          const float* consts, float* carry_out, int n,
                          int lanes, int lane0, int width, int stride,
                          int lane) {
  const int g = lane0 + lane;
  const int l = min(g, lanes - 1);
  Chain c(carry0, consts, lanes, l, MIX ? 6 : 4);
  const bool keep = lane < width;
  const int tiles = (n + kRows - 1) / kRows;
  float arg = 0.0f;
  for (int i = 0; i < tiles; ++i) {
    const int slot = i % kStages;
    bar_wait(&ring.full[slot], (i / kStages) & 1);
    const int rows = min(kRows, n - i * kRows);
    const float* xt = ring.xs + slot * kTile;
    float* at;
    if (MIX) {
      at = ring.res + slot * kArgTile;
      if (keep) at[lane] = arg;           // row 0: the previous tile's last
      at += stride;
    } else {
      at = ring.res + slot * kTile;
    }
    // the inputs of the next kAhead steps are read while these run
    constexpr int G = Shape<MIX>::kAhead;
    const Chain c0 = c;
    const float arg0 = arg;
    bool bad = false;
    const int whole = rows / G * G;
    float xg[G];
#pragma unroll
    for (int j = 0; j < G; ++j) xg[j] = xt[j * stride + lane];
    for (int r = 0; r < whole; r += G) {
      float xn[G];
#pragma unroll
      for (int j = 0; j < G; ++j)
        xn[j] = xt[min(r + G + j, kRows - 1) * stride + lane];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        arg = c.step_fast(xg[j], bad);
        if (keep) at[(r + j) * stride + lane] = arg;
      }
#pragma unroll
      for (int j = 0; j < G; ++j) xg[j] = xn[j];
    }
    for (int r = whole; r < rows; ++r) {  // the tail of a short last tile
      arg = c.step_fast(xt[r * stride + lane], bad);
      if (keep) at[r * stride + lane] = arg;
    }
    if (__any_sync(0xffffffffu, bad && g < lanes)) {  // cold: replay exactly
      c = c0;
      arg = arg0;
      for (int r = 0; r < rows; ++r) {
        arg = c.step_exact(xt[r * stride + lane]);
        if (keep) at[r * stride + lane] = arg;
      }
    }
    bar_arrive(&ring.ready[slot]);
    bar_arrive(&ring.empty[slot]);
  }
  if (g < lanes) {
    c.store(carry_out, lanes, g);
    if (MIX) {
      const float scale = consts[4 * lanes + g];
      const float adj = consts[5 * lanes + g];
      carry_out[4 * lanes + g] = cosf(__fadd_rn(__fmul_rn(arg, scale), adj));
      carry_out[5 * lanes + g] = arg;
    }
  }
}

// K2's warp 1: each finished tile of angles to global memory, 16 bytes a
// thread (width, stride and ld are multiples of 4).
__device__ void store_angles(const Ring& ring, float* out, int n, int ld,
                             int lane0, int width, int stride, int lane) {
  const int tiles = (n + kRows - 1) / kRows;
  const int q4 = width / 4;
  for (int i = 0; i < tiles; ++i) {
    const int slot = i % kStages;
    bar_wait(&ring.ready[slot], (i / kStages) & 1);
    const int t0 = i * kRows;
    const int rows = min(kRows, n - t0);
    const float4* src = reinterpret_cast<const float4*>(ring.res + slot * kTile);
    float* dst = out + static_cast<size_t>(t0) * ld + lane0;
    for (int q = lane; q < rows * q4; q += 32) {
      const int r = q / q4;
      reinterpret_cast<float4*>(dst + static_cast<size_t>(r) * ld)[q - r * q4] =
          src[r * (stride / 4) + q - r * q4];
    }
    bar_arrive(&ring.empty[slot]);
  }
}

// K3's NCO warps (`part` 0..kNcoWarps-1): for every row of a finished tile,
// the NCO of the previous step's angle and the mixer product, stored
// coalesced.
__device__ void nco_mixer(const Ring& ring, const float* carry0,
                          const float* consts, float* out, int n, int lanes,
                          int ld, int lane0, int width, int stride, int lane,
                          int part) {
  const int l = min(lane0 + lane, lanes - 1);
  const float scale = consts[4 * lanes + l];
  const float adj = consts[5 * lanes + l];
  const float prev0 = carry0[4 * lanes + l];
  const bool keep = lane < width;
  const int tiles = (n + kRows - 1) / kRows;
  for (int i = 0; i < tiles; ++i) {
    const int slot = i % kStages;
    bar_wait(&ring.ready[slot], (i / kStages) & 1);
    bar_wait(&ring.full[slot], (i / kStages) & 1);
    const int t0 = i * kRows;
    const int rows = min(kRows, n - t0);
    const float* at = ring.res + slot * kArgTile;  // row r: angle of t0+r-1
    const float* mt = ring.mix + slot * kTile;
    if (keep) {
      for (int r = part; r < rows; r += kNcoWarps) {
        const float prev =
            (i == 0 && r == 0)
                ? prev0
                : cosf(__fadd_rn(__fmul_rn(at[r * stride + lane], scale), adj));
        out[static_cast<size_t>(t0 + r) * ld + lane0 + lane] =
            __fmul_rn(__fmul_rn(prev, mt[r * stride + lane]), 2.0f);
      }
    }
    bar_arrive(&ring.empty[slot]);
  }
}

// xs, mix, out: (n, ld) time-major, rows ld floats apart; lanes <= ld.
// carry0, carry_out, consts: (rows, lanes).  One block per 32 lanes.
// map_x, map_m: tensor maps of xs and mix when ld > 32.
template <bool MIX>
__global__ void __launch_bounds__(Shape<MIX>::kThreads)
    pll_kernel(const float* __restrict__ xs, const float* __restrict__ mix,
               const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_m,
               const float* __restrict__ carry0,
               const float* __restrict__ consts, float* __restrict__ out,
               float* __restrict__ carry_out, int n, int lanes, int ld) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kHelpers = Shape<MIX>::kHelpers;
  Ring ring;
  ring.full = reinterpret_cast<uint64_t*>(smem);
  ring.empty = ring.full + kStages;
  ring.ready = ring.empty + kStages;
  ring.xs = reinterpret_cast<float*>(smem + kBarBytes);
  ring.mix = ring.xs + kStages * kTile;
  ring.res = MIX ? ring.mix + kStages * kTile : ring.mix;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int lane0 = blockIdx.x * kLanes;
  const int width = min(kLanes, ld - lane0);
  const int stride = width == ld ? width : kLanes;   // of the staged tiles
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&ring.full[s], 1);
      bar_init(&ring.empty[s], 32 * (1 + kHelpers));
      bar_init(&ring.ready[s], 32);
    }
    bulk::bar_init_fence();
  }
  __syncthreads();
  constexpr int kLoader = Shape<MIX>::kLoader;
  if (warp == 0) {
    run_chain<MIX>(ring, carry0, consts, carry_out, n, lanes, lane0, width,
                   stride, lane);
  } else if (warp == kLoader) {
    load_tiles<MIX>(ring, xs, mix, &map_x, &map_m, n, ld, lane0, width,
                    lane);
  } else if (MIX) {
    if (warp % 4 != 0)
      nco_mixer(ring, carry0, consts, out, n, lanes, ld, lane0, width,
                stride, lane, warp - 1 - warp / 4);
  } else {
    store_angles(ring, out, n, ld, lane0, width, stride, lane);
  }
}

// The chain alone: one warp, N steps on a sign pattern made in registers
// (a linear congruential generator per lane), no memory traffic per step;
// writes the final carry (4, lanes).  Its time / N is the serial floor.
__global__ void __launch_bounds__(32)
    chain_floor_kernel(const float* __restrict__ carry0,
                       const float* __restrict__ consts,
                       float* __restrict__ carry_out, int n, int lanes) {
  const int lane = threadIdx.x;
  Chain c(carry0, consts, lanes, min(lane, lanes - 1), 4);
  const Chain c0 = c;
  const uint32_t s0 = 0x9E3779B9u * static_cast<uint32_t>(lane + 1);
  uint32_t s = s0;
  bool bad = false;
  for (int t = 0; t < n; ++t) {
    s = s * 1664525u + 1013904223u;
    c.step_fast((s & 0x80000000u) ? -1.0f : 1.0f, bad);
  }
  if (__any_sync(0xffffffffu, bad && lane < lanes)) {  // as the kernels do
    c = c0;
    s = s0;
    for (int t = 0; t < n; ++t) {
      s = s * 1664525u + 1013904223u;
      c.step_exact((s & 0x80000000u) ? -1.0f : 1.0f);
    }
  }
  if (lane < lanes) c.store(carry_out, lanes, lane);
}

// Opts the kernel into its dynamic shared memory on the current device,
// once per device (a CUDA graph capture, models/program.py, relies on its
// eager warm-up having made this first call, and the first lookup of
// cuTensorMapEncodeTiled in encode()).
template <bool MIX>
cudaError_t prepare() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(pll_kernel<MIX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Shape<MIX>::kSmem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// The tensor map of a time-major (n, ld) float array, boxes of kRows steps
// x kLanes lanes.  cuTensorMapEncodeTiled is a driver-API call: it is
// reached through the runtime's driver entry point, so the library links
// no libcuda.
cudaError_t encode(CUtensorMap* map, const float* base, int ld, int n) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&fn),
        cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      fn = nullptr;
      return cudaErrorNotSupported;
    }
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(ld),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(float)};
  const cuuint32_t box[2] = {kLanes, kRows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<float*>(base), dims, strides, box, steps,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor maps are encoded on the host for every call and passed to the
// kernel by value (__grid_constant__): a captured launch bakes in the
// addresses of its own operands, and nothing is kept in device memory from
// an earlier call's addresses.
template <bool MIX>
int launch(const float* xs, const float* mix, const float* carry0,
           const float* consts, float* out, float* carry_out, int n,
           int lanes, int ld, void* stream) {
  cudaError_t err = prepare<MIX>();
  CUtensorMap map_x = {}, map_m = {};
  if (err == cudaSuccess && ld > kLanes) {
    err = encode(&map_x, xs, ld, n);
    if (err == cudaSuccess && MIX) err = encode(&map_m, mix, ld, n);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (ld + kLanes - 1) / kLanes;
  pll_kernel<MIX><<<blocks, Shape<MIX>::kThreads, Shape<MIX>::kSmem,
                    static_cast<cudaStream_t>(stream)>>>(
      xs, mix, map_x, map_m, carry0, consts, out, carry_out, n, lanes, ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xs (n, ld) with rows ld floats apart (ld a multiple of 4, >= lanes,
// 16-byte-aligned base), carry0 (4, lanes), consts (8, lanes) -> args
// (n, ld), carry_out (4, lanes).  Returns cudaGetLastError() after the
// launch.
extern "C" int sdr_pll_angles(const float* xs, const float* carry0,
                              const float* consts, float* args,
                              float* carry_out, int n, int lanes, int ld,
                              void* stream) {
  return launch<false>(xs, nullptr, carry0, consts, args, carry_out, n,
                       lanes, ld, stream);
}

// xs, mix (n, ld), carry0 (6, lanes), consts (10, lanes) -> mixer (n, ld),
// carry_out (6, lanes).  Returns cudaGetLastError().
extern "C" int sdr_pll_mixer(const float* xs, const float* mix,
                             const float* carry0, const float* consts,
                             float* mixer, float* carry_out, int n, int lanes,
                             int ld, void* stream) {
  return launch<true>(xs, mix, carry0, consts, mixer, carry_out, n, lanes,
                      ld, stream);
}

// The chain floor: carry0 (4, lanes), consts (8, lanes), lanes <= 32 ->
// carry_out (4, lanes) after n steps.  Returns cudaGetLastError().
extern "C" int sdr_pll_chain_floor(const float* carry0, const float* consts,
                                   float* carry_out, int n, int lanes,
                                   void* stream) {
  chain_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      carry0, consts, carry_out, n, lanes);
  return static_cast<int>(cudaGetLastError());
}
