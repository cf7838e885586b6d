// Batched decimating FIR over float, u8 or int8 input: kernels K5, K1, K4.
//
// Replaces sdr_tpu/ops/pallas_fir.py::fir_decim_pallas (K5, float32 input),
// sdr_tpu/ops/pallas_fir_mxu.py::fir_frontend_u8_pallas_int (K1, the
// receiver's raw interleaved u8 I/Q, normalized as (x - 128) * 2^-7) and
// sdr_tpu/ops/pallas_fir_mxu.py::fir_decim_mxu_pallas (K4, bias-flipped
// int8 scaled by 2^-7).  All three compute
//
//   y[b, j] = sum_u h[K-1-u] * xc[b, j*D + u],   xc[b] = [state[b], x[b]]
//
// in fp32, from one template whose input type is a parameter (F32In, U8In,
// I8In: how an element and a state element become a float).  A one-byte
// sample is split as the exact integer u8 - 128 or int8, and the 2^-7 is
// folded into the taps (h * 2^-7 times the integer is the same product as
// h times the normalized sample, so the sums are the same bit for bit).
// This is the TPU kernels' function, not their block structure: their
// polyphase VMEM tiling, halo views and bf16 hi/lo weight split are TPU
// layout and are not carried over.  Polyphase: with u = q*D + p, output j is sum_p sum_q
// hp[p, q] * sp[p, j + q], hp[p, q] = h[K-1 - q*D - p] (zero past h[0])
// and sp[p, m] = xc[m*D + p]: r_rows = ceil(K/D) taps per phase.
//
// What bounds it.  Per output it reads D input elements and does K
// multiply-adds.  K5 at the channelizer's D = 8 does ~9.4 flops per input
// byte, below the ~20 at which the CUDA cores' 67 TFLOP/s meet 3.35 TB/s
// of HBM: HBM-bound.  K1 at K = 151, D = 10 does 30 flops per input byte:
// on the CUDA cores it is compute-bound.
//
// * Register blocking (the CUDA-core form).  A thread computes R = 8
//   consecutive outputs of one row.  Per phase it walks the taps 8 at a
//   time (4 for the last when ceil(K/D) % 8 is 4 or less): two 16-byte
//   broadcast loads of taps and two 16-byte loads of 8 new window samples
//   feed 64 multiply-adds, the window's other 8 samples carried in
//   registers from the step before.  The phase rows are swizzled (word m
//   at m ^ ((m >> 5 & 1) << 2)) so that the window loads of a quarter
//   warp, 8 words apart per thread, hit all 32 banks.  The swizzle permutes
//   aligned groups of 8 words, so a phase row holds its 32*R + r_pad window
//   rows rounded up to 8 (spw).  Small shapes take R = 1 (scalar window
//   loads), so that a C=1 block still spreads over more than 132 blocks.
//   A TF32 tensor-core form of the one-byte instances (exact samples, the
//   taps split hi + lo) was timed against this one and lost (PERF.md): its
//   ldmatrix and tap-fragment loads move as many shared-memory bytes per
//   output as the multiply-adds here, and two thirds of its products are
//   zero taps of the banded matrix.
// * Staging that overlaps compute.  Persistent blocks walk (row, tile)
//   work items.  Warp 0 is the producer: one thread brings each item's
//   input span into a ring of shared-memory stages with one cp.async.bulk
//   (the span widened to 16-byte bounds), each stage under a full and an
//   empty mbarrier.  The span is staged in its own type: the raw bytes for
//   u8 and int8, a quarter of the float path's.  Each compute warp owns
//   32*R outputs of one arm of the item and splits its part of the staged
//   span by phase into its own float buffer: the deinterleave and the
//   conversion (u8: the exact x - 128) happen here, four loads in flight a
//   lane; it releases the stage and computes from its buffer while the
//   producer loads the next item.  The ring depth (1-3) is the
//   plan's: at the paths' large shapes one stage with more blocks resident
//   ran faster than two stages with fewer (PERF.md).
// * The interleaved front-end.  The receiver's I/Q block (u8 or float) is
//   read as its (C, 2, N) view (element step 2): a span holds both arms
//   interleaved and is staged once; its two compute warps split it
//   together, each half of the rows of both arms (pairs of elements), and
//   then each computes one arm.
// * The state in the same launch: after their items, the blocks write the
//   new f32 state, the last K-1 samples of [state, x] converted as the
//   FIR reads them, into its own output (a block shorter than K-1 keeps
//   part of the old state), so one call is one launch.
// * The geometry (R, warps, tile, stages, shared bytes, grid) is a pure
//   function of the shape, computed in Python (ops/fir_decim.py, plan)
//   and passed in; the kernel checks only what would fault.  All of
//   the SM's unified L1/shared memory goes to shared memory, so that the
//   plan's blocks fit.
//
// Summation order: an output's sum never depends on the plan: by phase p =
// 0..D-1, then by tap q = 0..r_pad-1 within the phase, for R = 8 and R = 1
// alike (padded taps add exact zeros).  So a row gives bit-identical
// output at any batch size.  The plain version sums another order: within
// 1e-5.  The state is copied, so it is bit-equal to
// the plain version's.
//
// The library is built with --fmad=false for the PLL kernels; the
// multiply-adds here are explicit fmaf, which that flag leaves alone.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kT = 4;            // taps per phase row: a multiple of 4
constexpr int kBarBytes = 64;    // full and empty mbarriers of <= 4 stages
constexpr int kMaxWarps = 4;     // compute warps per block
constexpr int kMaxShared = 232448;
constexpr int kMaxDevices = 64;
constexpr float kScale = 0.0078125f;  // 2^-7

// The input types: an element of x and of the state as the split holds
// them (x, s), the same normalized for the new state (x_out, s_out), and
// the factor on the taps (kTap) that makes up the difference.
struct F32In {
  using T = float;
  using S = float;
  static constexpr float kTap = 1.0f;
  static __device__ __forceinline__ float x(float v) { return v; }
  static __device__ __forceinline__ float s(float v) { return v; }
  static __device__ __forceinline__ float x_out(float v) { return v; }
  static __device__ __forceinline__ float s_out(float v) { return v; }
};
struct U8In {  // raw SDR bytes as u8 - 128; the state normalized
  using T = uint8_t;
  using S = float;
  static constexpr float kTap = kScale;
  static __device__ __forceinline__ float x(uint8_t v) {
    return static_cast<float>(static_cast<int>(v) - 128);
  }
  static __device__ __forceinline__ float s(float v) { return v * 128.0f; }
  static __device__ __forceinline__ float x_out(uint8_t v) {
    return x(v) * kScale;
  }
  static __device__ __forceinline__ float s_out(float v) { return v; }
};
struct I8In {  // bias-flipped bytes, the state as int8 too
  using T = int8_t;
  using S = int8_t;
  static constexpr float kTap = kScale;
  static __device__ __forceinline__ float x(int8_t v) {
    return static_cast<float>(v);
  }
  static __device__ __forceinline__ float s(int8_t v) {
    return static_cast<float>(v);
  }
  static __device__ __forceinline__ float x_out(int8_t v) {
    return x(v) * kScale;
  }
  static __device__ __forceinline__ float s_out(int8_t v) {
    return s(v) * kScale;
  }
};

template <class T>
struct alignas(2 * sizeof(T)) Pair {
  T a, b;
};

// Where a launch's data lies and how it is cut (ops/fir_decim.py: the
// spans and the plan).  A span is one staged row of x: `lanes` arms
// interleaved (1, or 2 for the receiver's I/Q), span s at
// x + (s / spo) * outer_stride + (s % spo) * arm_stride elements; output
// and state row s * lanes + a.  `raw`: bytes of a stage.
struct Fir {
  const void* x;
  const void* state;
  float* y;
  float* new_state;
  long long outer_stride, arm_stride;
  int spans, lanes, spo, n, k, decim, n_out;
  int tile, n_tiles, r_pad, spw, raw, stages;
};

__device__ __forceinline__ int swz(int m) { return m ^ (((m >> 5) & 1) << 2); }

template <class In>
__device__ __forceinline__ const typename In::T* span_row(const Fir& f,
                                                          int span) {
  return static_cast<const typename In::T*>(f.x) +
         static_cast<long long>(span / f.spo) * f.outer_stride +
         static_cast<long long>(span % f.spo) * f.arm_stride;
}

// The staged part of a span for the item at output j0: xc indices [j0*D,
// g_end), g_end = min((j0 + tile + r_pad) * D, n + K-1), everything the
// item's warps split (up to r_pad outputs past the tile, so that only a
// row's first and last items need the slow split); its x part [i_lo,
// g_end - (K-1)) widened to 16-byte bounds.  `off`: elements from `src`
// to x index i_lo's first element.  The widening reads up to 15 bytes
// before a span's first element and after its last, which may lie outside
// x's storage.  That cannot fault: the bytes added share an aligned
// 16-byte granule with an element of x, and no page boundary splits such
// a granule.  They are never used.  Inside PyTorch's caching allocator,
// which rounds blocks up to 512 bytes, they also stay inside x's block; a
// memory checker that tracks allocations may report them for a tensor
// whose storage ends on no 16-byte bound.
struct Stage {
  const void* src;
  uint32_t bytes;
  int i_lo, off, g_end;
};

template <class In>
__device__ __forceinline__ Stage stage_of(const Fir& f, int span, int j0) {
  using T = typename In::T;
  const T* row = span_row<In>(f, span);
  const int km1 = f.k - 1;
  const int i_lo = max(j0 * f.decim - km1, 0);
  const int g_end = min((j0 + f.tile + f.r_pad) * f.decim, f.n + km1);
  const uintptr_t first =
      reinterpret_cast<uintptr_t>(row + static_cast<long long>(i_lo) * f.lanes);
  const uintptr_t end = reinterpret_cast<uintptr_t>(
      row + static_cast<long long>(g_end - km1) * f.lanes);
  const uintptr_t a = first & ~static_cast<uintptr_t>(15);
  const uintptr_t b = (end + 15) & ~static_cast<uintptr_t>(15);
  return {reinterpret_cast<const void*>(a), static_cast<uint32_t>(b - a),
          i_lo, static_cast<int>((first - a) / sizeof(T)), g_end};
}

// The polyphase split of one warp's rows: sp_a[p * spw + swz(m)] =
// xc_a[g0 + e] as a float, for e = m * D + p in [e_lo, e_hi), lanes 32
// apart, for ARMS arms: one (xs at its arm), or both interleaved arms of
// a span (xs at arm 0), read as pairs.  Past the row's end: zeros; below
// K-1: the old state rows old_a.
template <int ARMS, class In>
__device__ __forceinline__ void split_rows(
    const Fir& f, const Stage& st, const typename In::T* xs,
    const typename In::S* old0, const typename In::S* old1, float* sp0,
    float* sp1, int g0, int e_lo, int e_hi, int lane) {
  using T = typename In::T;
  const int km1 = f.k - 1;
  const int dp = 32 % f.decim, dm = 32 / f.decim;
  int e = e_lo + lane;
  int p = e % f.decim, m = e / f.decim;
  if (g0 + e_lo >= km1 && g0 + e_hi <= st.g_end) {
    // the common case: every element lies in the staged block.  Four
    // elements a lane are loaded before any is stored, so that their
    // shared-memory latencies overlap.
    const T* src = xs + (g0 - km1 - st.i_lo) * f.lanes;
    const bool pairs =
        (reinterpret_cast<uintptr_t>(src) & (2 * sizeof(T) - 1)) == 0;
    auto load = [&](int i) {
      float2 v = make_float2(0.0f, 0.0f);
      if (ARMS == 1) {
        v.x = In::x(src[i * f.lanes]);
      } else if (pairs) {
        const Pair<T> q = *reinterpret_cast<const Pair<T>*>(src + 2 * i);
        v.x = In::x(q.a);
        v.y = In::x(q.b);
      } else {
        v.x = In::x(src[2 * i]);
        v.y = In::x(src[2 * i + 1]);
      }
      return v;
    };
    auto store = [&](float2 v) {
      const int at = p * f.spw + swz(m);
      sp0[at] = v.x;
      if (ARMS == 2) sp1[at] = v.y;
      p += dp;
      m += dm;
      if (p >= f.decim) {
        p -= f.decim;
        ++m;
      }
    };
    for (; e + 96 < e_hi; e += 128) {
      const float2 v0 = load(e), v1 = load(e + 32), v2 = load(e + 64),
                   v3 = load(e + 96);
      store(v0);
      store(v1);
      store(v2);
      store(v3);
    }
    for (; e < e_hi; e += 32) store(load(e));
  } else {
    // a row's first tile (the old state) or its last (zeros past it)
    for (; e < e_hi; e += 32) {
      const int g = g0 + e;
      float v0 = 0.0f, v1 = 0.0f;
      if (g < st.g_end) {
        if (g < km1) {
          v0 = In::s(old0[g]);
          if (ARMS == 2) v1 = In::s(old1[g]);
        } else {
          const T* q = xs + (g - km1 - st.i_lo) * f.lanes;
          v0 = In::x(q[0]);
          if (ARMS == 2) v1 = In::x(q[1]);
        }
      }
      const int at = p * f.spw + swz(m);
      sp0[at] = v0;
      if (ARMS == 2) sp1[at] = v1;
      p += dp;
      m += dm;
      if (p >= f.decim) {
        p -= f.decim;
        ++m;
      }
    }
  }
}

// The two compute warps of an interleaved span (arms 0 and 1; a plan with
// lanes 2 has exactly these two).
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync 1, 64;" ::: "memory");
}

// 8 window samples from phase row `srow`, rows b .. b+7 (b a multiple of
// 8): two 16-byte loads.  In an aligned group of 8 the swizzle swaps the
// two halves or not, by bit 5 of b.
__device__ __forceinline__ void load8(const float* srow, int b, float* w) {
  const int s = (b >> 3) & 4;
  const float4 lo = *reinterpret_cast<const float4*>(srow + (b | s));
  const float4 hi = *reinterpret_cast<const float4*>(srow + (b | (s ^ 4)));
  w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
  w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
}

__device__ __forceinline__ void load4(const float* p, float* w) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

// acc[i] = sum_p sum_q hp[p, q] * sp[p, m0 + i + q], summed by phase, then
// by tap.  R = 8: per phase, taps 8 at a time (two broadcast loads), and a
// 16-sample window whose upper half carries over to the next 8 taps, so
// each step loads 8 new samples for 64 multiply-adds; r_pad % 8 == 4 ends
// with a half step.  R = 1 (small shapes): taps 4 at a time, scalar loads.
template <int R>
__device__ __forceinline__ void outputs(const float* sp, const float* hp,
                                        int spw, int r_pad, int decim, int m0,
                                        float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;
  for (int p = 0; p < decim; ++p) {
    const float* srow = sp + p * spw;
    const float* hrow = hp + p * r_pad;
    if (R == 8) {
      float w[16], t[8];
      load8(srow, m0, w);
      int q0 = 0;
#pragma unroll 2
      for (; q0 + 8 <= r_pad; q0 += 8) {
        load8(srow, m0 + q0 + 8, w + 8);
        load4(hrow + q0, t);
        load4(hrow + q0 + 4, t + 4);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
#pragma unroll
          for (int i = 0; i < R; ++i) acc[i] = fmaf(t[q], w[q + i], acc[i]);
        }
#pragma unroll
        for (int v = 0; v < 8; ++v) w[v] = w[v + 8];
      }
      if (q0 < r_pad) {  // the last 4 taps
        const int b = m0 + q0 + 8;
        load4(srow + (b | ((b >> 3) & 4)), w + 8);
        load4(hrow + q0, t);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int i = 0; i < R; ++i) acc[i] = fmaf(t[q], w[q + i], acc[i]);
        }
      }
    } else {
      for (int q0 = 0; q0 < r_pad; q0 += kT) {
        float t[kT], w[R + kT - 1];
        load4(hrow + q0, t);
#pragma unroll
        for (int v = 0; v < R + kT - 1; ++v) w[v] = srow[swz(m0 + q0 + v)];
#pragma unroll
        for (int q = 0; q < kT; ++q) {
#pragma unroll
          for (int i = 0; i < R; ++i) acc[i] = fmaf(t[q], w[q + i], acc[i]);
        }
      }
    }
  }
}

// hp[p, u]: the tap of phase p at window offset u, zero outside the filter
__device__ __forceinline__ float phase_tap(const float* h, int km1, int decim,
                                           int p, int u) {
  const int t = km1 - u * decim - p;
  return (u >= 0 && t >= 0) ? h[t] : 0.0f;
}

// --- the kernel --------------------------------------------------------------

template <int R, class In>
__global__ void __launch_bounds__(32 * (1 + kMaxWarps))
    fir_kernel(const float* __restrict__ h, const Fir f) {
  using T = typename In::T;
  using S = typename In::S;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + f.stages;
  float* hp = reinterpret_cast<float*>(smem + kBarBytes);  // (D, r_pad)
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(hp + f.decim * f.r_pad);
  float* split = reinterpret_cast<float*>(ring + f.stages * f.raw);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x / 32 - 1;
  const int km1 = f.k - 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < f.stages; ++s) {
      bulk::bar_init(&full[s], 1);
      bulk::bar_init(&empty[s], warps);
    }
    bulk::bar_init_fence();
  }
  for (int i = threadIdx.x; i < f.decim * f.r_pad; i += blockDim.x)
    hp[i] = phase_tap(h, km1, f.decim, i / f.r_pad, i % f.r_pad) * In::kTap;
  __syncthreads();

  const int items = f.spans * f.n_tiles;
  if (warp == 0) {
    // the producer: one thread keeps the ring full
    if (lane == 0) {
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
        const int s = it % f.stages;
        if (it >= f.stages) bulk::bar_wait(&empty[s], (it / f.stages - 1) & 1);
        const Stage st =
            stage_of<In>(f, item / f.n_tiles, (item % f.n_tiles) * f.tile);
        bulk::bar_expect(&full[s], st.bytes);
        bulk::load(ring + s * f.raw, st.src, st.bytes, &full[s]);
      }
    }
  } else {
    const int cw = warp - 1;
    const int arm = cw % f.lanes;
    const int chunk = cw / f.lanes;
    float* sp = split + cw * f.decim * f.spw;
    const int rows_m = 32 * R + f.r_pad;  // phase rows of this warp's split
    const S* state = static_cast<const S*>(f.state);
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      const int s = it % f.stages;
      const int span = item / f.n_tiles;
      const int j0 = (item % f.n_tiles) * f.tile;
      const int j1 = min(j0 + f.tile, f.n_out);
      const int jw = j0 + chunk * 32 * R;  // this warp's first output
      const int row = span * f.lanes + arm;
      bulk::bar_wait(&full[s], (it / f.stages) & 1);
      if (jw < j1) {
        // split: sp[p, m] = xc[(jw + m) * D + p], zero past the row's end
        const Stage st = stage_of<In>(f, span, j0);
        const T* xs = reinterpret_cast<const T*>(ring + s * f.raw) + st.off;
        const S* old = state + static_cast<long long>(row) * km1;
        const int total = rows_m * f.decim;
        if (f.lanes == 1) {
          split_rows<1, In>(f, st, xs, old, old, sp, sp, jw * f.decim, 0,
                            total, lane);
        } else {
          // the pair splits both arms, each warp half of the rows: once
          // the partner has finished reading its buffer
          pair_sync();
          float* sp0 = sp - arm * f.decim * f.spw;
          split_rows<2, In>(f, st, xs, old - arm * km1, old + (1 - arm) * km1,
                            sp0, sp0 + f.decim * f.spw, jw * f.decim,
                            arm * (total / 2), arm ? total : total / 2, lane);
        }
      }
      __syncwarp();
      if (lane == 0) bulk::bar_arrive(&empty[s]);
      if (f.lanes == 2 && jw < j1) pair_sync();  // both halves written
      if (jw < j1) {
        float acc[R];
        const int m0 = lane * R;
        outputs<R>(sp, hp, f.spw, f.r_pad, f.decim, m0, acc);
        float* yr = f.y + static_cast<long long>(row) * f.n_out;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int j = jw + m0 + i;
          if (j < j1) yr[j] = acc[i];
        }
      }
      __syncwarp();  // every lane has read sp before the next split
    }
  }

  // the new state: the last K-1 samples of [state, x], row by row
  const S* st = static_cast<const S*>(f.state);
  const int rows = f.spans * f.lanes;
  const long long total = static_cast<long long>(rows) * km1;
  const int keep = max(km1 - f.n, 0);  // old-state samples that stay
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(i / km1);
    const int c = static_cast<int>(i % km1);
    float v;
    if (c < keep) {
      v = In::s_out(st[static_cast<long long>(row) * km1 + f.n + c]);
    } else {
      const int xi = f.n - km1 + c;  // >= 0 here
      v = In::x_out(span_row<In>(f, row / f.lanes)[static_cast<long long>(
                                                        xi) * f.lanes +
                                                    row % f.lanes]);
    }
    f.new_state[i] = v;
  }
}

using Kernel = void (*)(const float*, Fir);

// The instances: R = 8 and R = 1 per input kind (0 float, 1 u8, 2 int8).
Kernel kernel_of(int kind, int r) {
  if (r != 8 && r != 1) return nullptr;
  switch (kind) {
    case 0:
      return r == 8 ? fir_kernel<8, F32In> : fir_kernel<1, F32In>;
    case 1:
      return r == 8 ? fir_kernel<8, U8In> : fir_kernel<1, U8In>;
    case 2:
      return r == 8 ? fir_kernel<8, I8In> : fir_kernel<1, I8In>;
  }
  return nullptr;
}

}  // namespace

// K5, K1, K4: x as struct Fir describes it (float, u8 or int8 elements),
// state (spans * lanes, k-1) of float (float, u8) or int8, h (k) f32 ->
// y (spans * lanes, n/decim) f32 and new_state (spans * lanes, k-1) f32.
// `geometry`: 20 host integers, the CUDA device, the input kind (0 float,
// 1 u8, 2 int8), spans, lanes, spans per outer row, n, k, decim, the outer
// and arm strides of x in elements, then the launch plan of
// ops/fir_decim.py (r, warps, tile, n_tiles, r_pad, spw, raw, stages,
// smem, grid).  Launches on `stream`, which must belong to the device;
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// what it does not take).
extern "C" int sdr_fir_decim(const void* x, const void* state, const float* h,
                             float* y, float* new_state,
                             const long long* geometry, void* stream) {
  const int device = static_cast<int>(geometry[0]);
  const int kind = static_cast<int>(geometry[1]);
  const int spans = static_cast<int>(geometry[2]);
  const int lanes = static_cast<int>(geometry[3]);
  const int spans_per_outer = static_cast<int>(geometry[4]);
  const int n = static_cast<int>(geometry[5]);
  const int k = static_cast<int>(geometry[6]);
  const int decim = static_cast<int>(geometry[7]);
  const long long outer_stride = geometry[8], arm_stride = geometry[9];
  const int r = static_cast<int>(geometry[10]);
  const int warps = static_cast<int>(geometry[11]);
  const int tile = static_cast<int>(geometry[12]);
  const int n_tiles = static_cast<int>(geometry[13]);
  const int r_pad = static_cast<int>(geometry[14]);
  const int spw = static_cast<int>(geometry[15]);
  const int raw = static_cast<int>(geometry[16]);
  const int stages = static_cast<int>(geometry[17]);
  const int smem = static_cast<int>(geometry[18]);
  const int grid = static_cast<int>(geometry[19]);
  const Kernel kernel = kernel_of(kind, r);
  const int elem = kind == 0 ? 4 : 1;
  if (kernel == nullptr || spans <= 0 || lanes < 1 || lanes > 2 ||
      spans_per_outer <= 0 || n <= 0 || k < 2 || decim <= 0 ||
      n % decim != 0 || warps < lanes || warps > kMaxWarps ||
      warps % lanes != 0 || (lanes == 2 && warps != 2) ||
      tile != 32 * r * (warps / lanes) ||
      static_cast<long long>(n_tiles) * tile < n / decim ||
      static_cast<long long>(spans) * n_tiles > INT_MAX || r_pad % kT != 0 ||
      r_pad * decim < k || spw % 4 != 0 ||
      spw < ((32 * r + r_pad + 7) & ~7) || raw % 16 != 0 ||
      raw < (tile + r_pad) * decim * lanes * elem + 32 || stages < 1 ||
      2 * stages * 8 > kBarBytes || smem > kMaxShared || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long need =
      kBarBytes + 4 * (1LL * decim * r_pad + 1LL * warps * decim * spw) +
      1LL * stages * raw;
  if (smem < need) return static_cast<int>(cudaErrorInvalidValue);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // above 48 KB of dynamic shared memory, and all of the SM's unified
  // L1/shared memory as shared, so that the plan's blocks per SM fit: once
  // per device and instance.  A CUDA graph capture (models/program.py)
  // relies on its eager warm-up having made this first call; the geometry
  // and the Fir struct go to the kernel by value, so a captured launch
  // keeps no host or device table of this call's addresses.
  static bool opened[kMaxDevices][6];
  const int variant = 2 * kind + (r == 8 ? 0 : 1);
  if (device >= 0 && device < kMaxDevices && !opened[device][variant]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    opened[device][variant] = err == cudaSuccess;
  }
  if (err == cudaSuccess) {
    const Fir f{x,     state, y,      new_state, outer_stride, arm_stride,
                spans, lanes, spans_per_outer,   n,            k,
                decim, n / decim,     tile,      n_tiles,      r_pad,
                spw,   raw,   stages};
    kernel<<<grid, dim3(32 * (1 + warps)), smem,
             static_cast<cudaStream_t>(stream)>>>(h, f);
    err = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
