// Batched decimating FIR over float or int8 input: kernels K5 and K4.
//
// Replaces sdr_tpu/ops/pallas_fir.py::fir_decim_pallas (K5, float32 input,
// body _kernel) and sdr_tpu/ops/pallas_fir_mxu.py::fir_decim_mxu_pallas
// (K4, bias-flipped int8 input scaled by 2^-7, body _kernel).  Both compute
//
//   y[b, j] = sum_u h[K-1-u] * xc[b, j*D + u],   xc[b] = [state[b], x[b]]
//
// in fp32.  This is the TPU kernels' function, not their block structure:
// their polyphase VMEM tiling, halo views and bf16 hi/lo weight split are
// TPU layout and are not carried over, so neither has K <= 128*D here.
//
// The state and the block are read in place (never concatenated): index g
// of xc reads state[b, g] below K-1 and x[b, (g-K+1)*step] above.  A row b
// of x starts at (b / arms) * outer_stride + (b % arms) * arm_stride, so
// the receiver's interleaved float I/Q (..., 2N) is read as its (..., 2, N)
// view with step 2 and no deinterleaved copy; a contiguous (B, N) stack has
// arms 1 and step 1.
//
// What bounds it on this card: per output it reads D input samples and does
// K multiply-adds.  At the channelizer's shape (D = 8, K = 151, f32) that
// is ~9.4 flops per input byte, below the ~20 flops per HBM byte at which
// the CUDA cores' fp32 rate meets the memory bandwidth, so the best this
// kernel could do is stream its input at HBM rate; int8 input (K4) has 4x
// the ratio and is compute bound.  This simple kernel is bound instead by
// its shared-memory reads: two per multiply-add, one a broadcast tap.
//
// The simple design: one thread block per (row, tile of outputs), one
// thread per output.  The block stages its taps and its input span in
// shared memory by polyphase: sp[p, m] = xc[j0*D + m*D + p] and
// hp[p, q] = h[K-1 - q*D - p] (zero where that runs past h[0]).  Output jj
// of the tile is then sum_p sum_q hp[p, q] * sp[p, jj + q]: for each tap,
// the threads of a warp read consecutive words of one phase row, so the
// reads have no bank conflicts at any D (reading xc at stride D would have
// gcd(D, 32)-way conflicts).  The new state (the last K-1 samples of
// [state, x]) is formed exactly by the wrapper (ops/fir_decim.py).
//
// The library is built with --fmad=false for the PLL kernels; the
// multiply-adds here are explicit fmaf, which that flag leaves alone.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxTile = 256;
constexpr size_t kSharedBytes = 48 * 1024;

__device__ __forceinline__ float load_scaled(float v, float) { return v; }

// int8 times a power of two: exact in fp32
__device__ __forceinline__ float load_scaled(int8_t v, float scale) {
  return static_cast<float>(v) * scale;
}

template <typename T>
__global__ void fir_decim_kernel(const T* __restrict__ x,
                                 const T* __restrict__ state,
                                 const float* __restrict__ h,
                                 float* __restrict__ y, float scale, int arms,
                                 long long outer_stride, long long arm_stride,
                                 long long step, int n, int k, int decim,
                                 int n_out, int n_tiles, int r_rows,
                                 int rows) {
  extern __shared__ float smem[];
  float* hp = smem;                  // (decim, r_rows) taps by phase
  float* sp = hp + decim * r_rows;   // (decim, rows) input span by phase

  const int b = blockIdx.x / n_tiles;
  const int j0 = (blockIdx.x % n_tiles) * blockDim.x;
  const int km1 = k - 1;
  const T* xr = x + (b / arms) * outer_stride + (b % arms) * arm_stride;
  const T* st = state + static_cast<size_t>(b) * km1;

  for (int i = threadIdx.x; i < decim * r_rows; i += blockDim.x) {
    const int p = i / r_rows;
    const int t = km1 - (i % r_rows) * decim - p;
    hp[i] = t >= 0 ? h[t] : 0.0f;
  }
  const int g0 = j0 * decim;  // index in xc of the span's first sample
  for (int i = threadIdx.x; i < rows * decim; i += blockDim.x) {
    const int g = g0 + i;
    float v = 0.0f;
    if (g < km1) {
      v = load_scaled(st[g], scale);
    } else if (g - km1 < n) {
      v = load_scaled(xr[static_cast<long long>(g - km1) * step], scale);
    }
    sp[(i % decim) * rows + i / decim] = v;
  }
  __syncthreads();

  const int j = j0 + threadIdx.x;
  if (j >= n_out) return;
  float acc = 0.0f;
  for (int p = 0; p < decim; ++p) {
    const float* hrow = hp + p * r_rows;
    const float* srow = sp + p * rows + threadIdx.x;
    for (int q = 0; q < r_rows; ++q) acc = fmaf(hrow[q], srow[q], acc);
  }
  y[static_cast<size_t>(b) * n_out + j] = acc;
}

size_t shared_bytes(int tile, int r_rows, int decim) {
  return sizeof(float) * static_cast<size_t>(decim) *
         (static_cast<size_t>(r_rows) + tile + r_rows - 1);
}

template <typename T>
int launch(const T* x, const T* state, const float* h, float* y, float scale,
           int batch, int arms, long long outer_stride, long long arm_stride,
           long long step, int n, int k, int decim, void* stream) {
  if (batch <= 0 || arms <= 0 || n <= 0 || k <= 0 || decim <= 0 ||
      n % decim != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_out = n / decim;
  const int r_rows = (k + decim - 1) / decim;
  int tile = kMaxTile;
  while (tile > 32 && shared_bytes(tile, r_rows, decim) > kSharedBytes)
    tile /= 2;
  const size_t smem = shared_bytes(tile, r_rows, decim);
  const int n_tiles = (n_out + tile - 1) / tile;
  if (smem > kSharedBytes ||
      static_cast<long long>(batch) * n_tiles > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  fir_decim_kernel<T><<<batch * n_tiles, tile, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      x, state, h, y, scale, arms, outer_stride, arm_stride, step, n, k,
      decim, n_out, n_tiles, r_rows, tile + r_rows - 1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5: x f32 rows as described above, state (batch, k-1) f32, h (k) f32 ->
// y (batch, n/decim) f32.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for shapes it does not take).
extern "C" int sdr_fir_decim_f32(const float* x, const float* state,
                                 const float* h, float* y, int batch,
                                 int arms, long long outer_stride,
                                 long long arm_stride, long long step, int n,
                                 int k, int decim, void* stream) {
  return launch<float>(x, state, h, y, 1.0f, batch, arms, outer_stride,
                       arm_stride, step, n, k, decim, stream);
}

// K4: the same over int8 x and state (bias-flipped bytes), scaled by 2^-7.
extern "C" int sdr_fir_decim_i8(const int8_t* x, const int8_t* state,
                                const float* h, float* y, int batch, int arms,
                                long long outer_stride, long long arm_stride,
                                long long step, int n, int k, int decim,
                                void* stream) {
  return launch<int8_t>(x, state, h, y, 0.0078125f, batch, arms,
                        outer_stride, arm_stride, step, n, k, decim, stream);
}
