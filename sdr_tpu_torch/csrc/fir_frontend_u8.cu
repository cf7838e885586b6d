// RF front-end kernel K1 `fir_frontend_u8`: raw interleaved u8 I/Q in,
// decimated I and Q out, in one pass.
//
// Replaces sdr_tpu/ops/pallas_fir_mxu.py::fir_frontend_u8_pallas_int
// (body _kernel_int).  Like it, this kernel reads the raw bytes straight
// from device memory: the deinterleave and the (x - 128) / 128 normalize
// happen in shared memory, so neither intermediate reaches device memory.
//
//   y[b, a, j] = sum_n h[n] * xc_a[K-1 + j*D - n],   xc_a = [state_a, x_a]
//
// What bounds it on this card: per output pair it reads 2*D input bytes
// and does 2*K multiply-adds.  At the mode-0 shape (D = 10, K = 151) that
// is 30 flops per input byte, above the ~20 flops per HBM byte at which
// the CUDA cores' fp32 rate meets the memory bandwidth, so on CUDA cores
// the kernel is compute bound (tensor cores would make it memory bound).
// This simple one is bound by its shared-memory reads: every FMA reads one
// staged sample from shared memory (the tap is a broadcast).
//
// The simple design: one thread block per (channel, tile of outputs)
// stages the taps and its input span of (tile-1)*D + K I/Q samples in
// shared memory as normalized floats (the carried state for the first
// K-1 samples of the block), then each thread accumulates one output pair
// over all K taps in fp32.  The taps stay full fp32 (no bf16 hi/lo split),
// so the result is closer to the exact FIR than the TPU kernel's.  The
// normalize is exact: (x - 128) * 2^-7 is an 8-bit integer times a power
// of two.  The new state (the last K-1 samples of [state, block]) is taken
// exactly by the wrapper (sdr_tpu_torch/ops/fir_frontend.py).
//
// The library is built with --fmad=false for the PLL kernels; the
// multiply-adds here are explicit fmaf, which that flag leaves alone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTile = 256;
constexpr int kSharedBytes = 48 * 1024;

__global__ void fir_frontend_u8_kernel(const uint8_t* __restrict__ iq,
                                       const float* __restrict__ state,
                                       const float* __restrict__ h,
                                       float* __restrict__ y, int n, int k,
                                       int decim, int n_out, int tile,
                                       int n_tiles) {
  extern __shared__ float smem[];
  const int span = (tile - 1) * decim + k;
  float* sh = smem;
  float* si = sh + k;
  float* sq = si + span;

  const int b = blockIdx.x / n_tiles;
  const int j0 = (blockIdx.x % n_tiles) * tile;
  const int km1 = k - 1;
  const uint8_t* x = iq + static_cast<size_t>(b) * 2 * n;
  const float* st = state + static_cast<size_t>(b) * 2 * km1;

  for (int i = threadIdx.x; i < k; i += blockDim.x) sh[i] = h[i];
  const int g0 = j0 * decim;  // index in xc of the span's first sample
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int g = g0 + i;
    float vi = 0.0f, vq = 0.0f;
    if (g < km1) {
      vi = st[g];
      vq = st[km1 + g];
    } else if (g - km1 < n) {
      const int s = g - km1;
      vi = static_cast<float>(static_cast<int>(x[2 * s]) - 128) * 0.0078125f;
      vq = static_cast<float>(static_cast<int>(x[2 * s + 1]) - 128) *
           0.0078125f;
    }
    si[i] = vi;
    sq[i] = vq;
  }
  __syncthreads();

  for (int jj = threadIdx.x; jj < tile; jj += blockDim.x) {
    const int j = j0 + jj;
    if (j >= n_out) break;
    const int base = jj * decim + km1;  // span index of xc[K-1 + j*D]
    float ai = 0.0f, aq = 0.0f;
    for (int t = 0; t < k; ++t) {
      const float ht = sh[t];
      ai = fmaf(ht, si[base - t], ai);
      aq = fmaf(ht, sq[base - t], aq);
    }
    y[(static_cast<size_t>(b) * 2) * n_out + j] = ai;
    y[(static_cast<size_t>(b) * 2 + 1) * n_out + j] = aq;
  }
}

size_t shared_bytes(int tile, int k, int decim) {
  return sizeof(float) * (static_cast<size_t>(k) +
                          2 * (static_cast<size_t>(tile - 1) * decim + k));
}

}  // namespace

// iq (batch, 2n) u8, state (batch, 2, k-1) f32, h (k) f32 ->
// y (batch, 2, n/decim) f32.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue when the span does not fit in 48 KB of shared
// memory).
extern "C" int sdr_fir_frontend_u8(const uint8_t* iq, const float* state,
                                   const float* h, float* y, int batch, int n,
                                   int k, int decim, void* stream) {
  const int n_out = n / decim;
  int tile = kMaxTile;
  while (tile > 32 && shared_bytes(tile, k, decim) > kSharedBytes) tile /= 2;
  if (shared_bytes(tile, k, decim) > kSharedBytes || n_out <= 0 || batch <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n_out + tile - 1) / tile;
  fir_frontend_u8_kernel<<<batch * n_tiles, tile, shared_bytes(tile, k, decim),
                           static_cast<cudaStream_t>(stream)>>>(
      iq, state, h, y, n, k, decim, n_out, tile, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
