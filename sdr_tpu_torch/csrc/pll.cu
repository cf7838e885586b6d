// PLL recurrence kernels: K2 `pll_angles` and K3 `pll_mixer`.
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
// What bounds it on this card: the recurrence is serial in time.  One step
// is a chain of ~20 dependent float operations (two exact fmodf wraps and
// one IEEE division among them), so a block of N steps costs N times the
// latency of one step, not the card's throughput.  Memory traffic is small
// (one float in and one out per lane and step), but its latency is not:
// with many lanes each warp's load of a step is a new cache line, and the
// measured time per step grows with the lane count (PERF.md).
//
// The simple design: one thread per lane (channel x PLL arm), the whole
// time loop in registers, per-lane constants loaded once.  Inputs and
// outputs are time-major (N, lanes), so at every step neighbouring threads
// touch neighbouring addresses.  Loads do not depend on the carry, so the
// compiler may start them ahead of the chain.
//
// Rounding: the plain PyTorch loop (sdr_tpu_torch/ops/pll.py) rounds each
// operation on its own.  Every add, multiply and divide of the recurrence
// here is an explicit round-to-nearest intrinsic, which nvcc never
// contracts into an FMA, and the library is also built with --fmad=false.
// The phase wrap is fmodf plus m for a negative remainder: the formula of
// torch.remainder, which the plain loop calls.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kPi = 3.14159265358979323846f;      // float(pi)
constexpr float kHalfPi = 1.57079632679489661923f;  // float(pi / 2)
constexpr float kTwoPi = 6.28318530717958647692f;   // float(2 pi)
constexpr int kThreads = 128;

// torch.remainder(x, m) for m > 0
__device__ __forceinline__ float wrap_mod(float x, float m) {
  const float r = fmodf(x, m);
  return r < 0.0f ? __fadd_rn(r, m) : r;
}

// carry rows: 0 integrator, 1 phase estimate, 2 oscillator phase, 3 last
// angle wrapped to [-pi, pi); K3 adds 4 previous NCO value, 5 last angle.
// const rows: 0 kp, 1 ki, 2 w, 3 modulus; K3 adds 4 nco scale, 5 adjust.
template <bool MIX>
__global__ void pll_kernel(const float* __restrict__ xs,
                           const float* __restrict__ mix,
                           const float* __restrict__ carry0,
                           const float* __restrict__ consts,
                           float* __restrict__ out,
                           float* __restrict__ carry_out, int n, int lanes) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  float integ = carry0[l];
  float phase = carry0[lanes + l];
  float psi = carry0[2 * lanes + l];
  float aw = carry0[3 * lanes + l];
  const float kp = consts[l];
  const float ki = consts[lanes + l];
  const float w = consts[2 * lanes + l];
  const float m = consts[3 * lanes + l];
  float scale = 0.0f, adj = 0.0f, prev = 0.0f;
  if (MIX) {
    scale = consts[4 * lanes + l];
    adj = consts[5 * lanes + l];
    prev = carry0[4 * lanes + l];
  }
  float arg = 0.0f;
  for (int t = 0; t < n; ++t) {
    const size_t at = static_cast<size_t>(t) * lanes + l;
    const float xk = xs[at];
    float err;
    if (xk > 0.0f) {
      err = -aw;
    } else if (xk < 0.0f) {
      err = aw > 0.0f ? __fsub_rn(kPi, aw) : __fsub_rn(-kPi, aw);
    } else {
      err = fabsf(aw) < kHalfPi ? 0.0f : (aw > 0.0f ? -kPi : kPi);
    }
    integ = __fadd_rn(integ, __fmul_rn(ki, err));
    phase = wrap_mod(__fadd_rn(__fadd_rn(phase, __fmul_rn(kp, err)), integ), m);
    psi = wrap_mod(__fadd_rn(psi, w), m);
    arg = __fadd_rn(psi, phase);
    if (MIX) {
      out[at] = __fmul_rn(__fmul_rn(prev, mix[at]), 2.0f);
      prev = cosf(__fadd_rn(__fmul_rn(arg, scale), adj));
    } else {
      out[at] = arg;
    }
    aw = __fsub_rn(arg, __fmul_rn(kTwoPi, floorf(__fadd_rn(
                                                __fdiv_rn(arg, kTwoPi), 0.5f))));
  }
  carry_out[l] = integ;
  carry_out[lanes + l] = phase;
  carry_out[2 * lanes + l] = psi;
  carry_out[3 * lanes + l] = aw;
  if (MIX) {
    carry_out[4 * lanes + l] = prev;
    carry_out[5 * lanes + l] = arg;
  }
}

int launch_blocks(int lanes) { return (lanes + kThreads - 1) / kThreads; }

}  // namespace

// xs (n, lanes), carry0 (4, lanes), consts (4, lanes) -> args (n, lanes),
// carry_out (4, lanes).  Returns cudaGetLastError() after the launch.
extern "C" int sdr_pll_angles(const float* xs, const float* carry0,
                              const float* consts, float* args,
                              float* carry_out, int n, int lanes,
                              void* stream) {
  pll_kernel<false><<<launch_blocks(lanes), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      xs, nullptr, carry0, consts, args, carry_out, n, lanes);
  return static_cast<int>(cudaGetLastError());
}

// xs, mix (n, lanes), carry0 (6, lanes), consts (6, lanes) -> mixer
// (n, lanes), carry_out (6, lanes).  Returns cudaGetLastError().
extern "C" int sdr_pll_mixer(const float* xs, const float* mix,
                             const float* carry0, const float* consts,
                             float* mixer, float* carry_out, int n, int lanes,
                             void* stream) {
  pll_kernel<true><<<launch_blocks(lanes), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      xs, mix, carry0, consts, mixer, carry_out, n, lanes);
  return static_cast<int>(cudaGetLastError());
}
