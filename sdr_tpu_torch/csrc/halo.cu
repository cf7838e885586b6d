// Halo exchange of time sharding: kernel K6.
//
// Replaces sdr_tpu/parallel/pallas_halo.py::halo_shift_right (body
// _halo_kernel), a ring of remote DMAs in which every time shard hands its
// trailing `halo` input samples to its right neighbour and shard 0 keeps
// zeros.  Here every shard owns one extended buffer [halo | segment] per
// channel row, and the kernel writes shard k-1's tail straight into the
// halo prefix of shard k's buffer (zeros for shard 0), so no concatenation
// follows: the receiver reads its warm-up blocks from that prefix.
//
// One launch serves every shard whose buffer lies on the launching card:
// blockIdx.y is the shard (an entry of the table passed by value),
// blockIdx.z the channel row within it, blockIdx.x strides over the
// samples.  Shards that share a card are rows of one batch, so S shards on
// one card, or a channel x time grid, is one launch; each time row has its
// own shard 0, and the wrapper (parallel/halo.py) builds the table so.
//
// Direction: the kernel PULLS.  It runs on the destination's card and reads
// the left neighbour's tail, local or on another card through unified
// addressing with peer access enabled (sdr_halo_enable_peer).  Every write
// is then local, the destination's own stream orders the halo before the
// compute that reads it, and the zero fill of shard 0 rides in the same
// launch.  The TPU kernel pushes; a peer read costs a round trip where a
// posted NVLink write does not, but at these sizes (0.9 MB per row) enough
// loads are in flight that the transfer is bound by bandwidth.  The wrapper
// orders a remote tail with an event on the source's stream, and the
// source's stream waits for this launch before it may reuse that memory.
//
// What bounds it: bytes.  It moves `halo` floats per row (230,400 in mode 0
// with RDS, 200,000 without, 38,400 in mode 3) and does no arithmetic, so
// at HBM rate S=8 rows take a few microseconds and the launch itself is a
// large share.  16-byte float4 accesses are used when the length, both row
// strides and every pointer allow them; a scalar path takes the rest
// (custom modes, misaligned views).
//
// Not NCCL: send/recv is a library of finished kernels and needs one
// process per card; this one process drives S shards on one card or on
// several, and the copy is the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxShards = 64;  // must match _MAX_SHARDS in parallel/halo.py
constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 1024;

struct HaloTable {
  const float* src[kMaxShards];  // left neighbour's tail, row 0; null: zeros
  float* dst[kMaxShards];        // this shard's halo prefix, row 0
};

template <bool kVec>
__global__ void halo_kernel(const HaloTable table, long long n,
                            long long src_stride, long long dst_stride) {
  const int s = blockIdx.y;
  const long long r = blockIdx.z;
  const float* src = table.src[s];
  float* dst = table.dst[s] + r * dst_stride;
  const long long i0 =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  if (kVec) {
    const long long n4 = n >> 2;
    float4* d = reinterpret_cast<float4*>(dst);
    if (src != nullptr) {
      const float4* v = reinterpret_cast<const float4*>(src + r * src_stride);
      for (long long i = i0; i < n4; i += step) d[i] = v[i];
    } else {
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (long long i = i0; i < n4; i += step) d[i] = z;
    }
  } else {
    if (src != nullptr) {
      const float* v = src + r * src_stride;
      for (long long i = i0; i < n; i += step) dst[i] = v[i];
    } else {
      for (long long i = i0; i < n; i += step) dst[i] = 0.0f;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// K6 on `device`: for s < shards and r < rows,
//   dst[s][r * dst_stride + i] = src[s] ? src[s][r * src_stride + i] : 0
// for i < n.  `src` and `dst` are host arrays of `shards` device pointers
// (a source may lie on another card with peer access enabled).  Launches
// on `stream`, which must belong to `device`; returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for what it does not take).
extern "C" int sdr_halo_shift(int device, const float* const* src,
                              float* const* dst, int shards, int rows,
                              long long n, long long src_stride,
                              long long dst_stride, void* stream) {
  if (shards <= 0 || shards > kMaxShards || rows <= 0 || rows > 65535 ||
      n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  HaloTable table;
  bool vec = n % 4 == 0 && (rows == 1 || (src_stride % 4 == 0 &&
                                          dst_stride % 4 == 0));
  for (int s = 0; s < shards; ++s) {
    table.src[s] = src[s];
    table.dst[s] = dst[s];
    if (dst[s] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    vec = vec && aligned16(dst[s]) && (src[s] == nullptr || aligned16(src[s]));
  }
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long units = vec ? n / 4 : n;
  long long bx = (units + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  const dim3 grid(static_cast<unsigned>(bx), shards, rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    halo_kernel<true><<<grid, kThreads, 0, st>>>(table, n, src_stride,
                                                 dst_stride);
  } else {
    halo_kernel<false><<<grid, kThreads, 0, st>>>(table, n, src_stride,
                                                  dst_stride);
  }
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

// Lets `device` read `peer`'s memory (what K6 does when a left neighbour
// lies on another card).  Access that PyTorch or an earlier call already
// enabled counts as success, and its error is cleared.  Returns
// cudaErrorPeerAccessUnsupported when the cards cannot reach each other.
extern "C" int sdr_halo_enable_peer(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  int prev = 0;
  err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    err = cudaSuccess;
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
