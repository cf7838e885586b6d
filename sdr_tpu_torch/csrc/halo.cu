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
// Two entries, both K6:
//
// * sdr_halo_shift_rows, the row-block entry: the shards of one card as
//   equally spaced row blocks of one buffer, as time_sharded_receive lays
//   them out ((time rows x shards x channel rows, L), one allocation per
//   card).  Every address is base + b * group_stride + k * shard_stride +
//   r * row_stride, so the launch takes ten integers and no table: the
//   whole exchange of a card, zero fill included, is one launch with no
//   host work beyond the call.  It takes 16-byte multiples only.
// * sdr_halo_shift, the table entry: any buffers, one (source, destination)
//   pointer pair per shard passed by value (blockIdx.y the shard, blockIdx.z
//   the channel row).  It serves left neighbours on another card (read
//   through unified addressing with peer access, sdr_halo_enable_peer),
//   buffers that are no row blocks of one tensor, and row blocks that are
//   not 16-byte multiples.
//
// Direction: the kernel PULLS.  It runs on the destination's card and reads
// the left neighbour's tail, so every write is local, the destination's own
// stream orders the halo before the compute that reads it, and the zero
// fill of shard 0 rides in the same launch.  The TPU kernel pushes; a peer
// read costs a round trip where a posted NVLink write does not, but at
// these sizes (0.9 MB per row) enough loads are in flight that the
// transfer is bound by bandwidth.  The wrapper orders a remote tail with
// an event on the source's stream, and the source's stream waits for this
// launch before it may reuse that memory.
//
// What bounds it: bytes.  It moves `halo` floats per row (230,400 in mode 0
// with RDS, 200,000 without, 38,400 in mode 3) and does no arithmetic: S=8
// rows of mode 0 read 6.5 MB and write 7.4 MB, 4.1 us at HBM rate, and in
// back-to-back calls the tails sit in the 50 MB L2.  So the copy must keep
// enough bytes in flight per SM, and the host work around the launch must
// stay below the copy.  The row-block entry copies with Hopper's bulk
// copy: one thread per block moves a 16 KB chunk global -> shared under an
// mbarrier and shared -> global in a bulk group; zero rows are 16-byte
// stores.  It won against float4 loads, four independent 16-byte loads in
// flight per thread before their stores, timed in one call on an H100
// (700 W) at S=8 shards of mode 0's halo with L2 flushed before each
// launch: 0.0200-0.0204 ms against 0.0216-0.0220 at C=4 rows (6-9% less),
// a tie at C=1, 0.0069 against 0.0069-0.0070 (scripts/torch_fir_halo_ab.py,
// PERF.md).  Layouts that are not 16-byte multiples are refused here: the
// wrapper sends them to the table entry.
//
// Not NCCL: send/recv is a library of finished kernels and needs one
// process per card; K6 serves the shards of one process, on one card or
// on several, and the copy is the kernel.  Only a halo that crosses the
// process edge travels as torch.distributed point-to-point
// (parallel/time_shard.py, exchange_edges).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

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

// --- the row-block entry ------------------------------------------------------

constexpr int kBulkFloats = 4096;                  // 16 KB per bulk chunk
constexpr int kBulkThreads = 128;

// The shards of one card: row (b, k, r) of time row b, shard k, channel
// row r starts at base + b * group + k * shard + r * row (in floats).
struct RowBlocks {
  float* base;
  int shards, rows;
  long long n, length, row, shard, group;

  // blockIdx.y = ((b * shards) + k) * rows + r
  __device__ float* dst(int y, int* k) const {
    const int r = y % rows;
    *k = (y / rows) % shards;
    const int b = y / (rows * shards);
    return base + b * group + *k * shard + r * row;
  }
};

// One thread moves the block's chunk through shared memory with two bulk
// copies; zero rows are float4 stores by every thread.
__global__ void __launch_bounds__(kBulkThreads)
    halo_rows_bulk_kernel(const RowBlocks rb) {
  __shared__ __align__(128) float buf[kBulkFloats];
  __shared__ __align__(8) uint64_t full;
  int k;
  float* dst = rb.dst(blockIdx.y, &k);
  const long long lo = static_cast<long long>(blockIdx.x) * kBulkFloats;
  const int count = static_cast<int>(min(static_cast<long long>(kBulkFloats),
                                         rb.n - lo));
  if (k == 0) {
    float4* d = reinterpret_cast<float4*>(dst + lo);
    for (int i = threadIdx.x; i < count / 4; i += kBulkThreads)
      d[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  if (threadIdx.x != 0) return;
  const float* src = dst - rb.shard + rb.length - rb.n;
  const uint32_t bytes = static_cast<uint32_t>(count) * 4u;
  bulk::bar_init(&full, 1);
  bulk::bar_init_fence();
  bulk::bar_expect(&full, bytes);
  bulk::load(buf, src + lo, bytes, &full);
  bulk::bar_wait(&full, 0);
  bulk::store(dst + lo, buf, bytes);
  bulk::store_wait_all();
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

// K6 over row blocks on `device` (see the note at the top): for every time
// row b < time_rows, shard k < shards and channel row r < rows, the first
// n floats of row (b, k, r) become the last n floats of row (b, k-1, r)
// (its floats length-n .. length-1), and zeros for k = 0.  Offsets are in
// floats.  Bulk copies: n, length and every stride must be multiples of
// 4 floats and base 16-byte aligned (they move 16-byte multiples only).
// Launches on `stream`, which must belong to `device`; returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for what it
// does not take).
extern "C" int sdr_halo_shift_rows(int device, float* base, int time_rows,
                                   int shards, int rows, long long n,
                                   long long length, long long row_stride,
                                   long long shard_stride,
                                   long long group_stride, void* stream) {
  const long long grid_y = static_cast<long long>(time_rows) * shards * rows;
  if (base == nullptr || time_rows <= 0 || shards <= 0 || rows <= 0 ||
      grid_y > 65535 || n <= 0 || 2 * n > length || !aligned16(base) ||
      n % 4 != 0 || length % 4 != 0 || row_stride % 4 != 0 ||
      shard_stride % 4 != 0 || group_stride % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const RowBlocks rb{base, shards, rows, n, length, row_stride, shard_stride,
                     group_stride};
  const dim3 grid(static_cast<unsigned>((n + kBulkFloats - 1) / kBulkFloats),
                  static_cast<unsigned>(grid_y));
  halo_rows_bulk_kernel<<<grid, kBulkThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(rb);
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
