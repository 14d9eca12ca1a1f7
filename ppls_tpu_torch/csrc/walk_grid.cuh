// Block and grid reductions shared by the cooperative walk kernels (K1 in
// walk_rf.cu, K2 in walk_ee.cu), and K1's theta-group vote. Device code
// only.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace wg {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;         // one lane per thread, every kernel
constexpr int kWarps = kThreads / 32;

// Grid-wide sums of the N values v[] of every thread, written back into
// v[] of every thread. The block totals go by integer atomicAdd into
// rotating slot `c % 3` of `sync` (N ints each, zeroed before launch),
// then one grid.sync(). The slot used two reductions later is cleared
// here: every thread read it before this grid.sync. Integer atomics are
// order-independent, so reruns are bit-identical.
template <int N>
__device__ __forceinline__ void grid_count(cg::grid_group& grid, int (&v)[N],
                                           int* sync, int c) {
  __shared__ int part[N][kWarps];
  for (int j = 0; j < N; ++j)
    for (int off = 16; off > 0; off >>= 1)
      v[j] += __shfl_down_sync(0xffffffffu, v[j], off);
  int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0)
    for (int j = 0; j < N; ++j) part[j][warp] = v[j];
  __syncthreads();
  int slot = N * (c % 3);
  if (threadIdx.x == 0)
    for (int j = 0; j < N; ++j) {
      int sum = 0;
      for (int w = 0; w < kWarps; ++w) sum += part[j][w];
      atomicAdd(&sync[slot + j], sum);
    }
  grid.sync();
  const volatile int* vs = sync;
  for (int j = 0; j < N; ++j) v[j] = vs[slot + j];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int clear = N * ((c + 2) % 3);
    for (int j = 0; j < N; ++j) sync[clear + j] = 0;
  }
}

// The union vote of theta groups: true in every thread whose group of T
// adjacent lanes (lanes g*T .. g*T+T-1; T a power of two) holds a true
// `vote`. Every thread of the grid must call it, with the same T and c.
//   T <= 32:       one warp ballot, masked to the group's T bits.
//   T <= kThreads: ballots, one flag per warp in shared memory, one
//                  __syncthreads(). The next write of the flags comes
//                  after the caller's next block barrier (grid_count).
//   T > kThreads:  a group spans T / kThreads whole blocks: a block OR,
//                  one integer atomicOr per block into the group's slot of
//                  rotating set `c % 3` of `slots` (3 sets of G = lanes / T
//                  ints, zeroed before launch), and a second grid.sync().
//                  Block 0 clears the set used two votes later; every
//                  thread read it before this grid.sync.
__device__ __forceinline__ bool group_any(cg::grid_group& grid, bool vote,
                                          int T, int* slots, int G, int c) {
  if (T <= 32) {
    unsigned b = __ballot_sync(0xffffffffu, vote);
    if (T == 32) return b != 0u;
    int base = (threadIdx.x & 31) & ~(T - 1);
    return ((b >> base) & ((1u << T) - 1u)) != 0u;
  }
  if (T <= kThreads) {
    __shared__ int warp_any[kWarps];
    unsigned b = __ballot_sync(0xffffffffu, vote);
    if ((threadIdx.x & 31) == 0) warp_any[threadIdx.x >> 5] = b != 0u;
    __syncthreads();
    int per_group = T >> 5;
    int w0 = (threadIdx.x >> 5) & ~(per_group - 1);
    int any = 0;
    for (int j = 0; j < per_group; ++j) any |= warp_any[w0 + j];
    return any != 0;
  }
  int block_any = __syncthreads_or(vote);
  int g = blockIdx.x / (T / kThreads);
  int* set = slots + G * (c % 3);
  if (threadIdx.x == 0 && block_any) atomicOr(&set[g], 1);
  grid.sync();
  const volatile int* vs = set;
  bool any = vs[g] != 0;
  if (blockIdx.x == 0) {
    int* clear = slots + G * ((c + 2) % 3);
    for (int j = threadIdx.x; j < G; j += kThreads) clear[j] = 0;
  }
  return any;
}

// Block-wide sum of v, valid in thread 0.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += scratch[w];
  return s;
}

// Sums n per-thread counters over the grid into out[0..n) by one atomicAdd
// per block and counter (out zeroed before launch).
__device__ __forceinline__ void add_counters(const int* vals, int n,
                                             int* out) {
  __shared__ int scratch[kWarps];
  for (int j = 0; j < n; ++j) {
    int tot = block_sum(vals[j], scratch);
    if (threadIdx.x == 0 && tot != 0) atomicAdd(&out[j], tot);
  }
}

// How many blocks of kThreads the current device holds at once for
// kernel `fn` (occupancy per SM times the SM count), or -1 on error.
inline int max_coresident_blocks(const void* fn) {
  int device = 0, per_sm = 0, sms = 0;
  if (fn == nullptr) return -1;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    0) != cudaSuccess)
    return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return -1;
  return per_sm * sms;
}

// One cooperative launch of `fn` over lanes / kThreads blocks. Returns 0,
// a cudaError_t code, -3 when lanes is not a multiple of the block size,
// or -4 when the grid exceeds `max_blocks`, the co-resident limit (the
// grid is never shrunk to fit).
inline int launch_cooperative(const void* fn, int lanes, int max_blocks,
                              void** args, void* stream) {
  if (lanes <= 0 || lanes % kThreads != 0) return -3;
  int grid = lanes / kThreads;
  if (grid > max_blocks) return -4;
  cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
