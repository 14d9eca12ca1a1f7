// The grid-wide counts and the theta-group votes, shared by the
// cooperative walk kernels: K1 (walk_rf.cu) counts in its lane threads
// after each step (grid_count), K2 (walk_ee.cu) counts in a count warp
// beside its lanes while they compute the next step (count_serve); both
// vote among their lane threads with group_any.
//
// The packing and slot arithmetic at the top is plain C++ that the host
// build (walk_host.cpp) runs too, so the CPU tests hold it; the device
// primitives below it build under nvcc only.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define WG_HD __host__ __device__ __forceinline__
#else
#define WG_HD inline
#endif

namespace wg {

constexpr int kThreads = 128;         // one lane per thread, every kernel
constexpr int kWarps = kThreads / 32;

// --- the packed count: one 64-bit word per step ------------------------------
//
// Each block adds, in one atomic, (1 arrival, its live lanes, its
// refillable lanes) into the step's word:
//   bits 63..48  arrivals  16 bits: a cooperative grid is never larger
//                          than the co-resident limit (132 SMs x 16
//                          blocks of 128 threads = 2112 on an H100 < 2^12);
//                          16 bits leave room for larger cards
//   bits 47..24  live      24 bits: a grid-wide count of lanes, at most
//   bits 23..0   nref      `lanes`, so up to 16,777,215 lanes
// A field's grid-wide sum in one step never exceeds its width at these
// limits, so no block's addition carries into the next field. The words
// are never cleared: a slot's value only grows, and a step's sum is the
// word minus its value after the slot's previous step (modulo 2^64, so
// the carries of earlier steps cancel). The launch refuses a grid beyond
// the limits (kMaxLanes lanes, kMaxBlocks blocks).
constexpr int kArrivalBits = 16;
constexpr int kCountBits = 24;
constexpr int kMaxBlocks = (1 << kArrivalBits) - 1;
constexpr int kMaxLanes = (1 << kCountBits) - 1;
constexpr uint64_t kCountMask = (uint64_t{1} << kCountBits) - 1;

WG_HD uint64_t pack_count(uint64_t arrivals, uint64_t live, uint64_t nref) {
  return (arrivals << (2 * kCountBits)) | (live << kCountBits) | nref;
}
WG_HD int count_arrivals(uint64_t w) {
  return static_cast<int>(w >> (2 * kCountBits));
}
WG_HD int count_live(uint64_t w) {
  return static_cast<int>((w >> kCountBits) & kCountMask);
}
WG_HD int count_nref(uint64_t w) { return static_cast<int>(w & kCountMask); }

// lanes that the packed fields can count, in a grid they can count
WG_HD bool packed_fits(int lanes) {
  return lanes >= 0 && lanes <= kMaxLanes && lanes / kThreads <= kMaxBlocks;
}

// --- the group vote for T > kThreads: one 32-bit word per group and vote ----
//
// A group of T lanes spans T / kThreads whole blocks. Each block adds
// (1 arrival, its vote bit) into its group's word of rotating set c % 3
// (3 sets of G = lanes / T words, zeroed before launch): bits 15..0 count
// arrivals, bits 31..16 the blocks that voted; in one vote both are at
// most kMaxBlocks. As the count words, they are never cleared: a vote is
// the word minus its value after the set's previous vote (modulo 2^32).
WG_HD int vote_blocks(int T) { return T / kThreads; }
WG_HD int vote_group(int block, int T) { return block / vote_blocks(T); }
WG_HD int vote_slot(int g, int G, int c) { return G * (c % 3) + g; }
WG_HD uint32_t vote_word(bool any) { return 1u + (any ? (1u << 16) : 0u); }
WG_HD int vote_arrivals(uint32_t w) { return static_cast<int>(w & 0xFFFFu); }
WG_HD bool vote_any(uint32_t w) { return (w >> 16) != 0u; }

#ifdef __CUDACC__

// --- device primitives -------------------------------------------------------

// Relaxed atomics and loads at GPU scope: coherent in L2, no fence.
__device__ __forceinline__ uint64_t atom_add_relaxed(uint64_t* p,
                                                     uint64_t v) {
  unsigned long long old;
  asm volatile("atom.relaxed.gpu.global.add.u64 %0, [%1], %2;"
               : "=l"(old) : "l"(p), "l"(static_cast<unsigned long long>(v))
               : "memory");
  return old;
}
__device__ __forceinline__ uint64_t ld_relaxed(const uint64_t* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ uint32_t atom_add_relaxed(uint32_t* p,
                                                     uint32_t v) {
  uint32_t old;
  asm volatile("atom.relaxed.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}
__device__ __forceinline__ uint32_t ld_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// K1's grid-wide sums of the per-thread counts v[] = {live, nref},
// written back into v[] of every thread; also the step's grid barrier.
// Every thread of the grid calls it once per step c.
//
// What it costs, and why it is built so: the only data that cross blocks
// in a walk step are these two integers (lane state, root bank and result
// bank are each private to one lane), yet the loop's exit and refill tests
// need them exact every step. A cooperative-groups grid.sync() after
// integer atomics cost 1.42 us of a 2.79 us K2 step on the H100 80GB
// HBM3, 700 W (two block barriers, three atomics, two full fences, a spin
// and 128 global reloads per block). Here a block reduces by warp
// shuffles and shared memory; thread 0 adds its packed (arrival, live,
// nref) into slot c % 3 of `slots` (3 words, zeroed before launch) in one
// relaxed 64-bit atomic and spins on that word until the step's arrivals
// reach gridDim.x (the last block to arrive reads the totals from its own
// atomic and does not spin); the block gets the totals through shared
// memory. One atomic, one spin, two block barriers, no fence.
//
// No fence is needed because the words are never cleared. A step's sum
// is the slot's word minus the value it held when its previous step was
// complete, which thread 0 kept in shared memory when it read it. A block
// adds to a slot again only three steps later, after two more complete
// steps, which each block enters only after its spin on this slot ended,
// so no block ever reads a later step's addition into this step's sum;
// the spin's exit is a control dependency, and no store needs ordering.
// (Release/acquire atomics with block 0 clearing the slot two steps ahead
// measured ~0.5 us a step slower on the H100 80GB HBM3, 700 W, PERF.md.)
// The launch stays cooperative, which guarantees that every block is
// resident while others spin.
__device__ __forceinline__ void grid_count(int (&v)[2], uint64_t* slots,
                                           int c) {
  __shared__ int part[2][kWarps];
  __shared__ int total[2];
  __shared__ uint64_t base[3];  // each slot's word after its previous step
#pragma unroll
  for (int j = 0; j < 2; ++j)
    for (int off = 16; off > 0; off >>= 1)
      v[j] += __shfl_down_sync(0xffffffffu, v[j], off);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) part[j][threadIdx.x >> 5] = v[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum[2] = {0, 0};
#pragma unroll
    for (int j = 0; j < 2; ++j)
      for (int w = 0; w < kWarps; ++w) sum[j] += part[j][w];
    const int s = c % 3;
    const uint64_t b = c < 3 ? 0 : base[s];
    uint64_t* slot = slots + s;
    const uint64_t mine = pack_count(1, sum[0], sum[1]);
    uint64_t w = atom_add_relaxed(slot, mine) + mine - b;
    while (count_arrivals(w) < static_cast<int>(gridDim.x))
      w = ld_relaxed(slot) - b;
    base[s] = w + b;
    total[0] = count_live(w);
    total[1] = count_nref(w);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 2; ++j) v[j] = total[j];
}

// --- K2's count warp: the count, split in arrive and wait --------------------
//
// K2 (walk_ee.cu) runs its kThreads lane threads and one more warp per
// block, the count warp, which takes the grid-wide live count off the
// lanes' path. Per step c:
//   count_arrive (lanes)      each warp's live lanes by one ballot, into
//                             shared memory; then a named barrier's
//                             arrive, which does not wait
//   count_serve (count warp)  waits for the block's arrivals, then its
//                             thread 0 adds the block's packed (1, live)
//                             into slot c % 3 in one relaxed atomic,
//                             spins on the word until all blocks have
//                             arrived, and leaves the grid's live count in
//                             shared memory; a second named barrier's
//                             arrive
//   count_wait (lanes)        that barrier's wait, then the count
// Between arrive and wait the lanes compute the next step on a copy, so
// the atomic's round trip, the other blocks' arrivals and the spin's
// loads all run under a step's arithmetic; the lanes' share of the count
// is a ballot, a shared store, two named-barrier instructions and a
// shared load. (With the arrive and wait in the lane threads
// themselves, thread 0 spinning after the speculative step, K2 took
// 21.453 ms on the fallback flagship against the count warp's 18.662,
// in one call on the H100 80GB HBM3, 700 W (PERF.md, run 2): the spin's
// first load after the step, a five-shuffle reduction and two block
// barriers stayed on the lanes' path.)
//
// The slot rotation stays correct, as grid_count's (its note): a block's
// count warp serves step c + 1 only after its lanes arrived at step
// c + 1, which they do only after their wait on step c returned, that is
// after the count warp's spin on step c ended, which needs every block's
// arrival at step c, each made after its own spin on step c - 1 ended.
// So when any block adds step c + 3 into slot c % 3, every block has
// served step c + 1, hence ended its spin on step c: no spin on step c
// reads a later step's addition, and each block's base of the slot (the
// word when its spin on step c ended) holds all of step c's arrivals and
// nothing later. The speculative step reads and writes no count word.
//
// Shared words: `part` is written by the lanes at step c + 1 only after
// their wait on step c, which follows the count warp's read of it; the
// count warp writes `total` for step c + 1 only after the lanes' arrival
// at step c + 1, which follows their read of it.
constexpr int kCountBlock = kThreads + 32;  // lanes and the count warp
constexpr int kBarArrived = 1;              // named barriers (0 is
constexpr int kBarCounted = 2;              // __syncthreads)

struct CountShared {
  int part[kWarps];
  int total;
  uint64_t base[3];  // each slot's word after its previous step
};

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" : : "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" : : "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void count_arrive(bool live, CountShared& cs) {
  const unsigned b = __ballot_sync(0xffffffffu, live);
  if ((threadIdx.x & 31) == 0) cs.part[threadIdx.x >> 5] = __popc(b);
  bar_arrive(kBarArrived, kCountBlock);
}

__device__ __forceinline__ int count_wait(CountShared& cs) {
  bar_sync(kBarCounted, kCountBlock);
  return cs.total;
}

__device__ __forceinline__ int count_serve(CountShared& cs, uint64_t* slots,
                                           int c) {
  bar_sync(kBarArrived, kCountBlock);
  if (threadIdx.x == kThreads) {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += cs.part[w];
    const int s = c % 3;
    const uint64_t b = c < 3 ? 0 : cs.base[s];
    const uint64_t mine = pack_count(1, sum, 0);
    uint64_t w = atom_add_relaxed(slots + s, mine) + mine - b;
    while (count_arrivals(w) < static_cast<int>(gridDim.x))
      w = ld_relaxed(slots + s) - b;
    cs.base[s] = w + b;
    cs.total = count_live(w);
  }
  __syncwarp();
  const int total = cs.total;
  bar_arrive(kBarCounted, kCountBlock);
  return total;
}

// The union vote of theta groups: true in every lane thread whose group
// of T adjacent lanes (lanes g*T .. g*T+T-1; T a power of two) holds a
// true `vote`. Every lane thread of the grid calls it once per vote c,
// with the same T; K2's count warp never does, and joins none of its
// barriers (it may be spinning on the count meanwhile), so the vote
// syncs the kThreads lane threads alone (kBarLanes; in K1 those are the
// whole block).
//   T <= 32:       one warp ballot, masked to the group's T bits.
//   T <= kThreads: ballots, one flag per warp in shared memory, then the
//                  lanes' barrier. The flags alternate between two sets
//                  by c's parity: a warp writes set c % 2 again only at
//                  vote c + 2, after vote c + 1's barrier, which every
//                  lane reaches only after it read vote c's flags (K2's
//                  count_arrive does not wait, so nothing else orders
//                  them).
//   T > kThreads:  a group spans T / kThreads whole blocks, and only
//                  those need each other's vote: thread 0 ORs the
//                  block's flags, adds (1 arrival, the block's vote) into
//                  its group's word of `slots` (see vote_word) in one
//                  relaxed atomic and spins on that word until the
//                  group's blocks have all arrived; no grid-wide barrier.
//                  (A grid.sync() here cost +1.5 us a step at T = 256
//                  over T = 128 on the H100 80GB HBM3, 700 W.) A second
//                  lanes' barrier hands its answer to the block; its next
//                  write follows vote c + 1's first barrier, after every
//                  lane read it. The words are never cleared, as
//                  grid_count's: a vote is the word minus its value after
//                  the set's previous vote.
// The group's blocks wait only for each other; K2's count warp waits for
// every block's arrival at the count of step c, which each block makes
// before its vote of step c + 1, so the two never wait on each other in
// a cycle.
constexpr int kBarLanes = 3;

struct VoteShared {
  int warp_any[2][kWarps];
  int group_vote;
  uint32_t vbase[3];  // the group's words after their last vote
};

__device__ __forceinline__ bool group_any(bool vote, int T, uint32_t* slots,
                                          int G, int c, VoteShared& vs) {
  const unsigned b = __ballot_sync(0xffffffffu, vote);
  if (T <= 32) {
    if (T == 32) return b != 0u;
    int base = (threadIdx.x & 31) & ~(T - 1);
    return ((b >> base) & ((1u << T) - 1u)) != 0u;
  }
  int* flags = vs.warp_any[c & 1];
  if ((threadIdx.x & 31) == 0) flags[threadIdx.x >> 5] = b != 0u;
  bar_sync(kBarLanes, kThreads);
  if (T <= kThreads) {
    int per_group = T >> 5;
    int w0 = (threadIdx.x >> 5) & ~(per_group - 1);
    int any = 0;
    for (int j = 0; j < per_group; ++j) any |= flags[w0 + j];
    return any != 0;
  }
  if (threadIdx.x == 0) {
    int block_any = 0;
    for (int j = 0; j < kWarps; ++j) block_any |= flags[j];
    const int s = c % 3;
    const uint32_t base = c < 3 ? 0u : vs.vbase[s];
    uint32_t* slot = slots + vote_slot(vote_group(blockIdx.x, T), G, c);
    const uint32_t mine = vote_word(block_any != 0);
    uint32_t w = atom_add_relaxed(slot, mine) + mine - base;
    while (vote_arrivals(w) < vote_blocks(T)) w = ld_relaxed(slot) - base;
    vs.vbase[s] = w + base;
    vs.group_vote = vote_any(w);
  }
  bar_sync(kBarLanes, kThreads);
  return vs.group_vote != 0;
}

// Block-wide sum of v over the block's warps (K2's count warp too),
// valid in thread 0.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
      s += scratch[w];
  return s;
}

// Sums n per-thread counters over the grid into out[0..n) by one atomicAdd
// per block and counter (out zeroed before launch).
__device__ __forceinline__ void add_counters(const int* vals, int n,
                                             int* out) {
  __shared__ int scratch[kCountBlock / 32];
  for (int j = 0; j < n; ++j) {
    int tot = block_sum(vals[j], scratch);
    if (threadIdx.x == 0 && tot != 0) atomicAdd(&out[j], tot);
  }
}

// How many blocks of `threads` the current device holds at once for
// kernel `fn` (occupancy per SM times the SM count), or -1 on error.
inline int max_coresident_blocks(const void* fn, int threads = kThreads) {
  int device = 0, per_sm = 0, sms = 0;
  if (fn == nullptr) return -1;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                    0) != cudaSuccess)
    return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return -1;
  return per_sm * sms;
}

// One cooperative launch of `fn` over lanes / kThreads blocks of
// `threads` threads (kThreads lanes, and in K2 its count warp). Returns
// 0, a cudaError_t code, -3 when lanes is not a multiple of kThreads, -4
// when the grid exceeds `max_blocks`, the co-resident limit (the grid
// is never shrunk), or -5 when lanes or the grid exceed the packed
// count's fields (packed_fits). The cooperative launch is what lets
// grid_count, count_serve and group_any spin: every block of the grid
// is resident.
inline int launch_cooperative(const void* fn, int lanes, int max_blocks,
                              void** args, void* stream,
                              int threads = kThreads) {
  if (lanes <= 0 || lanes % kThreads != 0) return -3;
  if (!packed_fits(lanes)) return -5;
  int grid = lanes / kThreads;
  if (grid > max_blocks) return -4;
  cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(threads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__

}  // namespace wg
