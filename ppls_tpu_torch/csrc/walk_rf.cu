// K1: the in-kernel-refill walk segment for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel_rf` (ppls_tpu/parallel/walker.py:993,
// launched by run_segment_rf at :1194 / pallas_call :1211). It computes
// what that kernel computes: up to `cap` walker steps over all lanes,
// refilling parked lanes from their private root banks whenever
// `nref >= batch` or `live <= thresh`, banking finished roots into the
// result bank (or the sentinel row), classifying every lane-step into
// the five waste buckets, and counting scout / confirm evals.
//
// Design. One thread owns one lane; the lane state lives in registers
// for the whole launch and the state tensors are updated in place. Root
// bank reads and result bank writes are indexed loads/stores
// bank[f][slot][lane] (the TPU kernel needed an R-deep masked-select
// chain because Mosaic has no gather). The exit test and the refill
// decision read two grid-wide counts, live and nref, after every step;
// to keep the reference's semantics (and so its step and waste counts)
// exactly, the kernel is launched cooperatively and each step ends with
// a block reduction, an integer atomicAdd into a counter slot (three
// slots in rotation, so a slot is cleared two steps before its reuse),
// and grid.sync(). Integer atomics are order-independent, so reruns are
// bit-identical. The waste and eval counters need no per-step
// grid-wide value: each lane accumulates its own and they are reduced
// once at the end (the same totals).
//
// What bounds it on this card: the float32 issue rate of the ds
// arithmetic (~20-30 float32 operations per ds operation, several
// hundred per ds sin) and the per-step grid barrier; not memory, since
// the whole state is ~1.5 MB at 16384 lanes. 16384 lanes are only 128
// blocks of 128 threads, one block on each of 128 of the 132 SMs, i.e.
// 4 warps per SM: latency-bound and far below the FP32 peak. Raising
// the occupancy, walking in native FP64 and removing the per-step
// barrier are later work (ROADMAP).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "walk_step.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// Grid-wide sum of (a, b) into rotating slot `c % 3` of `sync`; every
// thread gets both totals. The slot used two reductions later is cleared
// here: all threads finished reading it before this grid.sync.
__device__ __forceinline__ void grid_count2(cg::grid_group& grid, int a,
                                            int b, int* sync, int c,
                                            int& ta, int& tb) {
  __shared__ int sa[kWarps];
  __shared__ int sb[kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  int slot = 2 * (c % 3);
  if (threadIdx.x == 0) {
    int sum_a = 0, sum_b = 0;
    for (int w = 0; w < kWarps; ++w) {
      sum_a += sa[w];
      sum_b += sb[w];
    }
    atomicAdd(&sync[slot], sum_a);
    atomicAdd(&sync[slot + 1], sum_b);
  }
  grid.sync();
  const volatile int* vs = sync;
  ta = vs[slot];
  tb = vs[slot + 1];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int clear = 2 * ((c + 2) % 3);
    sync[clear] = 0;
    sync[clear + 1] = 0;
  }
}

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

template <int FAM, bool SCOUT>
__global__ void __launch_bounds__(kThreads)
    walk_rf_kernel(void* const* p, int lanes, int R, float eps32,
                   int thresh, int cap, int batch) {
  cg::grid_group grid = cg::this_grid();
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  int* sync = static_cast<int*>(p[ws::P_SYNC]);

  ws::Lane s = ws::load_lane(p, lane);
  int slot = static_cast<int*>(p[ws::P_SLOT])[lane];
  const int nslots = static_cast<const int*>(p[ws::P_NSLOTS])[lane];
  ws::ResM rm;
  rm.h = static_cast<float*>(p[ws::P_RESM_H])[lane];
  rm.l = static_cast<float*>(p[ws::P_RESM_L])[lane];
  rm.fam = static_cast<int*>(p[ws::P_RESM_FAM])[lane];
  ws::Waste w = {0, 0, 0, 0};
  int sc_n = 0, cf_n = 0;

  int k = 0, c = 0;
  int live, nref;
  grid_count2(grid, !ws::is_parked(s), ws::takeable(s, slot, nslots),
              sync, c, live, nref);
  while (k == 0 || (k < cap && (live > thresh || nref > 0))) {
    // refill BEFORE the step, on the counts of the previous step
    if (nref > 0 && (nref >= batch || live <= thresh))
      ws::lane_take(s, slot, nslots, R, lane, lanes, p, rm);
    ws::lane_classify(s, slot, nslots, w);
    if (SCOUT)
      ws::step_scout<FAM>(s, eps32, sc_n, cf_n);
    else
      ws::step_trap<FAM>(s, eps32);
    ++k;
    ++c;
    grid_count2(grid, !ws::is_parked(s), ws::takeable(s, slot, nslots),
                sync, c, live, nref);
  }

  ws::store_lane(p, lane, s);
  static_cast<int*>(p[ws::P_SLOT])[lane] = slot;
  static_cast<float*>(p[ws::P_RESM_H])[lane] = rm.h;
  static_cast<float*>(p[ws::P_RESM_L])[lane] = rm.l;
  static_cast<int*>(p[ws::P_RESM_FAM])[lane] = rm.fam;

  // counters: steps, eval_active, masked_dead, refill_stall, drain_tail,
  // theta_overwalk (0: no theta groups here), scout evals, confirm evals
  __shared__ int scratch[kWarps];
  int* out = static_cast<int*>(p[ws::P_COUNTERS]);
  const int vals[7] = {w.active, w.dead, w.stall, w.tail, 0, sc_n, cf_n};
  for (int j = 0; j < 7; ++j) {
    int tot = block_sum(vals[j], scratch);
    if (threadIdx.x == 0 && tot != 0) atomicAdd(&out[1 + j], tot);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = k;
}

template <int FAM, bool SCOUT>
const void* kernel_ptr() {
  return reinterpret_cast<const void*>(&walk_rf_kernel<FAM, SCOUT>);
}

const void* pick_kernel(int family, int scout) {
  if (family == ws::FAMILY_SIN_RECIP)
    return scout ? kernel_ptr<ws::FAMILY_SIN_RECIP, true>()
                 : kernel_ptr<ws::FAMILY_SIN_RECIP, false>();
  if (family == ws::FAMILY_COSH4)
    return scout ? kernel_ptr<ws::FAMILY_COSH4, true>()
                 : kernel_ptr<ws::FAMILY_COSH4, false>();
  return nullptr;
}

}  // namespace

extern "C" {

// How many blocks of kThreads the current device can hold at once for
// this variant (occupancy per SM times the SM count), or -1 on error.
// The caller queries it once per (family, scout, device) with that
// device current.
int walk_rf_max_coresident_blocks(int family, int scout) {
  const void* fn = pick_kernel(family, scout);
  if (fn == nullptr) return -1;
  int device = 0, per_sm = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    0) != cudaSuccess)
    return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return -1;
  return per_sm * sms;
}

// One cooperative launch on `stream`, whose device must be current.
// `d_ptrs` is a device array of ws::N_PTRS pointers. Returns 0, a
// cudaError_t code, -2 for an unknown family, -3 when lanes is not a
// multiple of the block size, or -4 when the grid exceeds `max_blocks`,
// the co-resident limit (it is never shrunk to fit).
int walk_rf_launch(void* const* d_ptrs, int lanes, int R, int family,
                   int scout, float eps32, int thresh, int cap, int batch,
                   int max_blocks, void* stream) {
  const void* fn = pick_kernel(family, scout);
  if (fn == nullptr) return -2;
  if (lanes <= 0 || lanes % kThreads != 0) return -3;
  int grid = lanes / kThreads;
  if (grid > max_blocks) return -4;
  void* args[] = {(void*)&d_ptrs, &lanes, &R, &eps32, &thresh, &cap,
                  &batch};
  cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
