// K1: the in-kernel-refill walk segment for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel_rf` (ppls_tpu/parallel/walker.py:993,
// launched by run_segment_rf at :1194 / pallas_call :1211). It computes
// what that kernel computes: up to `cap` walker steps over all lanes,
// refilling parked lanes from their private root banks whenever
// `nref >= batch` or `live <= thresh`, banking finished roots into the
// result bank (or the sentinel row), classifying every lane-step into
// the five waste buckets, and counting scout / confirm evals. The step
// machine is a template parameter: trapezoid, scouting or Simpson.
//
// Theta mode (theta_block = T > 1, trapezoid and scouting; the THETA
// template flag, so the T = 1 variants are the code they were): groups
// of T adjacent lanes walk one node sequence, each lane with its own
// theta. Each step is split in two (walk_step.cuh): every lane evaluates
// its node and votes, the vote is OR-reduced over its group
// (wg::group_any: a warp ballot up to T = 32, per-warp flags and a
// named barrier up to the block, beyond that a word per group that only
// the group's blocks wait on; K2 votes through it too), and every lane
// commits the group's decision. Retired lanes' live steps are counted as
// theta_overwalk.
//
// Design. One thread owns one lane; the lane state lives in registers
// for the whole launch and the state tensors are updated in place. Root
// bank reads and result bank writes are indexed loads/stores
// bank[f][slot][lane] (the TPU kernel needed an R-deep masked-select
// chain because Mosaic has no gather). The waste and eval counters need
// no per-step grid-wide value: each lane accumulates its own and they
// are reduced once at the end (the same totals).
//
// What bounds it on this card, and what the design does about it. The
// work is float32 arithmetic, not memory: the whole state is ~1.5 MB at
// 16384 lanes, and its bound is ~0.3 us a step at the float32 peak. 16384
// lanes are 128 blocks of 128 threads, one block on each of 128 of the
// 132 SMs: one warp per scheduler, so every dependent float32 operation
// of a ds evaluation (several hundred in a ds sin) waits its full
// latency. Three costs sat on top of that chain (H100 80GB HBM3, 700 W,
// PERF.md):
//   - The exit and refill tests read two grid-wide counts, live and
//     nref, after every step, and they must stay exact to keep the
//     reference's schedule. They were a cooperative-groups grid.sync()
//     after integer atomics, ~1.4 us a step. Now one packed
//     count-and-barrier (wg::grid_count): one relaxed 64-bit atomic per
//     block carries an arrival, live and nref into a word that is never
//     cleared, and thread 0 spins on that word alone, with no fence. The
//     launch stays cooperative, which keeps every block resident while
//     others spin.
//   - The scouting step confirmed 61% of its live lane-steps with three
//     full-ds evaluations run one after another. Now the three points
//     run in lockstep (ws::f_ds_n<FAM, 3>, and the three float32 scout
//     evaluations with ws::f_sc_n), each bit-equal to a single
//     evaluation. ptxas still schedules the three ds_sin chains one
//     after another (SASS), so the gain is the divisions' and the scout
//     evaluations', ~0.3 us a step (PERF.md).
//   - Theta mode beyond T = 128 added a second grid.sync() per step
//     (+1.5 us at T = 256). Now a block waits only for the T / 128
//     blocks of its own group.
// Raising the occupancy (more lanes per card are the caller's choice)
// and a native-FP64 walk (another arithmetic than the reference's) are
// not this kernel's to change.

#include <cuda_runtime.h>

#include "walk_grid.cuh"
#include "walk_step.cuh"

namespace {

using wg::kThreads;

template <int FAM, int MODE, bool THETA>
__global__ void __launch_bounds__(kThreads)
    walk_rf_kernel(void* const* p, int lanes, int R, float eps32,
                   int thresh, int cap, int batch, int T) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  uint64_t* sync = static_cast<uint64_t*>(p[ws::P_SYNC]);
  uint32_t* votes = static_cast<uint32_t*>(p[ws::P_VOTE]);
  __shared__ wg::VoteShared vs;

  ws::Lane s = ws::load_lane(p, lane);
  int slot = static_cast<int*>(p[ws::P_SLOT])[lane];
  const int nslots = static_cast<const int*>(p[ws::P_NSLOTS])[lane];
  ws::ResM rm;
  rm.h = static_cast<float*>(p[ws::P_RESM_H])[lane];
  rm.l = static_cast<float*>(p[ws::P_RESM_L])[lane];
  rm.fam = static_cast<int*>(p[ws::P_RESM_FAM])[lane];
  ws::Waste w = {0, 0, 0, 0, 0};
  int sc_n = 0, cf_n = 0;

  int k = 0, c = 0;
  int cnt[2] = {!ws::is_parked(s), ws::takeable(s, slot, nslots)};
  wg::grid_count(cnt, sync, c);
  while (k == 0 || (k < cap && (cnt[0] > thresh || cnt[1] > 0))) {
    // refill BEFORE the step, on the counts (live, nref) of the
    // previous step
    if (cnt[1] > 0 && (cnt[1] >= batch || cnt[0] <= thresh))
      ws::lane_take(s, slot, nslots, R, lane, lanes, p, rm);
    ws::lane_classify<THETA>(s, slot, nslots, w);
    if constexpr (THETA) {
      ws::Eval e = ws::evaluate<FAM, MODE, true>(s, eps32, sc_n, cf_n);
      bool any = wg::group_any(e.vote, T, votes, lanes / T, k, vs);
      ws::commit<MODE, true>(s, e, any);
    } else {
      ws::step<FAM, MODE>(s, eps32, sc_n, cf_n);
    }
    ++k;
    ++c;
    cnt[0] = !ws::is_parked(s);
    cnt[1] = ws::takeable(s, slot, nslots);
    wg::grid_count(cnt, sync, c);
  }

  ws::store_lane(p, lane, s);
  static_cast<int*>(p[ws::P_SLOT])[lane] = slot;
  static_cast<float*>(p[ws::P_RESM_H])[lane] = rm.h;
  static_cast<float*>(p[ws::P_RESM_L])[lane] = rm.l;
  static_cast<int*>(p[ws::P_RESM_FAM])[lane] = rm.fam;

  // counters: steps, eval_active, masked_dead, refill_stall, drain_tail,
  // theta_overwalk (0 outside theta mode), scout evals, confirm evals
  int* out = static_cast<int*>(p[ws::P_COUNTERS]);
  const int vals[7] = {w.active, w.dead, w.stall, w.tail, w.over, sc_n,
                       cf_n};
  wg::add_counters(vals, 7, out + 1);
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = k;
}

// the variant of (family, mode, theta mode); Simpson has no theta mode
struct Pick {
  bool theta;
  template <int FAM, int MODE>
  const void* operator()() const {
    if constexpr (MODE == ws::STEP_SIMPSON) {
      if (theta) return nullptr;
      return reinterpret_cast<const void*>(&walk_rf_kernel<FAM, MODE, false>);
    } else {
      return theta ? reinterpret_cast<const void*>(
                         &walk_rf_kernel<FAM, MODE, true>)
                   : reinterpret_cast<const void*>(
                         &walk_rf_kernel<FAM, MODE, false>);
    }
  }
};

const void* pick_kernel(int family, int mode, bool theta) {
  return ws::dispatch(family, mode, Pick{theta},
                      static_cast<const void*>(nullptr));
}

}  // namespace

extern "C" {

// How many blocks of kThreads the current device can hold at once for
// this variant (`theta` nonzero: the theta-mode one), or -1 on error. The
// caller queries it once per (family, mode, theta, device) with that
// device current.
int walk_rf_max_coresident_blocks(int family, int mode, int theta) {
  return wg::max_coresident_blocks(pick_kernel(family, mode, theta != 0));
}

// One cooperative launch on `stream`, whose device must be current.
// `d_ptrs` is a device array of ws::N_PTRS pointers; `mode` a ws::STEP_*;
// `T` the theta block (1: no theta groups; else a power of two dividing
// lanes). Returns 0, a cudaError_t code, -2 for an unknown family or mode
// (or Simpson with T > 1), -3 when lanes is not a multiple of the block
// size or T is not a power of two dividing lanes, -4 when the grid
// exceeds `max_blocks`, the co-resident limit (it is never shrunk), or -5
// when lanes exceed the packed count's fields (wg::packed_fits).
int walk_rf_launch(void* const* d_ptrs, int lanes, int R, int family,
                   int mode, float eps32, int thresh, int cap, int batch,
                   int T, int max_blocks, void* stream) {
  if (T < 1 || (T & (T - 1)) != 0 || lanes % T != 0) return -3;
  const void* fn = pick_kernel(family, mode, T > 1);
  if (fn == nullptr) return -2;
  void* args[] = {(void*)&d_ptrs, &lanes, &R, &eps32, &thresh, &cap,
                  &batch, &T};
  return wg::launch_cooperative(fn, lanes, max_blocks, args, stream);
}

}  // extern "C"
