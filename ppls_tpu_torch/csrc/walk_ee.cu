// K2: the early-exit walk segment for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel_ee` (ppls_tpu/parallel/walker.py:1279,
// launched by run_segment_ee at :1345 / pallas_call :1350), the walk
// segment of the boundary-refill walker (refill_slots=0). It takes steps
// while `k == 0 or (k < cap and live > thresh)`, where `live` is the
// grid-wide count of unparked lanes after each step, and counts the
// lane-steps that were live (eval_active), had no root (masked_dead) or
// were parked with a root, plus scout and confirm evals. The step machine
// is a template parameter: trapezoid, scouting or Simpson.
//
// Design. One thread owns one lane, its state in registers for the whole
// launch. Each lane classifies itself before its step and sums its own
// counts; they are reduced once at the end.
//
// What bounds it on this card, and what the design does about it. At
// 16384 lanes a block of 4 lane warps sits on each of 128 SMs, one warp
// per scheduler, and the state is ~1.7 MB: memory is no bound, and each
// step runs at the latency of its dependent float32 chain, plus the exact
// grid-wide live count the exit test needs after every step.
// - The chain. The ds products take their error from one FMA, not
//   Dekker's split (walk_step.cuh two_prod): a trapezoid step of
//   sin(theta / x) falls from 787 float32 operations to 501 and its
//   longest dependent chain from 248 to 202 (chip_smoke.py
//   operation_counts). K3, the same step with no count, went from 0.890
//   to 0.565 us/step (tools/time_k1.py --compare, H100 80GB HBM3, 700 W;
//   PERF.md, run 8).
// - The count. Step k + 1 does not need the count after step k; only the
//   decision to keep it does. So each block has a fifth warp, the count
//   warp (walk_grid.cuh count_serve), which takes the count while the
//   lanes compute step k + 1 on a register copy of their state and
//   counters; the lanes then read the count and keep the copy or drop
//   it. Step counts, the k == 0 rule, the cap and every counter stay
//   segment_ee_plain's; at the cap no step is computed. The launch stays
//   cooperative (the count warp spins while others arrive) and the grid
//   is checked for co-residency and never shrunk. On the fallback
//   flagship (163 launches, 16,719 steps) K2 took 24.146 ms before this
//   design and 18.637 ms after (k2_main_path of tools/time_k1.py
//   --compare, parent and change in one call, H100 80GB HBM3, 700 W;
//   PERF.md, run 8). With the count split in the lanes themselves
//   (arrive, speculative step, thread 0's spin) it took 21.453 ms
//   against the count warp's 18.662 and the old loop's 24.198, the
//   three in one such call (PERF.md, run 2).
// The scouting step confirms its three points side by side, as K1's.
// K3 (walk_seg.cu) runs the same step code with no count, which measures
// what the count still costs.

#include <cuda_runtime.h>

#include "walk_grid.cuh"
#include "walk_step.cuh"

namespace {

using wg::kThreads;

template <int FAM, int MODE, bool THETA>
__global__ void __launch_bounds__(wg::kCountBlock)
    walk_ee_kernel(void* const* p, float eps32, int thresh, int cap, int T) {
  __shared__ wg::CountShared cs;
  uint64_t* sync = static_cast<uint64_t*>(p[ws::P_EE_SYNC]);
  ws::WasteEE w = {0, 0, 0, 0};
  int sc_n = 0, cf_n = 0;

  // Step 1 always runs (the reference's k == 0); after step k, step
  // k + 1 is kept when k < cap and the live count after step k exceeds
  // thresh. The lanes compute it on a register copy while the count
  // warp takes that count, and drop it (the state stays that after step
  // k) when the count says stop. At the cap nothing is counted or
  // computed. Lanes and count warp take the same exit at the same k.
  int k = 1;
  if (threadIdx.x >= kThreads) {
    for (int c = 0; k < cap; ++c, ++k)
      if (wg::count_serve(cs, sync, c) <= thresh) break;
  } else {
    const int lane = blockIdx.x * kThreads + threadIdx.x;
    // theta mode: every step is evaluate -> the group's vote -> commit,
    // one vote per step computed (a dropped speculative step voted too,
    // in every block alike)
    __shared__ wg::VoteShared vs;
    uint32_t* votes = static_cast<uint32_t*>(p[ws::P_EE_VOTE]);
    const int groups = gridDim.x * kThreads / T;
    int v = 0;
    auto step = [&](ws::Lane& t, ws::WasteEE& tw, int& tsc, int& tcf) {
      ws::lane_classify_ee<THETA>(t, tw);
      if constexpr (THETA) {
        ws::Eval e = ws::evaluate<FAM, MODE, true>(t, eps32, tsc, tcf);
        bool any = wg::group_any(e.vote, T, votes, groups, v++, vs);
        ws::commit<MODE, true>(t, e, any);
      } else {
        ws::step<FAM, MODE>(t, eps32, tsc, tcf);
      }
    };
    ws::Lane s = ws::load_lane(p, lane);
    step(s, w, sc_n, cf_n);
    for (int c = 0; k < cap; ++c) {
      wg::count_arrive(!ws::is_parked(s), cs);
      ws::Lane t = s;
      ws::WasteEE tw = w;
      int tsc = sc_n, tcf = cf_n;
      step(t, tw, tsc, tcf);
      if (wg::count_wait(cs) <= thresh) break;
      s = t;
      w = tw;
      sc_n = tsc;
      cf_n = tcf;
      ++k;
    }
    ws::store_lane(p, lane, s);
  }

  // counters: steps, eval_active, masked_dead, parked with a root,
  // theta_overwalk (0 outside theta mode), scout evals, confirm evals
  // (the count warp adds zeros)
  int* out = static_cast<int*>(p[ws::P_EE_COUNTERS]);
  const int vals[6] = {w.active, w.dead, w.parked_root, w.over, sc_n, cf_n};
  wg::add_counters(vals, 6, out + 1);
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = k;
}

// the variant of (family, mode, theta mode); Simpson has no theta mode
struct Pick {
  bool theta;
  template <int FAM, int MODE>
  const void* operator()() const {
    if constexpr (MODE == ws::STEP_SIMPSON) {
      if (theta) return nullptr;
      return reinterpret_cast<const void*>(&walk_ee_kernel<FAM, MODE, false>);
    } else {
      return theta ? reinterpret_cast<const void*>(
                         &walk_ee_kernel<FAM, MODE, true>)
                   : reinterpret_cast<const void*>(
                         &walk_ee_kernel<FAM, MODE, false>);
    }
  }
};

const void* pick_kernel(int family, int mode, bool theta) {
  return ws::dispatch(family, mode, Pick{theta},
                      static_cast<const void*>(nullptr));
}

}  // namespace

extern "C" {

// Blocks (kThreads lanes and the count warp) the current device holds at
// once for this variant (`theta` nonzero: the theta-mode one), or -1 on
// error (queried once per family, mode, theta mode and device).
int walk_ee_max_coresident_blocks(int family, int mode, int theta) {
  return wg::max_coresident_blocks(pick_kernel(family, mode, theta != 0),
                                   wg::kCountBlock);
}

// One cooperative launch on `stream`, whose device must be current.
// `d_ptrs` is a device array of ws::N_EE_PTRS pointers; `mode` a
// ws::STEP_*; `T` the theta block (1: no theta groups; else a power of
// two dividing lanes). Returns 0, a cudaError_t code, -2 for an unknown
// family or mode (or Simpson with T > 1), -3 when lanes is not a
// multiple of the block size or T is not a power of two dividing lanes,
// -4 when the grid exceeds `max_blocks` (it is never shrunk), or -5 when
// lanes exceed the packed count's fields (wg::packed_fits).
int walk_ee_launch(void* const* d_ptrs, int lanes, int family, int mode,
                   float eps32, int thresh, int cap, int T, int max_blocks,
                   void* stream) {
  if (T < 1 || (T & (T - 1)) != 0 || lanes % T != 0) return -3;
  const void* fn = pick_kernel(family, mode, T > 1);
  if (fn == nullptr) return -2;
  void* args[] = {(void*)&d_ptrs, &eps32, &thresh, &cap, &T};
  return wg::launch_cooperative(fn, lanes, max_blocks, args, stream,
                                wg::kCountBlock);
}

}  // extern "C"
