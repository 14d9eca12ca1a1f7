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
// launch, updated in place. Each lane classifies itself before its step
// and sums its own counts; they are reduced once at the end.
//
// What bounds it on this card, and what the design does about it: as K1
// (walk_rf.cu), the latency of the ds arithmetic's dependent float32
// chains at one warp per scheduler (16384 lanes are one block of 4 warps
// on each of 128 SMs; the state is ~1.7 MB, so memory is no bound), plus
// the grid-wide live count the exit test reads after every step. To keep
// that count exact (and so the reference's step counts and waste), the
// kernel is launched cooperatively and every step ends in K1's packed
// count-and-barrier (wg::grid_count with one count: one 64-bit atomic and
// one spin per block, where a cooperative-groups grid.sync() after an
// atomic cost 1.42 of a 2.79 us step, H100 80GB HBM3, 700 W). The grid
// is checked for co-residency and never shrunk. The scouting step
// confirms its three points side by side, as K1's. K3 (walk_seg.cu) runs
// the same step code with no barrier, which measures the barrier's share.

#include <cuda_runtime.h>

#include "walk_grid.cuh"
#include "walk_step.cuh"

namespace {

using wg::kThreads;

template <int FAM, int MODE>
__global__ void __launch_bounds__(kThreads)
    walk_ee_kernel(void* const* p, float eps32, int thresh, int cap) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  uint64_t* sync = static_cast<uint64_t*>(p[ws::P_EE_SYNC]);

  ws::Lane s = ws::load_lane(p, lane);
  ws::WasteEE w = {0, 0, 0};
  int sc_n = 0, cf_n = 0;

  int k = 0, c = 0;
  int live[1] = {!ws::is_parked(s)};
  wg::grid_count(live, sync, c);
  while (k == 0 || (k < cap && live[0] > thresh)) {
    ws::lane_classify_ee(s, w);
    ws::step<FAM, MODE>(s, eps32, sc_n, cf_n);
    ++k;
    ++c;
    live[0] = !ws::is_parked(s);
    wg::grid_count(live, sync, c);
  }
  ws::store_lane(p, lane, s);

  // counters: steps, eval_active, masked_dead, parked with a root,
  // theta_overwalk (0: no theta groups here), scout evals, confirm evals
  int* out = static_cast<int*>(p[ws::P_EE_COUNTERS]);
  const int vals[6] = {w.active, w.dead, w.parked_root, 0, sc_n, cf_n};
  wg::add_counters(vals, 6, out + 1);
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = k;
}

struct Pick {
  template <int FAM, int MODE>
  const void* operator()() const {
    return reinterpret_cast<const void*>(&walk_ee_kernel<FAM, MODE>);
  }
};

const void* pick_kernel(int family, int mode) {
  return ws::dispatch(family, mode, Pick{}, static_cast<const void*>(nullptr));
}

}  // namespace

extern "C" {

// Blocks of kThreads the current device holds at once for this variant,
// or -1 on error (queried once per family, mode and device).
int walk_ee_max_coresident_blocks(int family, int mode) {
  return wg::max_coresident_blocks(pick_kernel(family, mode));
}

// One cooperative launch on `stream`, whose device must be current.
// `d_ptrs` is a device array of ws::N_EE_PTRS pointers; `mode` a
// ws::STEP_*. Returns 0, a cudaError_t code, -2 for an unknown family or
// mode, -3 when lanes is not a multiple of the block size, -4 when the
// grid exceeds `max_blocks` (it is never shrunk), or -5 when lanes exceed
// the packed count's fields (wg::packed_fits).
int walk_ee_launch(void* const* d_ptrs, int lanes, int family, int mode,
                   float eps32, int thresh, int cap, int max_blocks,
                   void* stream) {
  const void* fn = pick_kernel(family, mode);
  if (fn == nullptr) return -2;
  void* args[] = {(void*)&d_ptrs, &eps32, &thresh, &cap};
  return wg::launch_cooperative(fn, lanes, max_blocks, args, stream);
}

}  // extern "C"
