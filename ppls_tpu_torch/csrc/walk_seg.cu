// K3: the fixed-length walk segment for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel` (ppls_tpu/parallel/walker.py:1253,
// launched by run_segment at :1265 / pallas_call :1268): exactly `iters`
// walker steps over all lanes, with no counters and no exit test. Its
// caller is the kernel-ceiling probe (tools/profile_walker.py). Scouting
// is refused by the wrapper, as by the reference (it would drop the eval
// counters); the step machine is trapezoid or Simpson.
//
// Design. The same 128-thread blocks and the same per-lane step code
// (walk_step.cuh) as K1 and K2, but an ordinary launch: nothing is read
// across the grid, so there is no cooperative launch and no grid barrier.
// Its per-step time against K2's on the same lanes is the share of the
// barrier (and of the block reductions) in K2's step.
//
// What bounds it on this card: the float32 instruction rate of the ds
// arithmetic at 4 warps per SM for 16384 lanes (latency-bound); one load
// and one store of the ~1.7 MB state per launch.

#include <cuda_runtime.h>

#include "walk_grid.cuh"
#include "walk_step.cuh"

namespace {

using wg::kThreads;

template <int FAM, int MODE>
__global__ void __launch_bounds__(kThreads)
    walk_seg_kernel(void* const* p, float eps32, int iters) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  ws::Lane s = ws::load_lane(p, lane);
  int sc_n = 0, cf_n = 0;
  for (int k = 0; k < iters; ++k) ws::step<FAM, MODE>(s, eps32, sc_n, cf_n);
  ws::store_lane(p, lane, s);
}

struct Pick {
  template <int FAM, int MODE>
  const void* operator()() const {
    if constexpr (MODE == ws::STEP_SCOUT)
      return nullptr;                     // K3 has no scout variant
    else
      return reinterpret_cast<const void*>(&walk_seg_kernel<FAM, MODE>);
  }
};

const void* pick_kernel(int family, int mode) {
  return ws::dispatch(family, mode, Pick{}, static_cast<const void*>(nullptr));
}

}  // namespace

extern "C" {

// One launch of lanes / kThreads blocks on `stream`, whose device must be
// current. `d_ptrs` is a device array of the 26 state pointers; `mode`
// ws::STEP_TRAP or ws::STEP_SIMPSON. Returns 0, a cudaError_t code, -2
// for an unknown family or mode, or -3 when lanes is not a multiple of
// the block size.
int walk_seg_launch(void* const* d_ptrs, int lanes, int family, int mode,
                    float eps32, int iters, void* stream) {
  const void* fn = pick_kernel(family, mode);
  if (fn == nullptr) return -2;
  if (lanes <= 0 || lanes % kThreads != 0) return -3;
  void* args[] = {(void*)&d_ptrs, &eps32, &iters};
  cudaError_t err =
      cudaLaunchKernel(fn, dim3(lanes / kThreads), dim3(kThreads), args, 0,
                       static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
