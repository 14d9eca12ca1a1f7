// Variants of K3's step loop for measurement only (tools/k3_split.py
// builds and times them; no entry point of the package reaches them).
// All run on the flagship's integrand body, sin(theta / x), over the same
// lane state as K3 (walk_seg.cu), in 128-thread blocks:
//
//   PLAIN   iters calls of ws::step: the step K1, K2 and K3 run
//   BOTH    a pipelined step: each step tests and commits with the value
//           evaluated during the step before, while it evaluates the
//           next step's point under both of its decisions in lockstep
//           (f_ds_n<FAM, 2>) and keeps the one the decision picks
//   AHEAD   a pipelined step: the next step's point worked out under both
//           decisions beside this step's integrand (written after it), and
//           only the picked one evaluated
//   FIRST   AHEAD with the candidates' geometry written before the
//           integrand
//   EVAL1   the integrand at one frozen point per lane (the point the
//           lane's step evaluates at launch), iters times, each
//           evaluation waiting on the one before: the evaluation's
//           dependent chain alone
//   EVAL2   the same at two frozen points in lockstep (f_ds_n<FAM, 2>),
//           BOTH's pair of candidates
//   NOEVAL  iters steps whose evaluation is replaced by a value stored in
//           the lane (its left-end cache at launch), made to wait on the
//           step's point: the geometry, the test and the commit alone
//
// The next step's node depends on this step's value only through its one
// decision: a split goes to (2i, d + 1), an accept to ((i >> t) + 1,
// d - t) with MODE_LOAD or parks the lane, and a step that does not
// decide has one successor. Each candidate point is computed by the plain
// step's operations, so the pipelined variants' states are bit-equal to
// the plain step's (k3_split.py checks it after every timing); the
// untaken candidate is never stored.
//
// The waits are empty inline-assembly statements that take the previous
// result as an input and declare the next operand rewritten: no
// instruction, but the compiler can neither hoist the evaluation out of
// the loop nor start it before the value it waits on exists.

#include <cuda_runtime.h>

#include "walk_grid.cuh"
#include "walk_step.cuh"

namespace {

constexpr int FAM = ws::FAMILY_SIN_RECIP;
constexpr bool FMA = ws::fma_product(FAM);
enum Variant { PLAIN = 0, AHEAD = 1, EVAL1 = 2, EVAL2 = 3, NOEVAL = 4,
               BOTH = 5, FIRST = 6 };

__device__ __forceinline__ void wait_on(ws::ds2& x, ws::ds2 g) {
  asm volatile("" : "+f"(x.h), "+f"(x.l) : "f"(g.h), "f"(g.l));
}

// the (i, d, flags) that this step's commit gives on decision `split`, in
// a copy of the lane (its values are not the commit's; only the next
// point is read from it)
template <int MODE>
__device__ __forceinline__ ws::Lane successor(const ws::Lane& s,
                                              bool split) {
  ws::Lane n = s;
  const ws::ds2 zero = {0.0f, 0.0f};
  if constexpr (MODE == ws::STEP_SIMPSON) {
    ws::simpson_commit(n, zero, zero, split);
  } else {
    ws::Eval e = ws::trap_modes<false>(s);
    e.split = split;
    ws::commit<ws::STEP_TRAP, false>(n, e, split);
  }
  return n;
}

template <int MODE>
__device__ __forceinline__ ws::ds2 step_point(const ws::Lane& s) {
  if constexpr (MODE == ws::STEP_SIMPSON) return ws::simpson_point<FMA>(s);
  return ws::trap_point<FMA>(s);
}

// this step's test and commit with its evaluation fq; returns the
// decision
template <int MODE>
__device__ __forceinline__ bool decide(ws::Lane& s, ws::ds2 fq,
                                       float eps32) {
  if constexpr (MODE == ws::STEP_SIMPSON) {
    ws::SimpsonTest t = ws::simpson_test<FMA>(s, fq, eps32);
    ws::simpson_commit(s, fq, t.val, t.split);
    return t.split;
  } else {
    ws::Eval e = ws::trap_test<FMA, false>(s, fq, eps32);
    ws::commit<ws::STEP_TRAP, false>(s, e, e.split);
    return e.split;
  }
}

template <int MODE, int VARIANT>
__global__ void __launch_bounds__(wg::kThreads)
    k3_variant_kernel(void* const* p, float eps32, int iters) {
  const int lane = blockIdx.x * wg::kThreads + threadIdx.x;
  ws::Lane s = ws::load_lane(p, lane);
  const ws::ds2 th = {s.th_h, s.th_l};
  if constexpr (VARIANT == PLAIN) {
    int sc_n = 0, cf_n = 0;
    for (int k = 0; k < iters; ++k) ws::step<FAM, MODE>(s, eps32, sc_n, cf_n);
  } else if constexpr (VARIANT == BOTH) {
    if (iters > 0) {             // the prologue; the last step's pair dropped
      ws::ds2 fq = ws::f_ds<FAM>(step_point<MODE>(s), th);
      for (int k = 1; k < iters; ++k) {
        const ws::ds2 xs[2] = {step_point<MODE>(successor<MODE>(s, true)),
                               step_point<MODE>(successor<MODE>(s, false))};
        ws::ds2 g[2];
        ws::f_ds_n<FAM, 2>(xs, th, g);
        fq = decide<MODE>(s, fq, eps32) ? g[0] : g[1];
      }
      decide<MODE>(s, fq, eps32);
    }
  } else if constexpr (VARIANT == AHEAD) {
    ws::ds2 x = step_point<MODE>(s);
    for (int k = 0; k < iters; ++k) {
      const ws::ds2 fq = ws::f_ds<FAM>(x, th);
      const ws::ds2 x_split = step_point<MODE>(successor<MODE>(s, true));
      const ws::ds2 x_keep = step_point<MODE>(successor<MODE>(s, false));
      x = decide<MODE>(s, fq, eps32) ? x_split : x_keep;
    }
  } else if constexpr (VARIANT == FIRST) {
    ws::ds2 x = step_point<MODE>(s);
    for (int k = 0; k < iters; ++k) {
      const ws::ds2 x_split = step_point<MODE>(successor<MODE>(s, true));
      const ws::ds2 x_keep = step_point<MODE>(successor<MODE>(s, false));
      const ws::ds2 fq = ws::f_ds<FAM>(x, th);
      x = decide<MODE>(s, fq, eps32) ? x_split : x_keep;
    }
  } else if constexpr (VARIANT == EVAL1) {
    ws::ds2 x = step_point<MODE>(s), g = {0.0f, 0.0f};
    for (int k = 0; k < iters; ++k) {
      wait_on(x, g);
      g = ws::f_ds<FAM>(x, th);
    }
    s.fq_h = g.h;
    s.fq_l = g.l;
  } else if constexpr (VARIANT == EVAL2) {
    ws::ds2 xs[2] = {step_point<MODE>(s),
                     step_point<MODE>(successor<MODE>(s, true))};
    ws::ds2 g[2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    for (int k = 0; k < iters; ++k) {
      wait_on(xs[0], g[0]);
      wait_on(xs[1], g[1]);
      ws::f_ds_n<FAM, 2>(xs, th, g);
    }
    s.fq_h = g[0].h + g[1].h;
    s.fq_l = g[0].l + g[1].l;
  } else {
    static_assert(VARIANT == NOEVAL, "unknown variant");
    const ws::ds2 stored = {s.fl_h, s.fl_l};
    for (int k = 0; k < iters; ++k) {
      ws::ds2 v = stored;
      wait_on(v, step_point<MODE>(s));
      decide<MODE>(s, v, eps32);
    }
  }
  ws::store_lane(p, lane, s);
}

template <int MODE>
const void* pick_variant(int variant) {
  switch (variant) {
    case PLAIN: return reinterpret_cast<const void*>(&k3_variant_kernel<MODE, PLAIN>);
    case AHEAD: return reinterpret_cast<const void*>(&k3_variant_kernel<MODE, AHEAD>);
    case EVAL1: return reinterpret_cast<const void*>(&k3_variant_kernel<MODE, EVAL1>);
    case EVAL2: return reinterpret_cast<const void*>(&k3_variant_kernel<MODE, EVAL2>);
    case NOEVAL: return reinterpret_cast<const void*>(&k3_variant_kernel<MODE, NOEVAL>);
    case BOTH: return reinterpret_cast<const void*>(&k3_variant_kernel<MODE, BOTH>);
    case FIRST: return reinterpret_cast<const void*>(&k3_variant_kernel<MODE, FIRST>);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// One launch of variant `variant` in step machine `mode` (ws::STEP_TRAP
// or ws::STEP_SIMPSON) over `lanes` lanes (a multiple of 128) on
// `stream`; `d_ptrs` is a device array of the 26 state pointers. Returns
// 0, a cudaError_t code, or -2 for an unknown mode or variant.
int k3_variant_launch(void* const* d_ptrs, int lanes, int mode, int variant,
                      float eps32, int iters, void* stream) {
  const void* fn = mode == ws::STEP_TRAP      ? pick_variant<ws::STEP_TRAP>(variant)
                   : mode == ws::STEP_SIMPSON ? pick_variant<ws::STEP_SIMPSON>(variant)
                                              : nullptr;
  if (fn == nullptr || lanes % wg::kThreads != 0) return -2;
  void* args[] = {(void*)&d_ptrs, &eps32, &iters};
  cudaError_t err =
      cudaLaunchKernel(fn, dim3(lanes / wg::kThreads), dim3(wg::kThreads),
                       args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
