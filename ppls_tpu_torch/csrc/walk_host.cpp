// Host build of the walk kernels' step machine: the same per-lane
// functions as the CUDA kernels (walk_step.cuh), driven by plain
// sequential loops with the grid-wide counts taken over all lanes between
// steps. It exists so the CPU tests can hold the kernels' own arithmetic
// bit for bit against the plain PyTorch segments; it is built with g++
// -O2 -ffp-contract=off and is not used by the engine.
//
//   walk_rf_host   K1 (walk_rf.cu), the in-kernel-refill segment; with
//                  T > 1 every step evaluates all lanes, ORs the votes
//                  of each group of T lanes, then commits all lanes
//   walk_ee_host   K2 (walk_ee.cu), the early-exit segment
//   walk_seg_host  K3 (walk_seg.cu), the fixed-length segment

#include <vector>

#include "walk_step.cuh"

namespace {

template <int FAM, int MODE, bool THETA>
int rf(void* const* p, int lanes, int R, float eps32, int thresh, int cap,
       int batch, int T) {
  int* slot = static_cast<int*>(p[ws::P_SLOT]);
  const int* nslots = static_cast<const int*>(p[ws::P_NSLOTS]);
  float* rm_h = static_cast<float*>(p[ws::P_RESM_H]);
  float* rm_l = static_cast<float*>(p[ws::P_RESM_L]);
  int* rm_fam = static_cast<int*>(p[ws::P_RESM_FAM]);
  int* out = static_cast<int*>(p[ws::P_COUNTERS]);

  auto counts = [&](int& live, int& nref) {
    live = 0;
    nref = 0;
    for (int lane = 0; lane < lanes; ++lane) {
      ws::Lane s = ws::load_lane(p, lane);
      live += !ws::is_parked(s);
      nref += ws::takeable(s, slot[lane], nslots[lane]);
    }
  };

  ws::Waste w = {0, 0, 0, 0, 0};
  int sc_n = 0, cf_n = 0;
  int k = 0, live, nref;
  std::vector<ws::Lane> held(THETA ? lanes : 0);
  std::vector<ws::Eval> evals(THETA ? lanes : 0);
  std::vector<char> any(THETA ? lanes / T : 0);
  counts(live, nref);
  while (k == 0 || (k < cap && (live > thresh || nref > 0))) {
    bool refill = nref > 0 && (nref >= batch || live <= thresh);
    for (int lane = 0; lane < lanes; ++lane) {
      ws::Lane s = ws::load_lane(p, lane);
      if (refill) {
        ws::ResM rm = {rm_h[lane], rm_l[lane], rm_fam[lane]};
        ws::lane_take(s, slot[lane], nslots[lane], R, lane, lanes, p, rm);
        rm_h[lane] = rm.h;
        rm_l[lane] = rm.l;
        rm_fam[lane] = rm.fam;
      }
      ws::lane_classify<THETA>(s, slot[lane], nslots[lane], w);
      if constexpr (THETA) {
        evals[lane] = ws::evaluate<FAM, MODE, true>(s, eps32, sc_n, cf_n);
        held[lane] = s;
      } else {
        ws::step<FAM, MODE>(s, eps32, sc_n, cf_n);
        ws::store_lane(p, lane, s);
      }
    }
    if constexpr (THETA) {
      for (int g = 0; g < lanes / T; ++g) {
        any[g] = 0;
        for (int t = 0; t < T; ++t) any[g] |= evals[g * T + t].vote;
      }
      for (int lane = 0; lane < lanes; ++lane) {
        ws::commit<MODE, true>(held[lane], evals[lane], any[lane / T] != 0);
        ws::store_lane(p, lane, held[lane]);
      }
    }
    ++k;
    counts(live, nref);
  }
  out[0] = k;
  out[1] = w.active;
  out[2] = w.dead;
  out[3] = w.stall;
  out[4] = w.tail;
  out[5] = w.over;
  out[6] = sc_n;
  out[7] = cf_n;
  return 0;
}

template <int FAM, int MODE>
int ee(void* const* p, int lanes, float eps32, int thresh, int cap) {
  auto live_count = [&]() {
    int live = 0;
    for (int lane = 0; lane < lanes; ++lane)
      live += !ws::is_parked(ws::load_lane(p, lane));
    return live;
  };
  ws::WasteEE w = {0, 0, 0};
  int sc_n = 0, cf_n = 0;
  int k = 0, live = live_count();
  while (k == 0 || (k < cap && live > thresh)) {
    for (int lane = 0; lane < lanes; ++lane) {
      ws::Lane s = ws::load_lane(p, lane);
      ws::lane_classify_ee(s, w);
      ws::step<FAM, MODE>(s, eps32, sc_n, cf_n);
      ws::store_lane(p, lane, s);
    }
    ++k;
    live = live_count();
  }
  int* out = static_cast<int*>(p[ws::P_EE_COUNTERS]);
  out[0] = k;
  out[1] = w.active;
  out[2] = w.dead;
  out[3] = w.parked_root;
  out[4] = 0;
  out[5] = sc_n;
  out[6] = cf_n;
  return 0;
}

template <int FAM, int MODE>
int seg(void* const* p, int lanes, float eps32, int iters) {
  int sc_n = 0, cf_n = 0;
  for (int lane = 0; lane < lanes; ++lane) {
    ws::Lane s = ws::load_lane(p, lane);
    for (int k = 0; k < iters; ++k) ws::step<FAM, MODE>(s, eps32, sc_n, cf_n);
    ws::store_lane(p, lane, s);
  }
  return 0;
}

}  // namespace

// Each entry returns 0, or -2 for an unknown family or mode (or Simpson
// with T > 1); walk_rf_host returns -3 when T is not a power of two
// dividing lanes.
extern "C" {

int walk_rf_host(void* const* p, int lanes, int R, int family, int mode,
                 float eps32, int thresh, int cap, int batch, int T) {
  if (T < 1 || (T & (T - 1)) != 0 || lanes % T != 0) return -3;
  return ws::dispatch(family, mode, [&]<int FAM, int MODE>() {
    if constexpr (MODE == ws::STEP_SIMPSON) {
      if (T > 1) return -2;
      return rf<FAM, MODE, false>(p, lanes, R, eps32, thresh, cap, batch, 1);
    } else {
      if (T > 1)
        return rf<FAM, MODE, true>(p, lanes, R, eps32, thresh, cap, batch, T);
      return rf<FAM, MODE, false>(p, lanes, R, eps32, thresh, cap, batch, 1);
    }
  }, -2);
}

int walk_ee_host(void* const* p, int lanes, int family, int mode,
                 float eps32, int thresh, int cap) {
  return ws::dispatch(family, mode, [&]<int FAM, int MODE>() {
    return ee<FAM, MODE>(p, lanes, eps32, thresh, cap);
  }, -2);
}

int walk_seg_host(void* const* p, int lanes, int family, int mode,
                  float eps32, int iters) {
  return ws::dispatch(family, mode, [&]<int FAM, int MODE>() {
    if constexpr (MODE == ws::STEP_SCOUT)
      return -2;                            // K3 has no scout mode
    else
      return seg<FAM, MODE>(p, lanes, eps32, iters);
  }, -2);
}

}  // extern "C"
