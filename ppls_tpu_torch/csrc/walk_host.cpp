// Host build of the K1 step machine: the same per-lane functions as the
// CUDA kernel (walk_step.cuh), driven by a plain sequential loop with the
// grid-wide counts taken over all lanes between steps. It exists so the
// CPU tests can hold the kernel's own arithmetic bit for bit against the
// plain PyTorch segment; it is built with g++ -O2 -ffp-contract=off and
// is not used by the engine.

#include "walk_step.cuh"

namespace {

template <int FAM, bool SCOUT>
int run(void* const* p, int lanes, int R, float eps32, int thresh, int cap,
        int batch) {
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

  ws::Waste w = {0, 0, 0, 0};
  int sc_n = 0, cf_n = 0;
  int k = 0, live, nref;
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
      ws::lane_classify(s, slot[lane], nslots[lane], w);
      if (SCOUT)
        ws::step_scout<FAM>(s, eps32, sc_n, cf_n);
      else
        ws::step_trap<FAM>(s, eps32);
      ws::store_lane(p, lane, s);
    }
    ++k;
    counts(live, nref);
  }
  out[0] = k;
  out[1] = w.active;
  out[2] = w.dead;
  out[3] = w.stall;
  out[4] = w.tail;
  out[5] = 0;
  out[6] = sc_n;
  out[7] = cf_n;
  return 0;
}

}  // namespace

extern "C" int walk_rf_host(void* const* p, int lanes, int R, int family,
                            int scout, float eps32, int thresh, int cap,
                            int batch) {
  if (family == ws::FAMILY_SIN_RECIP)
    return scout ? run<ws::FAMILY_SIN_RECIP, true>(p, lanes, R, eps32,
                                                   thresh, cap, batch)
                 : run<ws::FAMILY_SIN_RECIP, false>(p, lanes, R, eps32,
                                                    thresh, cap, batch);
  if (family == ws::FAMILY_COSH4)
    return scout ? run<ws::FAMILY_COSH4, true>(p, lanes, R, eps32, thresh,
                                               cap, batch)
                 : run<ws::FAMILY_COSH4, false>(p, lanes, R, eps32, thresh,
                                                cap, batch);
  return -2;
}
