// Host build of the walk kernels' step machine: the same per-lane
// functions as the CUDA kernels (walk_step.cuh), driven by plain
// sequential loops with the grid-wide counts taken over all lanes between
// steps. It exists so the CPU tests can hold the kernels' own arithmetic
// bit for bit against the plain PyTorch segments; it is built with g++
// -O2 -ffp-contract=off and is not used by the engine.
//
//   walk_rf_host   K1 (walk_rf.cu), the in-kernel-refill segment; with
//                  T > 1 every step evaluates all lanes, ORs the votes
//                  of each group of T lanes (beyond one block through
//                  the kernel's own vote words, walk_grid.cuh), then
//                  commits all lanes
//   walk_ee_host   K2 (walk_ee.cu), the early-exit segment, in the
//                  kernel's speculate-then-commit order; with T > 1 its
//                  theta groups vote as K1's do
//   walk_seg_host  K3 (walk_seg.cu), the fixed-length segment
// The counts between steps go through the kernels' packed count
// (walk_grid.cuh): one word per block, summed. The wg_* entries expose
// the packing, the limits and the vote arithmetic to the tests, and
// ws_f_*_host the N-point integrand evaluations, ws_two_prod_host and
// ws_fma_product the two-product.

#include <stdint.h>

#include <vector>

#include "walk_grid.cuh"
#include "walk_step.cuh"

namespace {

// The grid-wide (live, nref) of the lanes as the kernels count them: one
// packed word per block of kThreads lanes, the words summed. Returns
// false if the arrivals do not come to the block count.
bool packed_counts(void* const* p, int lanes, const int* slot,
                   const int* nslots, int& live, int& nref) {
  const int blocks = (lanes + wg::kThreads - 1) / wg::kThreads;
  uint64_t total = 0;
  for (int b = 0; b < blocks; ++b) {
    uint64_t lb = 0, nb = 0;
    for (int lane = b * wg::kThreads;
         lane < lanes && lane < (b + 1) * wg::kThreads; ++lane) {
      ws::Lane s = ws::load_lane(p, lane);
      lb += !ws::is_parked(s);
      if (slot != nullptr) nb += ws::takeable(s, slot[lane], nslots[lane]);
    }
    total += wg::pack_count(1, lb, nb);
  }
  live = wg::count_live(total);
  nref = wg::count_nref(total);
  return wg::count_arrivals(total) == blocks;
}

// One theta-group vote for T > kThreads made the way wg::group_any makes
// it on the card: each block ORs its lanes' votes and adds vote_word into
// its group's word of set c % 3 of `slots`, which are never cleared; a
// lane's answer is vote_any of its group's word minus the word's value
// after the set's previous vote (`base`, kept per word), once all of the
// group's blocks arrived. Returns false if a word did not gain exactly
// its group's arrivals.
bool group_vote(const std::vector<char>& vote, int lanes, int T, int c,
                std::vector<uint32_t>& slots, std::vector<uint32_t>& base,
                std::vector<char>& any) {
  const int G = lanes / T, blocks = lanes / wg::kThreads;
  for (int b = 0; b < blocks; ++b) {
    bool block_any = false;
    for (int t = 0; t < wg::kThreads; ++t)
      block_any = block_any || vote[b * wg::kThreads + t] != 0;
    slots[wg::vote_slot(wg::vote_group(b, T), G, c)] +=
        wg::vote_word(block_any);
  }
  for (int b = 0; b < blocks; ++b) {
    const int j = wg::vote_slot(wg::vote_group(b, T), G, c);
    const uint32_t w = slots[j] - base[j];
    if (wg::vote_arrivals(w) != wg::vote_blocks(T)) return false;
    for (int t = 0; t < wg::kThreads; ++t)
      any[b * wg::kThreads + t] = wg::vote_any(w);
  }
  for (int g = 0; g < G; ++g) base[wg::vote_slot(g, G, c)] =
      slots[wg::vote_slot(g, G, c)];
  return true;
}

// Every lane's answer to its group's union vote: the OR of the votes of
// its T adjacent lanes, through the kernels' vote words (group_vote) for
// T > kThreads. Returns false if a word did not gain its arrivals.
bool theta_vote(const std::vector<char>& vote, int lanes, int T, int c,
                std::vector<uint32_t>& slots, std::vector<uint32_t>& base,
                std::vector<char>& any) {
  if (T > wg::kThreads) return group_vote(vote, lanes, T, c, slots, base, any);
  for (int g = 0; g < lanes / T; ++g) {
    char a = 0;
    for (int t = 0; t < T; ++t) a |= vote[g * T + t];
    for (int t = 0; t < T; ++t) any[g * T + t] = a;
  }
  return true;
}

template <int FAM, int MODE, bool THETA>
int rf(void* const* p, int lanes, int R, float eps32, int thresh, int cap,
       int batch, int T) {
  int* slot = static_cast<int*>(p[ws::P_SLOT]);
  const int* nslots = static_cast<const int*>(p[ws::P_NSLOTS]);
  float* rm_h = static_cast<float*>(p[ws::P_RESM_H]);
  float* rm_l = static_cast<float*>(p[ws::P_RESM_L]);
  int* rm_fam = static_cast<int*>(p[ws::P_RESM_FAM]);
  int* out = static_cast<int*>(p[ws::P_COUNTERS]);

  ws::Waste w = {0, 0, 0, 0, 0};
  int sc_n = 0, cf_n = 0;
  int k = 0, live, nref;
  std::vector<ws::Lane> held(THETA ? lanes : 0);
  std::vector<ws::Eval> evals(THETA ? lanes : 0);
  std::vector<char> vote(THETA ? lanes : 0), any(THETA ? lanes : 0);
  std::vector<uint32_t> vote_slots(THETA ? 3 * (lanes / T) : 0, 0u);
  std::vector<uint32_t> vote_base(vote_slots.size(), 0u);
  if (!packed_counts(p, lanes, slot, nslots, live, nref)) return -6;
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
      for (int lane = 0; lane < lanes; ++lane) vote[lane] = evals[lane].vote;
      if (!theta_vote(vote, lanes, T, k, vote_slots, vote_base, any))
        return -6;
      for (int lane = 0; lane < lanes; ++lane) {
        ws::commit<MODE, true>(held[lane], evals[lane], any[lane] != 0);
        ws::store_lane(p, lane, held[lane]);
      }
    }
    ++k;
    if (!packed_counts(p, lanes, slot, nslots, live, nref)) return -6;
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

// K2's order (walk_ee.cu): the first step; then, while k < cap, the
// count of the state after step k, step k + 1 on copies of every lane
// and of the counters, and the copies kept only when the count exceeds
// thresh. The state after step k stays in `p` until a step is kept. In
// theta mode (T > 1) a step evaluates every lane, takes each group's
// vote (one vote per computed step, as the kernel's lanes cast them,
// dropped steps included), then commits every lane.
template <int FAM, int MODE, bool THETA>
int ee(void* const* p, int lanes, float eps32, int thresh, int cap, int T) {
  ws::WasteEE w = {0, 0, 0, 0};
  int sc_n = 0, cf_n = 0;
  std::vector<ws::Lane> next(lanes);
  std::vector<ws::Eval> evals(THETA ? lanes : 0);
  std::vector<char> vote(THETA ? lanes : 0), any(THETA ? lanes : 0);
  std::vector<uint32_t> vote_slots(THETA ? 3 * (lanes / T) : 0, 0u);
  std::vector<uint32_t> vote_base(vote_slots.size(), 0u);
  int v = 0;
  // one step of every lane of `next`, counted into tw, tsc and tcf
  auto step_all = [&](ws::WasteEE& tw, int& tsc, int& tcf) {
    for (int lane = 0; lane < lanes; ++lane) {
      ws::lane_classify_ee<THETA>(next[lane], tw);
      if constexpr (THETA)
        evals[lane] = ws::evaluate<FAM, MODE, true>(next[lane], eps32, tsc,
                                                    tcf);
      else
        ws::step<FAM, MODE>(next[lane], eps32, tsc, tcf);
    }
    if constexpr (THETA) {
      for (int lane = 0; lane < lanes; ++lane) vote[lane] = evals[lane].vote;
      if (!theta_vote(vote, lanes, T, v++, vote_slots, vote_base, any))
        return false;
      for (int lane = 0; lane < lanes; ++lane)
        ws::commit<MODE, true>(next[lane], evals[lane], any[lane] != 0);
    }
    return true;
  };
  for (int lane = 0; lane < lanes; ++lane) next[lane] = ws::load_lane(p, lane);
  if (!step_all(w, sc_n, cf_n)) return -6;
  for (int lane = 0; lane < lanes; ++lane) ws::store_lane(p, lane, next[lane]);
  int k = 1, live, nref;
  while (k < cap) {
    if (!packed_counts(p, lanes, nullptr, nullptr, live, nref)) return -6;
    ws::WasteEE tw = w;
    int tsc = sc_n, tcf = cf_n;
    for (int lane = 0; lane < lanes; ++lane)
      next[lane] = ws::load_lane(p, lane);
    if (!step_all(tw, tsc, tcf)) return -6;
    if (live <= thresh) break;
    for (int lane = 0; lane < lanes; ++lane)
      ws::store_lane(p, lane, next[lane]);
    w = tw;
    sc_n = tsc;
    cf_n = tcf;
    ++k;
  }
  int* out = static_cast<int*>(p[ws::P_EE_COUNTERS]);
  out[0] = k;
  out[1] = w.active;
  out[2] = w.dead;
  out[3] = w.parked_root;
  out[4] = w.over;
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
// with T > 1); walk_rf_host and walk_ee_host return -3 when T is
// not a power of two dividing lanes; walk_rf_host and the walk_ee entries
// return -6 if a packed count or a vote word did not hold its arrivals.
extern "C" {

// the packed count's layout: {kArrivalBits, kCountBits, kMaxBlocks,
// kMaxLanes, kThreads}
void wg_limits(int* out) {
  out[0] = wg::kArrivalBits;
  out[1] = wg::kCountBits;
  out[2] = wg::kMaxBlocks;
  out[3] = wg::kMaxLanes;
  out[4] = wg::kThreads;
}

int wg_packed_fits(int lanes) { return wg::packed_fits(lanes) ? 1 : 0; }

// The packed words (1 arrival, live[b], nref[b]) of `blocks` blocks
// added to a word that held `base`, and the gain decoded into out =
// {arrivals, live, nref}: one step of a never-cleared count word.
void wg_pack_sum(uint64_t base, int blocks, const int* live, const int* nref,
                 int* out) {
  uint64_t w = base;
  for (int b = 0; b < blocks; ++b)
    w += wg::pack_count(1, static_cast<uint64_t>(live[b]),
                        static_cast<uint64_t>(nref[b]));
  w -= base;
  out[0] = wg::count_arrivals(w);
  out[1] = wg::count_live(w);
  out[2] = wg::count_nref(w);
}

// `rounds` successive group votes over `lanes` lanes (votes and any:
// rounds x lanes, row-major) through the vote words the kernel uses for
// T > kThreads, rotating and never cleared as on the card; every word
// starts at `init` (0 on the card, where a word wraps only after many
// votes). Returns 0, -3 unless kThreads < T, T a power of two dividing
// lanes, or -6 if a word did not gain its group's arrivals.
int wg_group_any_host(const int* votes, int lanes, int T, int rounds,
                      uint32_t init, int* any_out) {
  if (T <= wg::kThreads || (T & (T - 1)) != 0 || lanes % T != 0) return -3;
  std::vector<uint32_t> slots(3 * (lanes / T), init), base(slots);
  std::vector<char> vote(lanes), any(lanes);
  for (int c = 0; c < rounds; ++c) {
    for (int lane = 0; lane < lanes; ++lane)
      vote[lane] = votes[c * lanes + lane] != 0;
    if (!group_vote(vote, lanes, T, c, slots, base, any)) return -6;
    for (int lane = 0; lane < lanes; ++lane)
      any_out[c * lanes + lane] = any[lane];
  }
  return 0;
}

// The kernels' two-product of n float32 pairs, in the FMA form when
// `fma`, else Dekker's: p + e == a * b.
void ws_two_prod_host(int fma, int n, const float* a, const float* b,
                      float* p, float* e) {
  for (int j = 0; j < n; ++j) {
    const ws::ds2 r = fma ? ws::two_prod<true>(a[j], b[j])
                          : ws::two_prod<false>(a[j], b[j]);
    p[j] = r.h;
    e[j] = r.l;
  }
}

// The two-product form each integrand body's step runs: 1 FMA, 0 Dekker,
// -2 for an unknown family.
int ws_fma_product(int family) {
  return ws::dispatch(family, ws::STEP_TRAP, []<int FAM, int MODE>() {
    return ws::fma_product(FAM) ? 1 : 0;
  }, -2);
}

// The integrand at n points of one theta, the scouting confirm's way
// (three points side by side) when `wide`, else one point at a time:
// out_h/out_l[j] = f_ds(x[j], theta); n a multiple of 3.
int ws_f_ds_host(int family, int wide, int n, const float* x_h,
                 const float* x_l, float th_h, float th_l, float* out_h,
                 float* out_l) {
  if (n % 3 != 0) return -3;
  return ws::dispatch(family, ws::STEP_TRAP, [&]<int FAM, int MODE>() {
    const ws::ds2 th = {th_h, th_l};
    for (int j = 0; j < n; j += 3) {
      const ws::ds2 x[3] = {{x_h[j], x_l[j]}, {x_h[j + 1], x_l[j + 1]},
                            {x_h[j + 2], x_l[j + 2]}};
      ws::ds2 g[3];
      if (wide) {
        ws::f_ds_n<FAM, 3>(x, th, g);
      } else {
        for (int t = 0; t < 3; ++t) g[t] = ws::f_ds<FAM>(x[t], th);
      }
      for (int t = 0; t < 3; ++t) {
        out_h[j + t] = g[t].h;
        out_l[j + t] = g[t].l;
      }
    }
    return 0;
  }, -2);
}

// The scout (float32) twin the same way: out[j] = f_sc(x[j], theta).
int ws_f_sc_host(int family, int wide, int n, const float* x, float th,
                 float* out) {
  if (n % 3 != 0) return -3;
  return ws::dispatch(family, ws::STEP_TRAP, [&]<int FAM, int MODE>() {
    for (int j = 0; j < n; j += 3) {
      const float xs[3] = {x[j], x[j + 1], x[j + 2]};
      float g[3];
      if (wide) {
        ws::f_sc_n<FAM, 3>(xs, th, g);
      } else {
        for (int t = 0; t < 3; ++t) g[t] = ws::f_sc<FAM>(xs[t], th);
      }
      for (int t = 0; t < 3; ++t) out[j + t] = g[t];
    }
    return 0;
  }, -2);
}

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
                 float eps32, int thresh, int cap, int T) {
  if (T < 1 || (T & (T - 1)) != 0 || lanes % T != 0) return -3;
  return ws::dispatch(family, mode, [&]<int FAM, int MODE>() {
    if constexpr (MODE == ws::STEP_SIMPSON) {
      if (T > 1) return -2;
      return ee<FAM, MODE, false>(p, lanes, eps32, thresh, cap, 1);
    } else {
      if (T > 1) return ee<FAM, MODE, true>(p, lanes, eps32, thresh, cap, T);
      return ee<FAM, MODE, false>(p, lanes, eps32, thresh, cap, 1);
    }
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
