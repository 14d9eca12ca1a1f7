// Per-lane step machine of the in-kernel-refill walk segment.
//
// Everything here is __host__ __device__: the CUDA kernel (walk_rf.cu)
// runs it with one thread per lane, and walk_host.cpp runs the same
// functions in a plain host loop so the CPU tests can hold the kernel's
// own arithmetic bit for bit against the plain PyTorch segment
// (ppls_tpu_torch/parallel/walker.py) before any card is involved.
//
// Numerics: double-single (two-float32) arithmetic whose error-free
// transforms die under multiply-add contraction or flush-to-zero. Build
// with nvcc -fmad=false -ftz=false -prec-div=true -prec-sqrt=true (never
// --use_fast_math) and with g++ -ffp-contract=off. Every function below
// performs the float32 operations of its twin in ops/ds_kernel.py,
// ops/scout_kernel.py and models/integrands.py, in the same order.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define WS_HD __host__ __device__ __forceinline__
#else
#define WS_HD inline
#endif

namespace ws {

// --- lane flags and layout (walker.py) --------------------------------------
constexpr int MODE_LOAD = 1;
constexpr int PARKED = 2;
constexpr int NO_ROOT = 4;
constexpr int OVF = 8;
constexpr int MODE_INIT = 16;
constexpr int MAX_REL_DEPTH = 30;
constexpr int DEPTH_BITS = 14;
constexpr int DEPTH_MASK = (1 << DEPTH_BITS) - 1;

// integrand ids (models/integrands.py KERNEL_*)
constexpr int FAMILY_SIN_RECIP = 0;   // sin(theta / x)
constexpr int FAMILY_COSH4 = 1;       // cosh(theta x)^4

// pointer table of one segment launch (walker.py _K1_POINTERS order)
constexpr int N_STATE = 26;           // WalkState fields, in order
constexpr int P_NSLOTS = 26;
constexpr int P_SLOT = 27;
constexpr int P_BANK = 28;            // a_h, a_l, w_h, w_l, th_h, th_l, meta
constexpr int P_RESM_H = 35;
constexpr int P_RESM_L = 36;
constexpr int P_RESM_FAM = 37;
constexpr int P_RESH = 38;
constexpr int P_RESL = 39;
constexpr int P_COUNTERS = 40;        // int32[8]: steps, 5 waste, 2 evals
constexpr int P_SYNC = 41;            // int32[6], zeroed: grid counts
constexpr int N_PTRS = 42;

// --- float32 constants (exact values of the Python modules' constants) ------
constexpr float K_SPLIT = 4097.0f;
constexpr float K_PIO2_1 = 0x1.921fb6p+0f;
constexpr float K_PIO2_2 = -0x1.777a5cp-25f;
constexpr float K_PIO2_3 = -0x1.0p-49f;
constexpr float K_TWO_OVER_PI = 0x1.45f306p-1f;
constexpr float K_S3_H = -0x1.555556p-3f, K_S3_L = 0x1.555556p-28f;
constexpr float K_S5_H = 0x1.111112p-7f, K_S5_L = -0x1.dddddep-32f;
constexpr float K_S7_H = -0x1.a01a02p-13f, K_S7_L = 0x1.7f97fap-39f;
constexpr float K_S9_H = 0x1.71de3ap-19f, K_S9_L = 0x1.55b1ccp-45f;
constexpr float K_S11 = -0x1.ae6456p-26f;
constexpr float K_S13 = 0x1.612462p-33f;
constexpr float K_C2_H = -0x1.0p-1f, K_C2_L = 0.0f;
constexpr float K_C4_H = 0x1.555556p-5f, K_C4_L = -0x1.555556p-30f;
constexpr float K_C6_H = -0x1.6c16c2p-10f, K_C6_L = 0x1.27d27ep-35f;
constexpr float K_C8_H = 0x1.a01a02p-16f, K_C8_L = -0x1.7f97fap-42f;
constexpr float K_C10 = -0x1.27e4fcp-22f;
constexpr float K_C12 = 0x1.1eed8ep-29f;
constexpr float K_LN2_1 = 0x1.62e43p-1f;
constexpr float K_LN2_2 = -0x1.05c61p-29f;
constexpr float K_LN2_3 = -0x1.0p-53f;
constexpr float K_LOG2E = 0x1.715476p+0f;
constexpr float K_E3_H = 0x1.555556p-3f, K_E3_L = -0x1.555556p-28f;
constexpr float K_E4_H = 0x1.555556p-5f, K_E4_L = -0x1.555556p-30f;
constexpr float K_E5_H = 0x1.111112p-7f, K_E5_L = -0x1.dddddep-32f;
constexpr float K_E6_H = 0x1.6c16c2p-10f, K_E6_L = -0x1.27d27ep-35f;
constexpr float K_E7_H = 0x1.a01a02p-13f, K_E7_L = -0x1.7f97fap-39f;
constexpr float K_E8_H = 0x1.a01a02p-16f, K_E8_L = -0x1.7f97fap-42f;
constexpr float K_E9_H = 0x1.71de3ap-19f, K_E9_L = 0x1.55b1ccp-45f;
constexpr float K_E10 = 0x1.27e4fcp-22f;
constexpr float K_E11 = 0x1.ae6456p-26f;
constexpr float K_E12 = 0x1.1eed8ep-29f;
// scout (plain float32) polynomial coefficients
constexpr float K_SC_S3 = -0x1.555556p-3f, K_SC_S5 = 0x1.111112p-7f;
constexpr float K_SC_S7 = -0x1.a01a02p-13f, K_SC_S9 = 0x1.71de3ap-19f;
constexpr float K_SC_S11 = -0x1.ae6456p-26f;
constexpr float K_SC_C2 = -0x1.0p-1f, K_SC_C4 = 0x1.555556p-5f;
constexpr float K_SC_C6 = -0x1.6c16c2p-10f, K_SC_C8 = 0x1.a01a02p-16f;
constexpr float K_SC_C10 = -0x1.27e4fcp-22f;
constexpr float K_SC_E2 = 0x1.0p-1f, K_SC_E3 = 0x1.555556p-3f;
constexpr float K_SC_E4 = 0x1.555556p-5f, K_SC_E5 = 0x1.111112p-7f;
constexpr float K_SC_E6 = 0x1.6c16c2p-10f, K_SC_E7 = 0x1.a01a02p-13f;
// scout guard band: 64 float32 ulps, 64 * 2^-23
constexpr float K_SCOUT_BAND = 0x1.0p-17f;

// --- bit helpers -------------------------------------------------------------

WS_HD float int_as_float(int v) {
#ifdef __CUDA_ARCH__
  return __int_as_float(v);
#else
  float f;
  memcpy(&f, &v, sizeof f);
  return f;
#endif
}

// count trailing zeros of a positive int
WS_HD int ctz_pos(int k) {
#ifdef __CUDA_ARCH__
  return __ffs(k) - 1;
#else
  return __builtin_ctz(static_cast<unsigned>(k));
#endif
}

// exact 2^k for integer k in [-126, 127]; 0 below
WS_HD float pow2_f32(int ki) {
  int biased = ki + 127;
  biased = biased < 254 ? biased : 254;
  biased = biased > 1 ? biased : 1;
  float v = int_as_float(biased << 23);
  return ki < -126 ? 0.0f : v;
}

// --- double-single arithmetic (ops/ds_kernel.py) -----------------------------

struct ds2 {
  float h, l;
};

WS_HD ds2 two_sum(float a, float b) {
  float s = a + b;
  float v = s - a;
  float e = (a - (s - v)) + (b - v);
  return {s, e};
}

WS_HD ds2 quick_two_sum(float a, float b) {
  float s = a + b;
  float e = b - (s - a);
  return {s, e};
}

WS_HD void dekker_split(float a, float& hi, float& lo) {
  float t = K_SPLIT * a;
  hi = t - (t - a);
  lo = a - hi;
}

WS_HD ds2 two_prod(float a, float b) {
  float p = a * b;
  float ah, al, bh, bl;
  dekker_split(a, ah, al);
  dekker_split(b, bh, bl);
  float e = ((ah * bh - p) + ah * bl + al * bh) + al * bl;
  return {p, e};
}

WS_HD ds2 ds_neg(ds2 x) { return {-x.h, -x.l}; }

WS_HD ds2 ds_add(ds2 x, ds2 y) {
  ds2 s = two_sum(x.h, y.h);
  float e = s.l + (x.l + y.l);
  return quick_two_sum(s.h, e);
}

WS_HD ds2 ds_sub(ds2 x, ds2 y) { return ds_add(x, ds_neg(y)); }

WS_HD ds2 ds_add_f32(ds2 x, float b) {
  ds2 s = two_sum(x.h, b);
  float e = s.l + x.l;
  return quick_two_sum(s.h, e);
}

WS_HD ds2 ds_mul(ds2 x, ds2 y) {
  ds2 p = two_prod(x.h, y.h);
  float e = p.l + (x.h * y.l + x.l * y.h);
  return quick_two_sum(p.h, e);
}

WS_HD ds2 ds_mul_f32(ds2 x, float b) {
  ds2 p = two_prod(x.h, b);
  float e = p.l + x.l * b;
  return quick_two_sum(p.h, e);
}

WS_HD ds2 ds_mul_pow2(ds2 x, float k) { return {x.h * k, x.l * k}; }

WS_HD ds2 ds_div(ds2 x, ds2 y) {
  float q1 = x.h / y.h;
  ds2 p = two_prod(q1, y.h);
  ds2 r = ds_sub(x, ds2{p.h, p.l + q1 * y.l});
  float q2 = (r.h + r.l) / y.h;
  return quick_two_sum(q1, q2);
}

WS_HD ds2 ds_abs(ds2 x) {
  bool neg = x.h < 0.0f;
  return {neg ? -x.h : x.h, neg ? -x.l : x.l};
}

WS_HD ds2 ds_where(bool c, ds2 x, ds2 y) { return c ? x : y; }

WS_HD ds2 sin_poly(ds2 y) {
  ds2 y2 = ds_mul(y, y);
  float tail = K_S11 + y2.h * K_S13;
  ds2 p = ds_add(ds2{K_S9_H, K_S9_L}, ds_mul_f32(y2, tail));
  p = ds_add(ds2{K_S7_H, K_S7_L}, ds_mul(y2, p));
  p = ds_add(ds2{K_S5_H, K_S5_L}, ds_mul(y2, p));
  p = ds_add(ds2{K_S3_H, K_S3_L}, ds_mul(y2, p));
  return ds_add(y, ds_mul(ds_mul(y, y2), p));
}

WS_HD ds2 cos_poly(ds2 y) {
  ds2 y2 = ds_mul(y, y);
  float tail = K_C10 + y2.h * K_C12;
  ds2 p = ds_add(ds2{K_C8_H, K_C8_L}, ds_mul_f32(y2, tail));
  p = ds_add(ds2{K_C6_H, K_C6_L}, ds_mul(y2, p));
  p = ds_add(ds2{K_C4_H, K_C4_L}, ds_mul(y2, p));
  p = ds_add(ds2{K_C2_H, K_C2_L}, ds_mul(y2, p));
  return ds_add(ds2{1.0f, 0.0f}, ds_mul(y2, p));
}

WS_HD ds2 ds_sin(ds2 x) {
  float k = rintf(x.h * K_TWO_OVER_PI);
  ds2 t1 = two_prod(k, K_PIO2_1);
  float h = x.h - t1.h;  // exact by Sterbenz
  ds2 t2 = two_prod(k, K_PIO2_2);
  ds2 y = {h, 0.0f};
  y = ds_add_f32(y, -t1.l);
  y = ds_add_f32(y, x.l);
  y = ds_add_f32(y, -t2.h);
  y = ds_add_f32(y, -t2.l);
  y = ds_add_f32(y, -(k * K_PIO2_3));
  int q = static_cast<int>(k) & 3;
  ds2 sin_y = sin_poly(y);
  ds2 cos_y = cos_poly(y);
  ds2 res = ((q & 1) == 1) ? cos_y : sin_y;
  return (q >= 2) ? ds_neg(res) : res;
}

WS_HD ds2 exp_poly(ds2 r) {
  float tail = K_E10 + r.h * (K_E11 + r.h * K_E12);
  ds2 p = ds_add(ds2{K_E9_H, K_E9_L}, ds_mul_f32(r, tail));
  p = ds_add(ds2{K_E8_H, K_E8_L}, ds_mul(r, p));
  p = ds_add(ds2{K_E7_H, K_E7_L}, ds_mul(r, p));
  p = ds_add(ds2{K_E6_H, K_E6_L}, ds_mul(r, p));
  p = ds_add(ds2{K_E5_H, K_E5_L}, ds_mul(r, p));
  p = ds_add(ds2{K_E4_H, K_E4_L}, ds_mul(r, p));
  p = ds_add(ds2{K_E3_H, K_E3_L}, ds_mul(r, p));
  p = ds_add(ds2{0.5f, 0.0f}, ds_mul(r, p));
  return ds_add(ds_add(ds2{1.0f, 0.0f}, r), ds_mul(ds_mul(r, r), p));
}

WS_HD ds2 ds_exp(ds2 x) {
  float k = rintf(x.h * K_LOG2E);
  ds2 t1 = two_prod(k, K_LN2_1);
  float h = x.h - t1.h;  // exact by Sterbenz
  ds2 t2 = two_prod(k, K_LN2_2);
  ds2 y = {h, 0.0f};
  y = ds_add_f32(y, -t1.l);
  y = ds_add_f32(y, x.l);
  y = ds_add_f32(y, -t2.h);
  y = ds_add_f32(y, -t2.l);
  y = ds_add_f32(y, -(k * K_LN2_3));
  ds2 e = exp_poly(y);
  float s = pow2_f32(static_cast<int>(k));
  return {e.h * s, e.l * s};
}

// --- scout arithmetic (ops/scout_kernel.py): plain float32 ------------------

WS_HD float sc_sin(float xv) {
  float k = rintf(xv * K_TWO_OVER_PI);
  ds2 t1 = two_prod(k, K_PIO2_1);
  float y = (xv - t1.h) - (t1.l + k * K_PIO2_2);
  float y2 = y * y;
  float sp = K_SC_S9 + y2 * K_SC_S11;
  sp = K_SC_S7 + y2 * sp;
  sp = K_SC_S5 + y2 * sp;
  sp = K_SC_S3 + y2 * sp;
  float sin_y = y + y * y2 * sp;
  float cp = K_SC_C8 + y2 * K_SC_C10;
  cp = K_SC_C6 + y2 * cp;
  cp = K_SC_C4 + y2 * cp;
  cp = K_SC_C2 + y2 * cp;
  float cos_y = 1.0f + y2 * cp;
  int q = static_cast<int>(k) & 3;
  float res = ((q & 1) == 1) ? cos_y : sin_y;
  return (q >= 2) ? -res : res;
}

WS_HD float sc_exp(float xv) {
  float k = rintf(xv * K_LOG2E);
  ds2 t1 = two_prod(k, K_LN2_1);
  float r = (xv - t1.h) - (t1.l + k * K_LN2_2);
  float p = K_SC_E6 + r * K_SC_E7;
  p = K_SC_E5 + r * p;
  p = K_SC_E4 + r * p;
  p = K_SC_E3 + r * p;
  p = K_SC_E2 + r * p;
  float e = 1.0f + r * (1.0f + r * p);
  float s = pow2_f32(static_cast<int>(k));
  return e * s;
}

// --- integrands (models/integrands.py ds twins) ------------------------------

template <int FAM>
WS_HD ds2 f_ds(ds2 x, ds2 th);

template <>
WS_HD ds2 f_ds<FAMILY_SIN_RECIP>(ds2 x, ds2 th) {
  return ds_sin(ds_div(th, x));
}

template <>
WS_HD ds2 f_ds<FAMILY_COSH4>(ds2 x, ds2 th) {
  ds2 u = ds_mul(th, x);
  ds2 e = ds_exp(u);
  ds2 inv = ds_div(ds2{1.0f, 0.0f}, e);
  ds2 c = ds_mul_pow2(ds_add(e, inv), 0.5f);
  ds2 c2 = ds_mul(c, c);
  return ds_mul(c2, c2);
}

// scout twins: only the hi limbs matter (the lo limbs are +0.0)
template <int FAM>
WS_HD float f_sc(float x, float th);

template <>
WS_HD float f_sc<FAMILY_SIN_RECIP>(float x, float th) {
  return sc_sin(th / x);
}

template <>
WS_HD float f_sc<FAMILY_COSH4>(float x, float th) {
  float u = th * x;
  float e = sc_exp(u);
  float inv = 1.0f / e;
  float c = (e + inv) * 0.5f;
  float c2 = c * c;
  return c2 * c2;
}

// --- lane state --------------------------------------------------------------

struct Lane {
  float a_h, a_l, w_h, w_l, th_h, th_l;
  float fl_h, fl_l, fr_h, fr_l, fm_h, fm_l, fq_h, fq_l, acc_h, acc_l;
  int i, d, base_d, fam, flags, tasks, splits, maxd, mk_i, mk_d;
};

WS_HD Lane load_lane(void* const* p, int lane) {
  Lane s;
  float* f[16];
  for (int j = 0; j < 16; ++j) f[j] = static_cast<float*>(p[j]);
  int* n[10];
  for (int j = 0; j < 10; ++j) n[j] = static_cast<int*>(p[16 + j]);
  s.a_h = f[0][lane]; s.a_l = f[1][lane];
  s.w_h = f[2][lane]; s.w_l = f[3][lane];
  s.th_h = f[4][lane]; s.th_l = f[5][lane];
  s.fl_h = f[6][lane]; s.fl_l = f[7][lane];
  s.fr_h = f[8][lane]; s.fr_l = f[9][lane];
  s.fm_h = f[10][lane]; s.fm_l = f[11][lane];
  s.fq_h = f[12][lane]; s.fq_l = f[13][lane];
  s.acc_h = f[14][lane]; s.acc_l = f[15][lane];
  s.i = n[0][lane]; s.d = n[1][lane]; s.base_d = n[2][lane];
  s.fam = n[3][lane]; s.flags = n[4][lane]; s.tasks = n[5][lane];
  s.splits = n[6][lane]; s.maxd = n[7][lane];
  s.mk_i = n[8][lane]; s.mk_d = n[9][lane];
  return s;
}

WS_HD void store_lane(void* const* p, int lane, const Lane& s) {
  float* f[16];
  for (int j = 0; j < 16; ++j) f[j] = static_cast<float*>(p[j]);
  int* n[10];
  for (int j = 0; j < 10; ++j) n[j] = static_cast<int*>(p[16 + j]);
  f[0][lane] = s.a_h; f[1][lane] = s.a_l;
  f[2][lane] = s.w_h; f[3][lane] = s.w_l;
  f[4][lane] = s.th_h; f[5][lane] = s.th_l;
  f[6][lane] = s.fl_h; f[7][lane] = s.fl_l;
  f[8][lane] = s.fr_h; f[9][lane] = s.fr_l;
  f[10][lane] = s.fm_h; f[11][lane] = s.fm_l;
  f[12][lane] = s.fq_h; f[13][lane] = s.fq_l;
  f[14][lane] = s.acc_h; f[15][lane] = s.acc_l;
  n[0][lane] = s.i; n[1][lane] = s.d; n[2][lane] = s.base_d;
  n[3][lane] = s.fam; n[4][lane] = s.flags; n[5][lane] = s.tasks;
  n[6][lane] = s.splits; n[7][lane] = s.maxd;
  n[8][lane] = s.mk_i; n[9][lane] = s.mk_d;
}

// the sentinel result row of one lane (the take at cursor 0 banks here)
struct ResM {
  float h, l;
  int fam;
};

WS_HD bool is_parked(const Lane& s) { return (s.flags & PARKED) != 0; }

// parked, not depth-overflowed, with a dealt root left: refillable
WS_HD bool takeable(const Lane& s, int slot, int nslots) {
  return is_parked(s) && (s.flags & OVF) == 0 && slot < nslots;
}

// --- refill: bank the finished root, take the next private root -------------

WS_HD void lane_take(Lane& s, int& slot, int nslots, int R, int lane,
                     int lanes, void* const* p, ResM& rm) {
  if (!takeable(s, slot, nslots)) return;
  int prev = slot - 1;
  if (prev == -1) {
    rm.h = s.acc_h;
    rm.l = s.acc_l;
    rm.fam = s.fam;
  } else if (prev >= 0 && prev < R) {
    static_cast<float*>(p[P_RESH])[prev * lanes + lane] = s.acc_h;
    static_cast<float*>(p[P_RESL])[prev * lanes + lane] = s.acc_l;
  }
  int meta = 0;
  if (slot >= 0 && slot < R) {
    int idx = slot * lanes + lane;
    s.a_h = static_cast<const float*>(p[P_BANK + 0])[idx];
    s.a_l = static_cast<const float*>(p[P_BANK + 1])[idx];
    s.w_h = static_cast<const float*>(p[P_BANK + 2])[idx];
    s.w_l = static_cast<const float*>(p[P_BANK + 3])[idx];
    s.th_h = static_cast<const float*>(p[P_BANK + 4])[idx];
    s.th_l = static_cast<const float*>(p[P_BANK + 5])[idx];
    meta = static_cast<const int*>(p[P_BANK + 6])[idx];
  }
  s.fl_h = s.fl_l = s.fr_h = s.fr_l = 0.0f;
  s.fm_h = s.fm_l = s.fq_h = s.fq_l = 0.0f;
  s.acc_h = s.acc_l = 0.0f;
  s.i = 0;
  s.d = 0;
  s.base_d = meta & DEPTH_MASK;
  s.fam = meta >> DEPTH_BITS;
  s.flags = MODE_INIT;
  s.mk_i = 0;
  s.mk_d = -1;
  slot += 1;
}

// lane-waste classification of the state a step evaluates
struct Waste {
  int active, dead, stall, tail;
};

WS_HD void lane_classify(const Lane& s, int slot, int nslots, Waste& w) {
  int live = !is_parked(s);
  int stall = takeable(s, slot, nslots);
  int dead = ((s.flags & NO_ROOT) != 0) && !stall;
  w.active += live;
  w.stall += stall;
  w.dead += dead;
  w.tail += 1 - live - stall - dead;
}

// --- geometry and steps (walker.py _node_geometry / step / step_scout) ------

WS_HD void node_geometry(const Lane& s, ds2& w, ds2& x0, ds2& x1) {
  float scale = pow2_f32(-s.d);
  w = ds2{s.w_h * scale, s.w_l * scale};
  float il = static_cast<float>(s.i & 0x7FFF);
  float ih = static_cast<float>(s.i >> 15);
  ds2 step = ds_add(ds_mul_f32(ds_mul_pow2(w, 32768.0f), ih),
                    ds_mul_f32(w, il));
  x0 = ds_add(ds2{s.a_h, s.a_l}, step);
  x1 = ds_add(x0, w);
}

// shared tail of both steps: credit, DFS advance and counters
WS_HD void finish_step(Lane& s, bool testing, bool split, ds2 val,
                       int& i_next, int& d_next, bool& do_split,
                       bool& adv, bool& fin, bool& ovf) {
  do_split = testing && split;
  ovf = do_split && s.d >= MAX_REL_DEPTH;
  do_split = do_split && !ovf;
  bool accept = testing && !split;
  ds2 acc = ds_add(ds2{s.acc_h, s.acc_l},
                   accept ? val : ds2{0.0f, 0.0f});
  s.acc_h = acc.h;
  s.acc_l = acc.l;
  int t = ctz_pos(s.i + 1);
  fin = accept && t >= s.d;
  adv = accept && !fin;
  i_next = do_split ? s.i * 2 : (adv ? (s.i >> t) + 1 : s.i);
  d_next = do_split ? s.d + 1 : (adv ? s.d - t : s.d);
  s.tasks += testing ? 1 : 0;
  s.splits += do_split ? 1 : 0;
  int md = testing ? s.base_d + s.d : 0;
  s.maxd = s.maxd > md ? s.maxd : md;
}

// trapezoid step: one eval per step through the INIT/LOAD cache modes
template <int FAM>
WS_HD void step_trap(Lane& s, float eps32) {
  bool parked = is_parked(s);
  bool mode_load = (s.flags & MODE_LOAD) != 0;
  bool mode_init = (s.flags & MODE_INIT) != 0;
  bool live = !parked;
  ds2 w, x0, x1;
  node_geometry(s, w, x0, x1);
  ds2 mid = ds_add(x0, ds_mul_pow2(w, 0.5f));
  ds2 xq = mode_load ? x1 : mid;
  xq = mode_init ? x0 : xq;
  xq = parked ? ds2{1.0f, 0.0f} : xq;
  ds2 th = {s.th_h, s.th_l};
  ds2 fq = f_ds<FAM>(xq, th);

  ds2 quarter = ds_mul_pow2(w, 0.25f);
  ds2 fl = {s.fl_h, s.fl_l};
  ds2 fr = {s.fr_h, s.fr_l};
  ds2 la = ds_mul(ds_add(fl, fq), quarter);
  ds2 ra = ds_mul(ds_add(fq, fr), quarter);
  ds2 val = ds_add(la, ra);
  ds2 lr = ds_mul(ds_add(fl, fr), ds_mul_pow2(w, 0.5f));
  ds2 err = ds_abs(ds_sub(val, lr));
  bool split = (err.h + err.l) > eps32;
  bool testing = live && !(mode_load || mode_init);

  int i_next, d_next;
  bool do_split, adv, fin, ovf;
  finish_step(s, testing, split, val, i_next, d_next, do_split, adv, fin,
              ovf);
  ds2 new_fl = adv ? fr : fl;
  new_fl = mode_init ? fq : new_fl;
  ds2 new_fr = do_split ? fq : fr;
  new_fr = mode_load ? fq : new_fr;
  int flags = s.flags;
  if (adv) flags |= MODE_LOAD;
  if (mode_load) flags &= ~MODE_LOAD;
  if (mode_init) flags = (flags & ~MODE_INIT) | MODE_LOAD;
  if (fin) flags |= PARKED;
  if (ovf) flags |= PARKED | OVF;
  s.fl_h = new_fl.h; s.fl_l = new_fl.l;
  s.fr_h = new_fr.h; s.fr_l = new_fr.l;
  s.i = i_next;
  s.d = d_next;
  s.flags = flags;
}

// scouting step: float32 test of every live lane, endpoint loads fused
// in, full-ds confirm of every non-decisive decision. Adds this lane's
// useful scout evals and ds confirm evals to the counters.
template <int FAM>
WS_HD void step_scout(Lane& s, float eps32, int& sc_n, int& cf_n) {
  bool parked = is_parked(s);
  bool mode_load = (s.flags & MODE_LOAD) != 0;
  bool mode_init = (s.flags & MODE_INIT) != 0;
  bool live = !parked;
  ds2 w, x0, x1;
  node_geometry(s, w, x0, x1);
  ds2 mid = ds_add(x0, ds_mul_pow2(w, 0.5f));
  ds2 th = {s.th_h, s.th_l};

  bool need_l = live && mode_init;
  bool need_r = live && (mode_init || mode_load);
  float f_m = f_sc<FAM>(parked ? 1.0f : mid.h, th.h);
  float f_l = f_sc<FAM>(need_l ? x0.h : 1.0f, th.h);
  float f_r = f_sc<FAM>(need_r ? x1.h : 1.0f, th.h);
  ds2 fl_eff = mode_init ? ds2{f_l, 0.0f} : ds2{s.fl_h, s.fl_l};
  ds2 fr_eff = need_r ? ds2{f_r, 0.0f} : ds2{s.fr_h, s.fr_l};

  float qw = w.h;
  float la32 = (fl_eff.h + f_m) * (qw * 0.25f);
  float ra32 = (f_m + fr_eff.h) * (qw * 0.25f);
  float lr32 = (fl_eff.h + fr_eff.h) * (qw * 0.5f);
  float err32 = fabsf((la32 + ra32) - lr32);
  float band = K_SCOUT_BAND * (fabsf(la32) + fabsf(ra32) + fabsf(lr32));

  bool testing = live;
  bool decisive = testing && err32 > eps32 + band;
  bool need_conf = testing && !decisive;

  ds2 val = {0.0f, 0.0f};
  bool split_ds = false;
  if (need_conf) {
    // full-ds re-evaluation of the tested node (the scout caches never
    // reach the credit)
    ds2 g0 = f_ds<FAM>(x0, th);
    ds2 gm = f_ds<FAM>(mid, th);
    ds2 g1 = f_ds<FAM>(x1, th);
    ds2 quarter = ds_mul_pow2(w, 0.25f);
    ds2 la = ds_mul(ds_add(g0, gm), quarter);
    ds2 ra = ds_mul(ds_add(gm, g1), quarter);
    val = ds_add(la, ra);
    ds2 lr = ds_mul(ds_add(g0, g1), ds_mul_pow2(w, 0.5f));
    ds2 errd = ds_abs(ds_sub(val, lr));
    split_ds = (errd.h + errd.l) > eps32;
  }
  bool split = need_conf ? split_ds : decisive;

  int i_next, d_next;
  bool do_split, adv, fin, ovf;
  finish_step(s, testing, split, val, i_next, d_next, do_split, adv, fin,
              ovf);
  ds2 new_fl = adv ? fr_eff : fl_eff;
  ds2 new_fr = do_split ? ds2{f_m, 0.0f} : fr_eff;
  int flags = s.flags & ~(MODE_INIT | MODE_LOAD);
  if (adv) flags |= MODE_LOAD;
  if (fin) flags |= PARKED;
  if (ovf) flags |= PARKED | OVF;
  s.fl_h = new_fl.h; s.fl_l = new_fl.l;
  s.fr_h = new_fr.h; s.fr_l = new_fr.l;
  s.i = i_next;
  s.d = d_next;
  s.flags = flags;
  sc_n += (live ? 1 : 0) + (need_l ? 1 : 0) + (need_r ? 1 : 0);
  cf_n += need_conf ? 3 : 0;
}

}  // namespace ws
