// Per-lane step machine of the walk segments (K1, K2, K3).
//
// Everything here is __host__ __device__: the CUDA kernels (walk_rf.cu,
// walk_ee.cu, walk_seg.cu) run it with one thread per lane, and
// walk_host.cpp runs the same functions in plain host loops so the CPU
// tests can hold the kernels' own arithmetic bit for bit against the
// plain PyTorch segments (ppls_tpu_torch/parallel/walker.py) before any
// card is involved.
//
// Numerics: double-single (two-float32) arithmetic whose error-free
// transforms die under multiply-add contraction or flush-to-zero. Build
// with nvcc -fmad=false -ftz=false -prec-div=true -prec-sqrt=true (never
// --use_fast_math) and with g++ -ffp-contract=off. Every function below
// performs the float32 operations of its twin in ops/ds_kernel.py,
// ops/scout_kernel.py and models/integrands.py, in the same order, but
// for two_prod, whose one explicit FMA reaches the same bits by another
// exact route (its note).

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
constexpr int MODE_LOADM = 32;        // Simpson: next eval loads f(mid)
constexpr int MODE_TESTB = 64;        // Simpson: q1 stashed, next eval q3
constexpr int MAX_REL_DEPTH = 30;

// step machines (walker.py STEP_*): one template parameter of every kernel
constexpr int STEP_TRAP = 0;
constexpr int STEP_SCOUT = 1;
constexpr int STEP_SIMPSON = 2;
constexpr int DEPTH_BITS = 14;
constexpr int DEPTH_MASK = (1 << DEPTH_BITS) - 1;

// integrand ids (models/integrands.py KERNEL_*), one per ds twin; the
// *_REDUCED ids are the range-reduced twins of the same families
constexpr int FAMILY_SIN_RECIP = 0;          // sin(theta / x)
constexpr int FAMILY_COSH4 = 1;              // cosh(theta x)^4
constexpr int FAMILY_SIN_SCALED = 2;         // sin(theta x)
constexpr int FAMILY_QUAD_SCALED = 3;        // theta x^2
constexpr int FAMILY_GAUSS_CENTER = 4;       // exp(-500000 (x - theta)^2)
constexpr int FAMILY_SIN_RECIP_REDUCED = 5;  // sin(theta / x), ds_sin_pi
constexpr int FAMILY_COSH4_REDUCED = 6;      // ((1 + cosh 2|theta x|) / 2)^2
constexpr int FAMILY_SIN_SCALED_REDUCED = 7; // sin(theta x), ds_sin_pi

// pointer table of one K1 launch (walker.py run_segment_rf order)
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
constexpr int P_SYNC = 41;            // uint64[3], zeroed: the packed
                                      // grid counts (walk_grid.cuh)
constexpr int P_VOTE = 42;            // uint32[3 * lanes / T], zeroed: the
                                      // theta groups' vote words (T > 128)
constexpr int N_PTRS = 43;
// pointer table of one K2 launch (walker.py run_segment_ee): the state,
// then int32[7] counters (steps, eval_active, masked_dead,
// parked_with_root, theta_overwalk, scout evals, confirm evals), a
// uint64[3] zeroed packed-count buffer and the uint32[3 * lanes / T]
// zeroed vote words of theta groups beyond one block (read only when
// T > 128). K3 takes the 26 state pointers only.
constexpr int P_EE_COUNTERS = 26;
constexpr int P_EE_SYNC = 27;
constexpr int P_EE_VOTE = 28;
constexpr int N_EE_PTRS = 29;

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
// pi reduction and the one sin polynomial of ds_sin_pi (S3..S9 are the
// K_S*_H/L limbs above)
constexpr float K_PI_1 = 0x1.921fb6p+1f;
constexpr float K_PI_2 = -0x1.777a5cp-24f;
constexpr float K_PI_3 = -0x1.0p-48f;
constexpr float K_INV_PI = 0x1.45f306p-2f;
constexpr float K_S11P_H = -0x1.ae6456p-26f, K_S11P_L = -0x1.fd5138p-52f;
constexpr float K_S13P_H = 0x1.612462p-33f, K_S13P_L = -0x1.8af25ep-58f;
constexpr float K_S15P = -0x1.ae7f3ep-41f;
constexpr float K_S17P = 0x1.952c78p-49f;
constexpr float K_S19P = -0x1.2f49b4p-57f;
constexpr float K_S21P = 0x1.71b8f0p-66f;
// gauss_center: exp(-0.5 ((x - c) / 1e-3)^2) = exp(-500000 (x - c)^2)
constexpr float K_GAUSS_SCALE = -500000.0f;
// scout (plain float32) polynomial coefficients
constexpr float K_SC_S3 = -0x1.555556p-3f, K_SC_S5 = 0x1.111112p-7f;
constexpr float K_SC_S7 = -0x1.a01a02p-13f, K_SC_S9 = 0x1.71de3ap-19f;
constexpr float K_SC_S11 = -0x1.ae6456p-26f;
constexpr float K_SC_S13 = 0x1.612462p-33f;
constexpr float K_SC_C2 = -0x1.0p-1f, K_SC_C4 = 0x1.555556p-5f;
constexpr float K_SC_C6 = -0x1.6c16c2p-10f, K_SC_C8 = 0x1.a01a02p-16f;
constexpr float K_SC_C10 = -0x1.27e4fcp-22f;
constexpr float K_SC_E2 = 0x1.0p-1f, K_SC_E3 = 0x1.555556p-3f;
constexpr float K_SC_E4 = 0x1.555556p-5f, K_SC_E5 = 0x1.111112p-7f;
constexpr float K_SC_E6 = 0x1.6c16c2p-10f, K_SC_E7 = 0x1.a01a02p-13f;
// scout guard band: 64 float32 ulps, 64 * 2^-23
constexpr float K_SCOUT_BAND = 0x1.0p-17f;
// Simpson + Richardson scalings as two-limb constants (walker.py
// SIMPSON_SIXTH / _TWELFTH / _FIFTEENTH): a float32 literal alone would
// put a systematic 3e-8 relative error on every accepted value
constexpr float K_SIXTH_H = 0x1.555556p-3f, K_SIXTH_L = -0x1.555556p-28f;
constexpr float K_TWELFTH_H = 0x1.555556p-4f,
                K_TWELFTH_L = -0x1.555556p-29f;
constexpr float K_FIFTEENTH_H = 0x1.111112p-4f,
                K_FIFTEENTH_L = -0x1.dddddep-29f;

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

// --- lockstep values ---------------------------------------------------------
//
// fv<N>: N float32 values that one thread carries through the same
// operations in lockstep (the scouting step's three evaluation points).
// Each operator applies its float32 operation to every value in turn, so
// the PTX holds the N operations of one source step side by side: N
// independent chains the scheduler may interleave where one chain alone
// waits out each operation's latency. Every value goes through exactly
// the operations of the scalar code, in the same order, so its result is
// bit-equal to it. The ds arithmetic below is written once for F = float
// and F = fv<N>.
template <int N>
struct fv {
  float v[N];
};
template <int N>
struct iv {
  int v[N];
};
template <int N>
struct bv {
  bool v[N];
};

#define WS_EACH(R, expr)            \
  R r;                              \
  _Pragma("unroll")                 \
  for (int j = 0; j < N; ++j) r.v[j] = (expr); \
  return r;

#define WS_FV_BINARY(op)                                           \
  template <int N>                                                 \
  WS_HD fv<N> operator op(fv<N> a, fv<N> b) {                      \
    WS_EACH(fv<N>, a.v[j] op b.v[j])                               \
  }                                                                \
  template <int N>                                                 \
  WS_HD fv<N> operator op(float a, fv<N> b) {                      \
    WS_EACH(fv<N>, a op b.v[j])                                    \
  }                                                                \
  template <int N>                                                 \
  WS_HD fv<N> operator op(fv<N> a, float b) {                      \
    WS_EACH(fv<N>, a.v[j] op b)                                    \
  }
WS_FV_BINARY(+)
WS_FV_BINARY(-)
WS_FV_BINARY(*)
WS_FV_BINARY(/)
#undef WS_FV_BINARY

template <int N>
WS_HD fv<N> operator-(fv<N> a) { WS_EACH(fv<N>, -a.v[j]) }
template <int N>
WS_HD bv<N> operator<(fv<N> a, float b) { WS_EACH(bv<N>, a.v[j] < b) }
template <int N>
WS_HD iv<N> operator&(iv<N> a, int b) { WS_EACH(iv<N>, a.v[j] & b) }
template <int N>
WS_HD bv<N> operator==(iv<N> a, int b) { WS_EACH(bv<N>, a.v[j] == b) }
template <int N>
WS_HD bv<N> operator>=(iv<N> a, int b) { WS_EACH(bv<N>, a.v[j] >= b) }

// a float constant as an F
template <class F>
struct Splat {
  static WS_HD F of(float x) { return x; }
};
template <int N>
struct Splat<fv<N>> {
  static WS_HD fv<N> of(float x) { WS_EACH(fv<N>, x) }
};

WS_HD float rint_f(float x) { return rintf(x); }
template <int N>
WS_HD fv<N> rint_f(fv<N> x) { WS_EACH(fv<N>, rintf(x.v[j])) }
WS_HD float abs_f(float x) { return fabsf(x); }
template <int N>
WS_HD fv<N> abs_f(fv<N> x) { WS_EACH(fv<N>, fabsf(x.v[j])) }
WS_HD int to_int(float x) { return static_cast<int>(x); }
template <int N>
WS_HD iv<N> to_int(fv<N> x) { WS_EACH(iv<N>, static_cast<int>(x.v[j])) }
template <int N>
WS_HD fv<N> pow2_f32(iv<N> k) { WS_EACH(fv<N>, pow2_f32(k.v[j])) }
template <class T>
WS_HD T sel(bool c, T a, T b) { return c ? a : b; }
template <int N>
WS_HD fv<N> sel(bv<N> c, fv<N> a, fv<N> b) {
  WS_EACH(fv<N>, c.v[j] ? a.v[j] : b.v[j])
}
#undef WS_EACH

// --- double-single arithmetic (ops/ds_kernel.py) -----------------------------

template <class F>
struct dsT {
  F h, l;
};
using ds2 = dsT<float>;

template <class F>
WS_HD dsT<F> dsc(float h, float l) {
  return {Splat<F>::of(h), Splat<F>::of(l)};
}

template <class F>
WS_HD dsT<F> two_sum(F a, F b) {
  F s = a + b;
  F v = s - a;
  F e = (a - (s - v)) + (b - v);
  return {s, e};
}

template <class F>
WS_HD dsT<F> quick_two_sum(F a, F b) {
  F s = a + b;
  F e = b - (s - a);
  return {s, e};
}

template <class F>
WS_HD void dekker_split(F a, F& hi, F& lo) {
  F t = K_SPLIT * a;
  hi = t - (t - a);
  lo = a - hi;
}

// One correctly rounded fused multiply-add: the only contraction in the
// kernels, written out (-fmad=false and -ffp-contract=off forbid any
// other). glibc's fmaf is correctly rounded too.
WS_HD float fma_f(float a, float b, float c) {
#ifdef __CUDA_ARCH__
  return __fmaf_rn(a, b, c);
#else
  return fmaf(a, b, c);
#endif
}
template <int N>
WS_HD fv<N> fma_f(fv<N> a, fv<N> b, fv<N> c) {
  fv<N> r;
#pragma unroll
  for (int j = 0; j < N; ++j) r.v[j] = fma_f(a.v[j], b.v[j], c.v[j]);
  return r;
}

// The error-free product p + e == a * b. The plain segments
// (ops/ds_kernel.two_prod) and the reference use Dekker's split, since
// the TPU's vector unit has no float32 FMA: a split of each operand, four
// products and three adds, about 16 instructions on a critical path about
// 9 deep, and the ds chains call it 18-20 times per sin evaluation. With
// FMA = true the kernels take e = fma(a, b, -p) instead: two instructions,
// two deep. A trapezoid step of sin(theta / x) falls from 787 float32
// operations to 501 and from 248 dependent ones to 202, and K3's step
// (no grid count) from 0.890 to 0.565 us on the H100 80GB HBM3, 700 W
// (tools/time_k1.py --compare, parent and change in one call; PERF.md,
// run 8). At one warp per scheduler the chain, not the operation count,
// is what K1-K3 wait on; the measured step is still about 1.4 times its
// chain at 4 cycles an operation (0.41 us, with each IEEE division
// counted as one operation).
// The FMA's e is the exact a * b - p rounded once, and Dekker's
// is exact, so the two give the same bits wherever Dekker's partial
// products are exact: every product of normal float32 values with |a * b|
// above ~2^-100 and |a|, |b| below ~8.3e34 (where 4097 |a| overflows and
// Dekker gives NaN). Below ~2^-100 e is subnormal and the forms may part.
//
// FMA is a compile-time choice per integrand body (fma_product), never a
// runtime test. gauss_center keeps Dekker: its exp tails give values down
// to 2^-126 with subnormal lo limbs, and a step multiplies them by node
// widths (la = (fl + fq) * w / 4), so its products reach the range where
// the forms part (tests/test_torch_two_prod.py builds such a lane). Every
// other body's products stay above it on every bank the tests and
// chip_smoke.py walk, so those run FMA and stay bit-equal to the plain
// Dekker segments.
template <bool FMA, class F>
WS_HD dsT<F> two_prod(F a, F b) {
  F p = a * b;
  if constexpr (FMA) {
    return {p, fma_f(a, b, -p)};
  } else {
    F ah, al, bh, bl;
    dekker_split(a, ah, al);
    dekker_split(b, bh, bl);
    F e = ((ah * bh - p) + ah * bl + al * bh) + al * bl;
    return {p, e};
  }
}

template <class F>
WS_HD dsT<F> ds_neg(dsT<F> x) { return {-x.h, -x.l}; }

template <class F>
WS_HD dsT<F> ds_add(dsT<F> x, dsT<F> y) {
  dsT<F> s = two_sum(x.h, y.h);
  F e = s.l + (x.l + y.l);
  return quick_two_sum(s.h, e);
}

template <class F>
WS_HD dsT<F> ds_sub(dsT<F> x, dsT<F> y) { return ds_add(x, ds_neg(y)); }

template <class F>
WS_HD dsT<F> ds_add_f32(dsT<F> x, F b) {
  dsT<F> s = two_sum(x.h, b);
  F e = s.l + x.l;
  return quick_two_sum(s.h, e);
}

template <bool FMA, class F>
WS_HD dsT<F> ds_mul(dsT<F> x, dsT<F> y) {
  dsT<F> p = two_prod<FMA>(x.h, y.h);
  F e = p.l + (x.h * y.l + x.l * y.h);
  return quick_two_sum(p.h, e);
}

template <bool FMA, class F>
WS_HD dsT<F> ds_mul_f32(dsT<F> x, F b) {
  dsT<F> p = two_prod<FMA>(x.h, b);
  F e = p.l + x.l * b;
  return quick_two_sum(p.h, e);
}

template <class F>
WS_HD dsT<F> ds_mul_pow2(dsT<F> x, float k) { return {x.h * k, x.l * k}; }

// With F = fv<N>, each IEEE float32 division (-prec-div=true, which ends
// a basic block at its slow-path branch) is followed by the other values'
// divisions, so the work between two division stages stays in one block.
template <bool FMA, class F>
WS_HD dsT<F> ds_div(dsT<F> x, dsT<F> y) {
  F q1 = x.h / y.h;
  dsT<F> p = two_prod<FMA>(q1, y.h);
  dsT<F> r = ds_sub(x, dsT<F>{p.h, p.l + q1 * y.l});
  F q2 = (r.h + r.l) / y.h;
  return quick_two_sum(q1, q2);
}

template <class F, class M>
WS_HD dsT<F> ds_sel(M c, dsT<F> x, dsT<F> y) {
  return {sel(c, x.h, y.h), sel(c, x.l, y.l)};
}

// the sign test on the hi limb, as ops/ds_kernel.ds_abs
template <class F>
WS_HD dsT<F> ds_abs(dsT<F> x) {
  return ds_sel(x.h < 0.0f, ds_neg(x), x);
}

template <bool FMA, class F>
WS_HD dsT<F> sin_poly(dsT<F> y) {
  dsT<F> y2 = ds_mul<FMA>(y, y);
  F tail = K_S11 + y2.h * K_S13;
  dsT<F> p = ds_add(dsc<F>(K_S9_H, K_S9_L), ds_mul_f32<FMA>(y2, tail));
  p = ds_add(dsc<F>(K_S7_H, K_S7_L), ds_mul<FMA>(y2, p));
  p = ds_add(dsc<F>(K_S5_H, K_S5_L), ds_mul<FMA>(y2, p));
  p = ds_add(dsc<F>(K_S3_H, K_S3_L), ds_mul<FMA>(y2, p));
  return ds_add(y, ds_mul<FMA>(ds_mul<FMA>(y, y2), p));
}

template <bool FMA, class F>
WS_HD dsT<F> cos_poly(dsT<F> y) {
  dsT<F> y2 = ds_mul<FMA>(y, y);
  F tail = K_C10 + y2.h * K_C12;
  dsT<F> p = ds_add(dsc<F>(K_C8_H, K_C8_L), ds_mul_f32<FMA>(y2, tail));
  p = ds_add(dsc<F>(K_C6_H, K_C6_L), ds_mul<FMA>(y2, p));
  p = ds_add(dsc<F>(K_C4_H, K_C4_L), ds_mul<FMA>(y2, p));
  p = ds_add(dsc<F>(K_C2_H, K_C2_L), ds_mul<FMA>(y2, p));
  return ds_add(dsc<F>(1.0f, 0.0f), ds_mul<FMA>(y2, p));
}

template <bool FMA, class F>
WS_HD dsT<F> ds_sin(dsT<F> x) {
  F k = rint_f(x.h * K_TWO_OVER_PI);
  dsT<F> t1 = two_prod<FMA>(k, Splat<F>::of(K_PIO2_1));
  F h = x.h - t1.h;  // exact by Sterbenz
  dsT<F> t2 = two_prod<FMA>(k, Splat<F>::of(K_PIO2_2));
  dsT<F> y = {h, Splat<F>::of(0.0f)};
  y = ds_add_f32(y, -t1.l);
  y = ds_add_f32(y, x.l);
  y = ds_add_f32(y, -t2.h);
  y = ds_add_f32(y, -t2.l);
  y = ds_add_f32(y, -(k * K_PIO2_3));
  auto q = to_int(k) & 3;
  dsT<F> sin_y = sin_poly<FMA>(y);
  dsT<F> cos_y = cos_poly<FMA>(y);
  dsT<F> res = ds_sel((q & 1) == 1, cos_y, sin_y);
  return ds_sel(q >= 2, ds_neg(res), res);
}

// sin by pi reduction and one polynomial (ops/ds_kernel.ds_sin_pi): the
// remainder lies in [-pi/2, pi/2], so no cos chain and no quadrant select,
// only the parity sign of k
template <bool FMA, class F>
WS_HD dsT<F> sin_poly_pi(dsT<F> y) {
  dsT<F> y2 = ds_mul<FMA>(y, y);
  F tail = K_S15P + y2.h * (K_S17P + y2.h * (K_S19P + y2.h * K_S21P));
  dsT<F> p = ds_add(dsc<F>(K_S13P_H, K_S13P_L), ds_mul_f32<FMA>(y2, tail));
  p = ds_add(dsc<F>(K_S11P_H, K_S11P_L), ds_mul<FMA>(y2, p));
  p = ds_add(dsc<F>(K_S9_H, K_S9_L), ds_mul<FMA>(y2, p));
  p = ds_add(dsc<F>(K_S7_H, K_S7_L), ds_mul<FMA>(y2, p));
  p = ds_add(dsc<F>(K_S5_H, K_S5_L), ds_mul<FMA>(y2, p));
  p = ds_add(dsc<F>(K_S3_H, K_S3_L), ds_mul<FMA>(y2, p));
  return ds_add(y, ds_mul<FMA>(ds_mul<FMA>(y, y2), p));
}

template <bool FMA, class F>
WS_HD dsT<F> ds_sin_pi(dsT<F> x) {
  F k = rint_f(x.h * K_INV_PI);
  dsT<F> t1 = two_prod<FMA>(k, Splat<F>::of(K_PI_1));
  F h = x.h - t1.h;  // exact by Sterbenz
  dsT<F> t2 = two_prod<FMA>(k, Splat<F>::of(K_PI_2));
  dsT<F> y = {h, Splat<F>::of(0.0f)};
  y = ds_add_f32(y, -t1.l);
  y = ds_add_f32(y, x.l);
  y = ds_add_f32(y, -t2.h);
  y = ds_add_f32(y, -t2.l);
  y = ds_add_f32(y, -(k * K_PI_3));
  dsT<F> res = sin_poly_pi<FMA>(y);
  return ds_sel((to_int(k) & 1) == 1, ds_neg(res), res);
}

template <bool FMA, class F>
WS_HD dsT<F> exp_poly(dsT<F> r) {
  F tail = K_E10 + r.h * (K_E11 + r.h * K_E12);
  dsT<F> p = ds_add(dsc<F>(K_E9_H, K_E9_L), ds_mul_f32<FMA>(r, tail));
  p = ds_add(dsc<F>(K_E8_H, K_E8_L), ds_mul<FMA>(r, p));
  p = ds_add(dsc<F>(K_E7_H, K_E7_L), ds_mul<FMA>(r, p));
  p = ds_add(dsc<F>(K_E6_H, K_E6_L), ds_mul<FMA>(r, p));
  p = ds_add(dsc<F>(K_E5_H, K_E5_L), ds_mul<FMA>(r, p));
  p = ds_add(dsc<F>(K_E4_H, K_E4_L), ds_mul<FMA>(r, p));
  p = ds_add(dsc<F>(K_E3_H, K_E3_L), ds_mul<FMA>(r, p));
  p = ds_add(dsc<F>(0.5f, 0.0f), ds_mul<FMA>(r, p));
  return ds_add(ds_add(dsc<F>(1.0f, 0.0f), r),
                ds_mul<FMA>(ds_mul<FMA>(r, r), p));
}

template <bool FMA, class F>
WS_HD dsT<F> ds_exp(dsT<F> x) {
  F k = rint_f(x.h * K_LOG2E);
  dsT<F> t1 = two_prod<FMA>(k, Splat<F>::of(K_LN2_1));
  F h = x.h - t1.h;  // exact by Sterbenz
  dsT<F> t2 = two_prod<FMA>(k, Splat<F>::of(K_LN2_2));
  dsT<F> y = {h, Splat<F>::of(0.0f)};
  y = ds_add_f32(y, -t1.l);
  y = ds_add_f32(y, x.l);
  y = ds_add_f32(y, -t2.h);
  y = ds_add_f32(y, -t2.l);
  y = ds_add_f32(y, -(k * K_LN2_3));
  dsT<F> e = exp_poly<FMA>(y);
  F s = pow2_f32(to_int(k));
  return {e.h * s, e.l * s};
}

// --- scout arithmetic (ops/scout_kernel.py): plain float32 ------------------

template <bool FMA, class F>
WS_HD F sc_sin(F xv) {
  F k = rint_f(xv * K_TWO_OVER_PI);
  dsT<F> t1 = two_prod<FMA>(k, Splat<F>::of(K_PIO2_1));
  F y = (xv - t1.h) - (t1.l + k * K_PIO2_2);
  F y2 = y * y;
  F sp = K_SC_S9 + y2 * K_SC_S11;
  sp = K_SC_S7 + y2 * sp;
  sp = K_SC_S5 + y2 * sp;
  sp = K_SC_S3 + y2 * sp;
  F sin_y = y + y * y2 * sp;
  F cp = K_SC_C8 + y2 * K_SC_C10;
  cp = K_SC_C6 + y2 * cp;
  cp = K_SC_C4 + y2 * cp;
  cp = K_SC_C2 + y2 * cp;
  F cos_y = 1.0f + y2 * cp;
  auto q = to_int(k) & 3;
  F res = sel((q & 1) == 1, cos_y, sin_y);
  return sel(q >= 2, -res, res);
}

// float32 sin by pi reduction (ops/scout_kernel.ds_sin_pi)
template <bool FMA, class F>
WS_HD F sc_sin_pi(F xv) {
  F k = rint_f(xv * K_INV_PI);
  dsT<F> t1 = two_prod<FMA>(k, Splat<F>::of(K_PI_1));
  F y = (xv - t1.h) - (t1.l + k * K_PI_2);
  F y2 = y * y;
  F p = K_SC_S11 + y2 * K_SC_S13;
  p = K_SC_S9 + y2 * p;
  p = K_SC_S7 + y2 * p;
  p = K_SC_S5 + y2 * p;
  p = K_SC_S3 + y2 * p;
  F res = y + y * y2 * p;
  return sel((to_int(k) & 1) == 1, -res, res);
}

template <bool FMA, class F>
WS_HD F sc_exp(F xv) {
  F k = rint_f(xv * K_LOG2E);
  dsT<F> t1 = two_prod<FMA>(k, Splat<F>::of(K_LN2_1));
  F r = (xv - t1.h) - (t1.l + k * K_LN2_2);
  F p = K_SC_E6 + r * K_SC_E7;
  p = K_SC_E5 + r * p;
  p = K_SC_E4 + r * p;
  p = K_SC_E3 + r * p;
  p = K_SC_E2 + r * p;
  F e = 1.0f + r * (1.0f + r * p);
  F s = pow2_f32(to_int(k));
  return e * s;
}

// --- integrands (models/integrands.py ds twins) ------------------------------
//
// f_ds_of<FAM>(x, th) for F = float is the single evaluation every step
// machine makes. The scouting step's confirm evaluates its three points
// (x0, mid, x1) through f_ds_n<FAM, 3>, in lockstep (fv<3>): one
// evaluation is a dependent chain of several hundred float32 operations,
// and at 16384 lanes a scheduler holds a single warp, so one chain runs
// at its operations' latency. On the H100 build ptxas interleaves the
// three points' divisions and scout evaluations but still lays the three
// ds_sin chains one after another (SASS, PERF.md). The scout twins the
// same way.

// The two-product of each body's step (two_prod's note): FMA but for
// gauss_center, whose products reach the subnormal range.
WS_HD constexpr bool fma_product(int fam) {
  return fam != FAMILY_GAUSS_CENTER;
}

template <int FAM, class F>
WS_HD dsT<F> f_ds_of(dsT<F> x, dsT<F> th) {
  constexpr bool FMA = fma_product(FAM);
  if constexpr (FAM == FAMILY_SIN_SCALED) {  // sin(theta x)
    return ds_sin<FMA>(ds_mul<FMA>(th, x));
  } else if constexpr (FAM == FAMILY_SIN_RECIP) {  // sin(theta / x)
    return ds_sin<FMA>(ds_div<FMA>(th, x));
  } else if constexpr (FAM == FAMILY_COSH4) {  // cosh(theta x)^4
    dsT<F> u = ds_mul<FMA>(th, x);
    dsT<F> e = ds_exp<FMA>(u);
    dsT<F> inv = ds_div<FMA>(dsc<F>(1.0f, 0.0f), e);
    dsT<F> c = ds_mul_pow2(ds_add(e, inv), 0.5f);
    dsT<F> c2 = ds_mul<FMA>(c, c);
    return ds_mul<FMA>(c2, c2);
  } else if constexpr (FAM == FAMILY_QUAD_SCALED) {  // theta x^2
    return ds_mul<FMA>(th, ds_mul<FMA>(x, x));
  } else if constexpr (FAM == FAMILY_GAUSS_CENTER) {  // theta: the centre
    dsT<F> d = ds_sub(x, th);
    return ds_exp<FMA>(
        ds_mul_f32<FMA>(ds_mul<FMA>(d, d), Splat<F>::of(K_GAUSS_SCALE)));
  } else if constexpr (FAM == FAMILY_SIN_RECIP_REDUCED) {
    return ds_sin_pi<FMA>(ds_div<FMA>(th, x));
  } else if constexpr (FAM == FAMILY_SIN_SCALED_REDUCED) {
    return ds_sin_pi<FMA>(ds_mul<FMA>(th, x));
  } else {  // ((1 + cosh 2|u|) / 2)^2 with one exp of 2|u|
    static_assert(FAM == FAMILY_COSH4_REDUCED, "unknown integrand family");
    dsT<F> u = ds_mul<FMA>(th, x);
    dsT<F> e2 = ds_exp<FMA>(ds_mul_pow2(ds_abs(u), 2.0f));
    dsT<F> one = dsc<F>(1.0f, 0.0f);
    dsT<F> inv = ds_div<FMA>(one, e2);
    dsT<F> c2u = ds_mul_pow2(ds_add(e2, inv), 0.5f);
    dsT<F> half = ds_mul_pow2(ds_add(one, c2u), 0.5f);
    return ds_mul<FMA>(half, half);
  }
}

// scout twins: only the hi limbs matter (the lo limbs are +0.0)
template <int FAM, class F>
WS_HD F f_sc_of(F x, F th) {
  constexpr bool FMA = fma_product(FAM);
  if constexpr (FAM == FAMILY_SIN_SCALED) {
    return sc_sin<FMA>(th * x);
  } else if constexpr (FAM == FAMILY_SIN_RECIP) {
    return sc_sin<FMA>(th / x);
  } else if constexpr (FAM == FAMILY_COSH4) {
    F u = th * x;
    F e = sc_exp<FMA>(u);
    F inv = 1.0f / e;
    F c = (e + inv) * 0.5f;
    F c2 = c * c;
    return c2 * c2;
  } else if constexpr (FAM == FAMILY_QUAD_SCALED) {
    return th * (x * x);
  } else if constexpr (FAM == FAMILY_GAUSS_CENTER) {
    F d = x - th;
    return sc_exp<FMA>((d * d) * K_GAUSS_SCALE);
  } else if constexpr (FAM == FAMILY_SIN_RECIP_REDUCED) {
    return sc_sin_pi<FMA>(th / x);
  } else if constexpr (FAM == FAMILY_SIN_SCALED_REDUCED) {
    return sc_sin_pi<FMA>(th * x);
  } else {
    static_assert(FAM == FAMILY_COSH4_REDUCED, "unknown integrand family");
    F u = th * x;
    F e2 = sc_exp<FMA>(abs_f(u) * 2.0f);
    F inv = 1.0f / e2;
    F c2u = (e2 + inv) * 0.5f;
    F half = (1.0f + c2u) * 0.5f;
    return half * half;
  }
}

template <int FAM>
WS_HD ds2 f_ds(ds2 x, ds2 th) {
  return f_ds_of<FAM, float>(x, th);
}

template <int FAM>
WS_HD float f_sc(float x, float th) {
  return f_sc_of<FAM, float>(x, th);
}

// the integrand at N points of one theta, in lockstep
template <int FAM, int N>
WS_HD void f_ds_n(const ds2 (&x)[N], ds2 th, ds2 (&g)[N]) {
  dsT<fv<N>> xs, ths;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    xs.h.v[j] = x[j].h;
    xs.l.v[j] = x[j].l;
    ths.h.v[j] = th.h;
    ths.l.v[j] = th.l;
  }
  dsT<fv<N>> r = f_ds_of<FAM>(xs, ths);
#pragma unroll
  for (int j = 0; j < N; ++j) g[j] = ds2{r.h.v[j], r.l.v[j]};
}

template <int FAM, int N>
WS_HD void f_sc_n(const float (&x)[N], float th, float (&g)[N]) {
  fv<N> xs, ths;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    xs.v[j] = x[j];
    ths.v[j] = th;
  }
  fv<N> r = f_sc_of<FAM>(xs, ths);
#pragma unroll
  for (int j = 0; j < N; ++j) g[j] = r.v[j];
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

// Theta mode (theta_block = T > 1): the T adjacent lanes of a group walk
// one node sequence together, each with its own theta. A lane whose own
// test accepted a node its group split carries an accept marker (mk_i,
// mk_d) and is retired while the group's node is a descendant of it:
// DFS node indexes at any depth only grow in visit order, so a stale
// marker never matches a later subtree (walker.py _theta_retired).
WS_HD bool theta_retired(const Lane& s) {
  int dd = s.d - s.mk_d;
  int sh = dd < 0 ? 0 : (dd > 31 ? 31 : dd);
  return s.mk_d >= 0 && dd >= 0 && (s.i >> sh) == s.mk_i;
}

// lane-waste classification of the state a step evaluates; in theta mode
// a live but retired lane's step is theta_overwalk, not eval_active
struct Waste {
  int active, dead, stall, tail, over;
};

template <bool THETA>
WS_HD void lane_classify(const Lane& s, int slot, int nslots, Waste& w) {
  int live = !is_parked(s);
  int stall = takeable(s, slot, nslots);
  int dead = ((s.flags & NO_ROOT) != 0) && !stall;
  int over = THETA && live && theta_retired(s);
  w.active += live - over;
  w.over += over;
  w.stall += stall;
  w.dead += dead;
  w.tail += 1 - live - stall - dead;
}

// K2's per-lane waste classification: live -> eval_active, no root ->
// masked_dead, otherwise parked with a root (the host splits that bucket
// into refill_stall or drain_tail by the queue at launch); in theta mode
// a live but retired lane's step is theta_overwalk, not eval_active
// (walker.py kernel_ee's over_n)
struct WasteEE {
  int active, dead, parked_root, over;
};

template <bool THETA = false>
WS_HD void lane_classify_ee(const Lane& s, WasteEE& w) {
  int live = !is_parked(s);
  int dead = (s.flags & NO_ROOT) != 0;
  int over = THETA && live && theta_retired(s);
  w.active += live - over;
  w.over += over;
  w.dead += dead;
  w.parked_root += 1 - live - dead;
}

// --- geometry and steps (walker.py _node_geometry / step / step_scout) ------
//
// The trapezoid and Simpson steps are composed of their point
// (trap_point, simpson_point), the integrand there, their test
// (trap_test, simpson_test) and their commit, so that
// tools/k3_split.cu can time a step's parts apart and try other orders
// of them.

WS_HD ds2 node_width(const Lane& s) {
  float scale = pow2_f32(-s.d);
  return ds2{s.w_h * scale, s.w_l * scale};
}

template <bool FMA>
WS_HD void node_geometry(const Lane& s, ds2& w, ds2& x0, ds2& x1) {
  w = node_width(s);
  float il = static_cast<float>(s.i & 0x7FFF);
  float ih = static_cast<float>(s.i >> 15);
  ds2 step = ds_add(ds_mul_f32<FMA>(ds_mul_pow2(w, 32768.0f), ih),
                    ds_mul_f32<FMA>(w, il));
  x0 = ds_add(ds2{s.a_h, s.a_l}, step);
  x1 = ds_add(x0, w);
}

// Shared tail of every step: credit, DFS advance, counters. `split` is
// the lane's own decision. Outside theta mode the lane splits on it, and
// a split past MAX_REL_DEPTH parks the lane as OVF. In theta mode the
// group splits on `group_split` (any unretired lane's vote), a split past
// the cap is accepted by the whole group instead, a lane credits its own
// value where its own test passed (or at the cap), and a lane that
// credits while its group splits sets its accept marker.
template <bool THETA>
WS_HD void finish_step(Lane& s, bool testing, bool test_act, bool split,
                       bool group_split, ds2 val, int& i_next, int& d_next,
                       bool& do_split, bool& adv, bool& fin, bool& ovf) {
  bool accept, credit;
  if (THETA) {
    do_split = testing && group_split;
    bool ovf_force = do_split && s.d >= MAX_REL_DEPTH;
    do_split = do_split && !ovf_force;
    ovf = false;
    accept = testing && !do_split;
    credit = test_act && (!split || ovf_force);
  } else {
    do_split = testing && split;
    ovf = do_split && s.d >= MAX_REL_DEPTH;
    do_split = do_split && !ovf;
    accept = testing && !split;
    credit = accept;
  }
  ds2 acc = ds_add(ds2{s.acc_h, s.acc_l},
                   credit ? val : ds2{0.0f, 0.0f});
  s.acc_h = acc.h;
  s.acc_l = acc.l;
  int t = ctz_pos(s.i + 1);
  fin = accept && t >= s.d;
  adv = accept && !fin;
  i_next = do_split ? s.i * 2 : (adv ? (s.i >> t) + 1 : s.i);
  d_next = do_split ? s.d + 1 : (adv ? s.d - t : s.d);
  s.tasks += (THETA ? test_act : testing) ? 1 : 0;
  s.splits += ((THETA ? test_act && split : true) && do_split) ? 1 : 0;
  int md = testing ? s.base_d + s.d : 0;
  s.maxd = s.maxd > md ? s.maxd : md;
  if (THETA && do_split && credit) {
    s.mk_i = s.i;
    s.mk_d = s.d;
  }
}

// A trapezoid or scouting step up to its split decision: what the commit
// needs. Theta mode reduces `vote` over the lane's group in between.
struct Eval {
  ds2 val;               // the node's value, the credit candidate
  ds2 fl, fr;            // the endpoint caches the test used
  ds2 fq;                // trapezoid: this step's eval; scout: f32 f(mid)
  bool testing;          // the lane tests its node this step
  bool test_act;         // ... and is not retired (theta mode)
  bool split;            // the lane's own decision
  bool vote;             // test_act && split
  bool mode_load, mode_init;
};

// the point a trapezoid step evaluates: its node's left end (INIT), right
// end (LOAD) or midpoint (a test); 1 for a parked lane
template <bool FMA>
WS_HD ds2 trap_point(const Lane& s) {
  ds2 w, x0, x1;
  node_geometry<FMA>(s, w, x0, x1);
  ds2 mid = ds_add(x0, ds_mul_pow2(w, 0.5f));
  ds2 xq = (s.flags & MODE_LOAD) != 0 ? x1 : mid;
  xq = (s.flags & MODE_INIT) != 0 ? x0 : xq;
  return is_parked(s) ? ds2{1.0f, 0.0f} : xq;
}

// what a trapezoid step does besides its evaluation: its mode, and
// whether the lane tests its node
template <bool THETA>
WS_HD Eval trap_modes(const Lane& s) {
  Eval e{};
  e.mode_load = (s.flags & MODE_LOAD) != 0;
  e.mode_init = (s.flags & MODE_INIT) != 0;
  e.testing = !is_parked(s) && !(e.mode_load || e.mode_init);
  e.test_act = e.testing && !(THETA && theta_retired(s));
  return e;
}

// trapezoid step, the test with the step's evaluation fq
template <bool FMA, bool THETA>
WS_HD Eval trap_test(const Lane& s, ds2 fq, float eps32) {
  Eval e = trap_modes<THETA>(s);
  ds2 w = node_width(s);
  e.fq = fq;
  ds2 quarter = ds_mul_pow2(w, 0.25f);
  e.fl = ds2{s.fl_h, s.fl_l};
  e.fr = ds2{s.fr_h, s.fr_l};
  ds2 la = ds_mul<FMA>(ds_add(e.fl, e.fq), quarter);
  ds2 ra = ds_mul<FMA>(ds_add(e.fq, e.fr), quarter);
  e.val = ds_add(la, ra);
  ds2 lr = ds_mul<FMA>(ds_add(e.fl, e.fr), ds_mul_pow2(w, 0.5f));
  ds2 err = ds_abs(ds_sub(e.val, lr));
  e.split = (err.h + err.l) > eps32;
  e.vote = e.test_act && e.split;
  return e;
}

// trapezoid step, evaluation half: one eval per step through the
// INIT/LOAD cache modes
template <int FAM, bool THETA>
WS_HD Eval eval_trap(const Lane& s, float eps32) {
  constexpr bool FMA = fma_product(FAM);
  ds2 fq = f_ds<FAM>(trap_point<FMA>(s), ds2{s.th_h, s.th_l});
  return trap_test<FMA, THETA>(s, fq, eps32);
}

// scouting step, evaluation half: float32 test of every live lane,
// endpoint loads fused in, full-ds confirm of every non-decisive
// decision (in theta mode: of every unretired lane's non-decisive or
// depth-capped decision, so a forced accept has a ds value to credit).
// Adds this lane's useful scout evals and ds confirm evals to the
// counters.
template <int FAM, bool THETA>
WS_HD Eval eval_scout(const Lane& s, float eps32, int& sc_n, int& cf_n) {
  constexpr bool FMA = fma_product(FAM);
  Eval e;
  bool parked = is_parked(s);
  bool mode_load = (s.flags & MODE_LOAD) != 0;
  bool mode_init = (s.flags & MODE_INIT) != 0;
  bool live = !parked;
  ds2 w, x0, x1;
  node_geometry<FMA>(s, w, x0, x1);
  ds2 mid = ds_add(x0, ds_mul_pow2(w, 0.5f));
  ds2 th = {s.th_h, s.th_l};

  bool need_l = live && mode_init;
  bool need_r = live && (mode_init || mode_load);
  const float xs[3] = {parked ? 1.0f : mid.h, need_l ? x0.h : 1.0f,
                       need_r ? x1.h : 1.0f};
  float fs[3];
  f_sc_n<FAM, 3>(xs, th.h, fs);
  float f_m = fs[0], f_l = fs[1], f_r = fs[2];
  e.fl = mode_init ? ds2{f_l, 0.0f} : ds2{s.fl_h, s.fl_l};
  e.fr = need_r ? ds2{f_r, 0.0f} : ds2{s.fr_h, s.fr_l};
  e.fq = ds2{f_m, 0.0f};

  float qw = w.h;
  float la32 = (e.fl.h + f_m) * (qw * 0.25f);
  float ra32 = (f_m + e.fr.h) * (qw * 0.25f);
  float lr32 = (e.fl.h + e.fr.h) * (qw * 0.5f);
  float err32 = fabsf((la32 + ra32) - lr32);
  float band = K_SCOUT_BAND * (fabsf(la32) + fabsf(ra32) + fabsf(lr32));

  e.testing = live;
  bool decisive = e.testing && err32 > eps32 + band;
  e.test_act = e.testing && !(THETA && theta_retired(s));
  bool need_conf =
      e.test_act && (!decisive || (THETA && s.d >= MAX_REL_DEPTH));

  e.val = ds2{0.0f, 0.0f};
  bool split_ds = false;
  if (need_conf) {
    // full-ds re-evaluation of the tested node (the scout caches never
    // reach the credit), its three points side by side
    const ds2 xd[3] = {x0, mid, x1};
    ds2 gd[3];
    f_ds_n<FAM, 3>(xd, th, gd);
    ds2 g0 = gd[0], gm = gd[1], g1 = gd[2];
    ds2 quarter = ds_mul_pow2(w, 0.25f);
    ds2 la = ds_mul<FMA>(ds_add(g0, gm), quarter);
    ds2 ra = ds_mul<FMA>(ds_add(gm, g1), quarter);
    e.val = ds_add(la, ra);
    ds2 lr = ds_mul<FMA>(ds_add(g0, g1), ds_mul_pow2(w, 0.5f));
    ds2 errd = ds_abs(ds_sub(e.val, lr));
    split_ds = (errd.h + errd.l) > eps32;
  }
  e.split = need_conf ? split_ds : decisive;
  e.vote = e.test_act && e.split;
  e.mode_load = mode_load;
  e.mode_init = mode_init;
  sc_n += (live ? 1 : 0) + (need_l ? 1 : 0) + (need_r ? 1 : 0);
  cf_n += need_conf ? 3 : 0;
  return e;
}

// the evaluation half of a trapezoid or scouting step
template <int FAM, int MODE, bool THETA>
WS_HD Eval evaluate(const Lane& s, float eps32, int& sc_n, int& cf_n) {
  static_assert(MODE != STEP_SIMPSON, "Simpson has no split step");
  if (MODE == STEP_SCOUT) return eval_scout<FAM, THETA>(s, eps32, sc_n, cf_n);
  return eval_trap<FAM, THETA>(s, eps32);
}

// The commit half: the step's decision (the lane's own, or its group's
// in theta mode), then the caches and the mode flags.
template <int MODE, bool THETA>
WS_HD void commit(Lane& s, const Eval& e, bool group_split) {
  int i_next, d_next;
  bool do_split, adv, fin, ovf;
  finish_step<THETA>(s, e.testing, e.test_act, e.split, group_split, e.val,
                     i_next, d_next, do_split, adv, fin, ovf);
  ds2 new_fl, new_fr;
  int flags = s.flags;
  if (MODE == STEP_SCOUT) {
    // the scout caches hold f32 values; a split hands f(mid) to the
    // right end, an advance reloads the right end inline next step
    new_fl = adv ? e.fr : e.fl;
    new_fr = do_split ? e.fq : e.fr;
    flags &= ~(MODE_INIT | MODE_LOAD);
    if (adv) flags |= MODE_LOAD;
  } else {
    new_fl = adv ? e.fr : e.fl;
    new_fl = e.mode_init ? e.fq : new_fl;
    new_fr = do_split ? e.fq : e.fr;
    new_fr = e.mode_load ? e.fq : new_fr;
    if (adv) flags |= MODE_LOAD;
    if (e.mode_load) flags &= ~MODE_LOAD;
    if (e.mode_init) flags = (flags & ~MODE_INIT) | MODE_LOAD;
  }
  if (fin) flags |= PARKED;
  if (ovf) flags |= PARKED | OVF;
  s.fl_h = new_fl.h; s.fl_l = new_fl.l;
  s.fr_h = new_fr.h; s.fr_l = new_fr.l;
  s.i = i_next;
  s.d = d_next;
  s.flags = flags;
}

// the point a Simpson step evaluates: its node's left end (INIT),
// midpoint (LOADM), right end (LOAD), q1 (TESTA) or q3 (TESTB); 1 for a
// parked lane
template <bool FMA>
WS_HD ds2 simpson_point(const Lane& s) {
  ds2 w, x0, x1;
  node_geometry<FMA>(s, w, x0, x1);
  ds2 mid = ds_add(x0, ds_mul_pow2(w, 0.5f));
  ds2 q1 = ds_add(x0, ds_mul_pow2(w, 0.25f));
  ds2 q3 = ds_add(mid, ds_mul_pow2(w, 0.25f));
  ds2 xq = (s.flags & MODE_TESTB) != 0 ? q3 : q1;
  xq = (s.flags & MODE_LOADM) != 0 ? mid : xq;
  xq = (s.flags & MODE_LOAD) != 0 ? x1 : xq;
  xq = (s.flags & MODE_INIT) != 0 ? x0 : xq;
  return is_parked(s) ? ds2{1.0f, 0.0f} : xq;
}

// the Simpson + Richardson value of the lane's node and its split
// decision, with the step's evaluation fq (f(q3) when it decides)
struct SimpsonTest {
  ds2 val;
  bool split;
};

template <bool FMA>
WS_HD SimpsonTest simpson_test(const Lane& s, ds2 fq, float eps32) {
  ds2 w = node_width(s);
  ds2 fl = {s.fl_h, s.fl_l};
  ds2 fr = {s.fr_h, s.fr_l};
  ds2 fm = {s.fm_h, s.fm_l};
  ds2 fq1 = {s.fq_h, s.fq_l};
  ds2 four_fm = ds_mul_pow2(fm, 4.0f);
  ds2 s1 = ds_mul<FMA>(ds_mul<FMA>(w, ds2{K_SIXTH_H, K_SIXTH_L}),
                  ds_add(ds_add(fl, four_fm), fr));
  ds2 inner = ds_add(ds_add(fl, fr),
                     ds_add(ds_mul_pow2(ds_add(fq1, fq), 4.0f),
                            ds_mul_pow2(fm, 2.0f)));
  ds2 s2 =
      ds_mul<FMA>(ds_mul<FMA>(w, ds2{K_TWELFTH_H, K_TWELFTH_L}), inner);
  ds2 diff = ds_sub(s2, s1);
  ds2 corr = ds_mul<FMA>(diff, ds2{K_FIFTEENTH_H, K_FIFTEENTH_L});
  ds2 err = ds_abs(corr);
  return {ds_add(s2, corr), (err.h + err.l) > eps32};
}

// the Simpson step's commit: the decision `split` (the test's, taken
// only in TESTB), the credit val, then the caches and the mode chain
WS_HD void simpson_commit(Lane& s, ds2 fq, ds2 val, bool split) {
  bool live = !is_parked(s);
  bool mode_load = (s.flags & MODE_LOAD) != 0;
  bool mode_init = (s.flags & MODE_INIT) != 0;
  bool mode_loadm = (s.flags & MODE_LOADM) != 0;
  bool mode_testb = (s.flags & MODE_TESTB) != 0;
  bool testa = live && !(mode_load || mode_init || mode_loadm || mode_testb);
  bool testing = live && mode_testb;
  ds2 fl = {s.fl_h, s.fl_l};
  ds2 fr = {s.fr_h, s.fr_l};
  ds2 fm = {s.fm_h, s.fm_l};
  ds2 fq1 = {s.fq_h, s.fq_l};

  int i_next, d_next;
  bool do_split, adv, fin, ovf;
  finish_step<false>(s, testing, testing, split, split, val, i_next, d_next,
                     do_split, adv, fin, ovf);
  // caches: a split hands the left child (fl, fq1, fm); an advance
  // shifts fr to fl and reloads mid and right
  ds2 new_fl = adv ? fr : fl;
  new_fl = mode_init ? fq : new_fl;
  ds2 new_fm = do_split ? fq1 : fm;
  new_fm = mode_loadm ? fq : new_fm;
  ds2 new_fr = do_split ? fm : fr;
  new_fr = mode_load ? fq : new_fr;
  ds2 new_fq = testa ? fq : fq1;
  int flags = s.flags;
  if (mode_init) flags = (flags & ~MODE_INIT) | MODE_LOADM;
  if (mode_loadm) flags = (flags & ~MODE_LOADM) | MODE_LOAD;
  if (mode_load) flags &= ~MODE_LOAD;
  if (testa) flags |= MODE_TESTB;
  if (do_split) flags &= ~MODE_TESTB;
  if (adv) flags = (flags & ~MODE_TESTB) | MODE_LOADM;
  if (fin) flags = (flags & ~MODE_TESTB) | PARKED;
  if (ovf) flags = (flags & ~MODE_TESTB) | (PARKED | OVF);
  s.fl_h = new_fl.h; s.fl_l = new_fl.l;
  s.fm_h = new_fm.h; s.fm_l = new_fm.l;
  s.fr_h = new_fr.h; s.fr_l = new_fr.l;
  s.fq_h = new_fq.h; s.fq_l = new_fq.l;
  s.i = i_next;
  s.d = d_next;
  s.flags = flags;
}

// Simpson + Richardson step: one eval per step through the 5-phase mode
// chain INIT (f(left)) -> LOADM (f(mid)) -> LOAD (f(right)) -> TESTA
// (f(q1), stashed in fq) -> TESTB (f(q3), decide)
template <int FAM>
WS_HD void step_simpson(Lane& s, float eps32) {
  constexpr bool FMA = fma_product(FAM);
  ds2 fq = f_ds<FAM>(simpson_point<FMA>(s), ds2{s.th_h, s.th_l});
  SimpsonTest t = simpson_test<FMA>(s, fq, eps32);
  simpson_commit(s, fq, t.val, t.split);
}

// one step of step machine MODE outside theta mode; scout mode adds to
// the eval counters
template <int FAM, int MODE>
WS_HD void step(Lane& s, float eps32, int& sc_n, int& cf_n) {
  if constexpr (MODE == STEP_SIMPSON) {
    step_simpson<FAM>(s, eps32);
  } else {
    Eval e = evaluate<FAM, MODE, false>(s, eps32, sc_n, cf_n);
    commit<MODE, false>(s, e, e.split);
  }
}

// The one map from a runtime (family, step machine) pair to its template
// variant: returns fn.template operator()<FAM, MODE>(), or `unknown` when
// either id is not known. The kernels use it to pick their launch
// pointer, the host loops to pick their loop.
template <int FAM, typename R, typename Fn>
inline R dispatch_mode(int mode, Fn fn, R unknown) {
  if (mode == STEP_TRAP) return fn.template operator()<FAM, STEP_TRAP>();
  if (mode == STEP_SCOUT) return fn.template operator()<FAM, STEP_SCOUT>();
  if (mode == STEP_SIMPSON) return fn.template operator()<FAM, STEP_SIMPSON>();
  return unknown;
}

template <typename R, typename Fn>
inline R dispatch(int family, int mode, Fn fn, R unknown) {
  if (family == FAMILY_SIN_RECIP)
    return dispatch_mode<FAMILY_SIN_RECIP>(mode, fn, unknown);
  if (family == FAMILY_COSH4)
    return dispatch_mode<FAMILY_COSH4>(mode, fn, unknown);
  if (family == FAMILY_SIN_SCALED)
    return dispatch_mode<FAMILY_SIN_SCALED>(mode, fn, unknown);
  if (family == FAMILY_QUAD_SCALED)
    return dispatch_mode<FAMILY_QUAD_SCALED>(mode, fn, unknown);
  if (family == FAMILY_GAUSS_CENTER)
    return dispatch_mode<FAMILY_GAUSS_CENTER>(mode, fn, unknown);
  if (family == FAMILY_SIN_RECIP_REDUCED)
    return dispatch_mode<FAMILY_SIN_RECIP_REDUCED>(mode, fn, unknown);
  if (family == FAMILY_COSH4_REDUCED)
    return dispatch_mode<FAMILY_COSH4_REDUCED>(mode, fn, unknown);
  if (family == FAMILY_SIN_SCALED_REDUCED)
    return dispatch_mode<FAMILY_SIN_SCALED_REDUCED>(mode, fn, unknown);
  return unknown;
}

}  // namespace ws
