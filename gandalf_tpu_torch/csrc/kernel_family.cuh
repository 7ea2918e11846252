// The SPH kernel family for the grad-h grid and tree kernels (K2, K3, K7,
// K8, K9), the meshless finite-volume kernels (K10-K12, K7's MFV mode),
// the Cullen & Dehnen switch (K21), the gas-dust drag (K23, K24) and
// Saitoh & Makino SPH (K25, K26): M4, the quintic spline and the
// gaussian, each evaluated directly or quantised to the reference's
// table, chosen at compile time.
//
// The polynomials are those of gandalf_tpu_torch/kernels/smoothing.py
// (and gandalf_tpu's), written term by term in the same form, with each
// power formed by the products of JAX's integer_pow (s^4 = (s s)(s s),
// s^5 = s s^4, s^6 = s^2 s^4, s^7 = s^3 s^4).  The quintic's middle
// pieces cancel some three digits near s = 2 (w0 ~ 1 from terms of order
// 10^3), so its and the gaussian's arithmetic is rounded step by step
// (__fmul_rn, __fadd_rn and their double forms): no product is fused into
// a sum, and the card's results equal the plain version's wherever their
// inputs do.  M4 keeps the forms of m4.cuh (the kernels' M4 results are
// those of earlier versions, bit for bit).
//
// Kernel<T, FAM, TAB> holds the runtime constants (norm, ndim, the table
// steps) and gives
//   s functions   w0, w1, womega, wzeta, wgrav, wpot, wdrag (as
//                 smoothing.py; wdrag = normdrag s^2 w0(s));
//   s^2 functions w0_s2, womega_s2, wzeta_s2 through density(): the
//                 three density terms at ssqd, false where all vanish;
//                 w0_s2 alone for the meshless finite-volume kernels;
//   support tests in_support(s) and in_support_s2(ssqd): whether the s
//                 and s^2 functions can be non-zero there.
// With TAB a function of s takes the base polynomial at floor(s / step)
// step (step = kernrange / res) inside the support, and the s^2 functions
// at sqrt(floor(ssqd / step2) step2) (step2 = kernrange^2 / res) where
// ssqd < kernrange^2, the cut JAX's w0_s2 takes (s < 3 and s^2 < 9 can
// disagree by an ulp).  The divisions are IEEE: the library is built
// without fast math.  The tabulated gravity kernels take the exact far
// forms 1/max(s^2, 1e-60) and 1/max(s, 1e-30) beyond the support.  The
// gaussian's wzeta, wgrav and wpot are zero (the JAX package's; the
// kernels refuse it with self-gravity, ROADMAP fault F23).
#pragma once

#include <cuda_runtime.h>

#include "m4.cuh"

namespace kf {

enum Family { kM4 = 0, kQuintic = 1, kGaussian = 2 };

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}

// the powers of s as JAX's integer_pow forms them
template <typename T>
struct Powers {
  T s, s2, s3, s4, s5, s6, s7;
  __device__ __forceinline__ explicit Powers(T x) : s(x) {
    s2 = mul(x, x);
    s3 = mul(x, s2);
    s4 = mul(s2, s2);
    s5 = mul(x, s4);
    s6 = mul(s2, s4);
    s7 = mul(s3, s4);
  }
};

// c * x, the product of a literal and a power or of a literal's running
// product with s (Python evaluates 60.0 * s * s as (60 s) s)
template <typename T>
__device__ __forceinline__ T cs2(T c, T s) {
  return mul(mul(c, s), s);
}

// the base kernels' polynomials; `k` carries norm and nd
template <typename T, int FAM>
struct Poly;

template <typename T>
struct Poly<T, kM4> {
  static constexpr double kRange = 2.0;
  template <class K>
  __device__ static T w0(const K& k, T s) { return m4_w0<T>(s, k.norm); }
  template <class K>
  __device__ static T w1(const K& k, T s) { return m4_w1<T>(s, k.norm); }
  template <class K>
  __device__ static T womega(const K& k, T s) {
    return m4_womega<T>(s, k.norm, k.nd);
  }
  template <class K>
  __device__ static T wzeta(const K&, T s) { return m4_wzeta<T>(s); }
  template <class K>
  __device__ static T wgrav(const K&, T s) { return m4_wgrav<T>(s); }
  template <class K>
  __device__ static T wpot(const K&, T s) { return m4_wpot<T>(s); }
};

template <typename T>
struct Poly<T, kQuintic> {
  static constexpr double kRange = 3.0;

  template <class K>
  __device__ static T w0(const K& k, T s) {
    const Powers<T> p(s);
    T v;
    if (s < T(1)) {
      v = sub(add(sub(T(66), cs2(T(60), s)), mul(T(30), p.s4)),
              mul(T(10), p.s5));
    } else if (s < T(2)) {
      v = add(sub(add(sub(add(T(51), mul(T(75), s)), cs2(T(210), s)),
                      mul(T(150), p.s3)),
                  mul(T(45), p.s4)),
              mul(T(5), p.s5));
    } else if (s < T(3)) {
      const T q = sub(T(3), s);
      const T q2 = mul(q, q);
      v = mul(q, mul(q2, q2));
    } else {
      return T(0);
    }
    return mul(k.norm, v);
  }

  template <class K>
  __device__ static T w1(const K& k, T s) {
    const Powers<T> p(s);
    T v;
    if (s < T(1)) {
      v = sub(add(mul(T(-120), s), mul(T(120), p.s3)), mul(T(50), p.s4));
    } else if (s < T(2)) {
      v = add(sub(add(sub(T(75), mul(T(420), s)), cs2(T(450), s)),
                  mul(T(180), p.s3)),
              mul(T(25), p.s4));
    } else if (s < T(3)) {
      v = sub(add(sub(add(T(-405), mul(T(540), s)), cs2(T(270), s)),
                  mul(T(60), p.s3)),
              mul(T(5), p.s4));
    } else {
      return T(0);
    }
    return mul(k.norm, v);
  }

  template <class K>
  __device__ static T womega(const K& k, T s) {
    // every coefficient c (nd + a) is an integer below 1,000: exact in T
    const T nd = k.nd;
    const Powers<T> p(s);
    T v;
    if (s < T(1)) {
      v = add(sub(add(mul(T(-66), nd), cs2(T(60) * (nd + T(2)), s)),
                  mul(T(30) * (nd + T(4)), p.s4)),
              mul(T(10) * (nd + T(5)), p.s5));
    } else if (s < T(2)) {
      v = sub(add(sub(add(sub(mul(T(-51), nd), mul(T(75) * (nd + T(1)), s)),
                          cs2(T(210) * (nd + T(2)), s)),
                      mul(T(150) * (nd + T(3)), p.s3)),
                  mul(T(45) * (nd + T(4)), p.s4)),
              mul(T(5) * (nd + T(5)), p.s5));
    } else if (s < T(3)) {
      v = add(sub(add(sub(add(mul(T(-243), nd), mul(T(405) * (nd + T(1)), s)),
                          cs2(T(270) * (nd + T(2)), s)),
                      mul(T(90) * (nd + T(3)), p.s3)),
                  mul(T(15) * (nd + T(4)), p.s4)),
              mul(nd + T(5), p.s5));
    } else {
      return T(0);
    }
    return mul(k.norm, v);
  }

  template <class K>
  __device__ static T wzeta(const K&, T s) {
    const Powers<T> p(s);
    if (s < T(1))
      return sub(sub(add(sub(cs2(T(33), s), mul(T(15), p.s4)),
                         mul(T(5), p.s6)),
                     mul(T(10.0 / 7.0), p.s7)),
                 T(34.14285714));
    if (s < T(2))
      return sub(add(sub(add(sub(add(cs2(T(25.5), s), mul(T(25), p.s3)),
                                 mul(T(52.5), p.s4)),
                             mul(T(30), p.s5)),
                         mul(T(7.5), p.s6)),
                     mul(T(5.0 / 7.0), p.s7)),
                 T(33.785714286));
    if (s < T(3))
      return sub(sub(add(sub(add(sub(cs2(T(121.5), s), mul(T(135), p.s3)),
                                 mul(T(67.5), p.s4)),
                             mul(T(18), p.s5)),
                         mul(T(2.5), p.s6)),
                     mul(T(1.0 / 7.0), p.s7)),
                 T(52.07142857));
    return T(0);
  }

  template <class K>
  __device__ static T wgrav(const K&, T s) {
    const T s_safe = s > T(1e-30) ? s : T(1e-30);
    const T inv_s2 = T(1) / mul(s_safe, s_safe);
    const T c = T(12.0 / 359.0);
    const Powers<T> p(s);
    if (s < T(1))
      return mul(c, sub(add(sub(mul(T(22), s), mul(T(12), p.s3)),
                            mul(T(30.0 / 7.0), p.s5)),
                        mul(T(1.25), p.s6)));
    if (s < T(2))
      return mul(c, add(add(sub(add(sub(add(mul(T(17), s),
                                            cs2(T(18.75), s)),
                                        mul(T(42), p.s3)),
                                    mul(T(25), p.s4)),
                                mul(T(45.0 / 7.0), p.s5)),
                            mul(T(0.625), p.s6)),
                        mul(T(5.0 / 56.0), inv_s2)));
    if (s < T(3))
      return mul(c, sub(sub(add(sub(add(sub(mul(T(81), s),
                                            mul(T(101.25), p.s2)),
                                        mul(T(54), p.s3)),
                                    mul(T(15), p.s4)),
                                mul(T(15.0 / 7.0), p.s5)),
                            mul(T(0.125), p.s6)),
                        mul(T(507.0 / 56.0), inv_s2)));
    return inv_s2;
  }

  template <class K>
  __device__ static T wpot(const K&, T s) {
    const T s_safe = s > T(1e-30) ? s : T(1e-30);
    const T inv_s = T(1) / s_safe;
    const T c = T(12.0 / 359.0);
    const Powers<T> p(s);
    if (s < T(1))
      return mul(c, add(add(sub(add(cs2(T(-11), s), mul(T(3), p.s4)),
                                mul(T(5.0 / 7.0), p.s6)),
                            mul(T(5.0 / 28.0), p.s7)),
                        T(478.0 / 14.0)));
    if (s < T(2))
      return mul(c, add(add(sub(add(sub(add(sub(cs2(T(-8.5), s),
                                                mul(T(6.25), p.s3)),
                                            mul(T(10.5), p.s4)),
                                        mul(T(5), p.s5)),
                                    mul(T(15.0 / 14.0), p.s6)),
                                mul(T(5.0 / 56.0), p.s7)),
                            T(473.0 / 14.0)),
                        mul(T(5.0 / 56.0), inv_s)));
    if (s < T(3))
      return mul(c, sub(add(add(sub(add(sub(add(cs2(T(-40.5), s),
                                                mul(T(33.75), p.s3)),
                                            mul(T(13.5), p.s4)),
                                        mul(T(3), p.s5)),
                                    mul(T(5.0 / 14.0), p.s6)),
                                mul(T(1.0 / 56.0), p.s7)),
                            T(729.0 / 14.0)),
                        mul(T(507.0 / 56.0), inv_s)));
    return inv_s;
  }
};

template <typename T>
struct Poly<T, kGaussian> {
  static constexpr double kRange = 3.0;

  // e^{-s^2} with -s * s as JAX forms it
  __device__ static T gauss(T s) { return exp(mul(-s, s)); }

  template <class K>
  __device__ static T w0(const K& k, T s) {
    return s < T(3) ? mul(k.norm, gauss(s)) : T(0);
  }
  template <class K>
  __device__ static T w1(const K& k, T s) {
    // -2.0 * norm * s * e: (-2 norm) is one constant in Python
    return s < T(3) ? mul(mul(k.m2norm, s), gauss(s)) : T(0);
  }
  template <class K>
  __device__ static T womega(const K& k, T s) {
    return s < T(3) ? mul(mul(k.norm, sub(cs2(T(2), s), k.nd)), gauss(s))
                    : T(0);
  }
  template <class K>
  __device__ static T wzeta(const K&, T) { return T(0); }
  template <class K>
  __device__ static T wgrav(const K&, T) { return T(0); }
  template <class K>
  __device__ static T wpot(const K&, T) { return T(0); }
};

template <typename T, int FAM, bool TAB>
struct Kernel {
  using P = Poly<T, FAM>;
  static constexpr int kFamily = FAM;
  static constexpr bool kTab = TAB;
  // the callers sum d^2 in the plain version's rounded steps (no fused
  // products) for every kernel but the direct M4, so that s, s^2 and a
  // table index equal the plain version's: the quintic's terms cancel
  // some three digits near s = 2, so an ulp of s would show at ~2e-5 of
  // W' in float32.  M4 keeps its fused sums, as in earlier versions.
  static constexpr bool kExactD2 = TAB || FAM != kM4;
  // normdrag: the drag kernel's normalisation (kernnormdrag), set for
  // K23 and K24 only
  T norm, nd, m2norm, step, step2, normdrag;

  __host__ __device__ static constexpr T range() { return T(P::kRange); }
  __host__ __device__ static constexpr T range2() {
    return T(P::kRange * P::kRange);
  }

  __device__ __forceinline__ T q(T s) const {
    return mul(floor(s / step), step);
  }
  __device__ __forceinline__ T q2(T ssqd) const {
    return sqrt(mul(floor(ssqd / step2), step2));
  }

  __device__ __forceinline__ T w1(T s) const {
    if (TAB) return s < range() ? P::w1(*this, q(s)) : T(0);
    return P::w1(*this, s);
  }
  // the gas-dust drag kernel normdrag s^2 W(s); a table quantises s on
  // the s grid (TabulatedKernel.wdrag), zero from kernrange on
  __device__ __forceinline__ T wdrag(T s) const {
    if (TAB) return s < range() ? drag(q(s)) : T(0);
    return drag(s);
  }
  // the base form: the direct M4's is m4.cuh's m4_wdrag, the others are
  // ((normdrag s) s) W(s) in rounded steps, as Python evaluates it
  __device__ __forceinline__ T drag(T s) const {
    if (FAM == kM4) return m4_wdrag<T>(s, norm, normdrag);
    return mul(mul(mul(normdrag, s), s), P::w0(*this, s));
  }
  __device__ __forceinline__ T wgrav(T s) const {
    if (TAB) {
      if (s < range()) return P::wgrav(*this, q(s));
      const T s2 = mul(s, s);
      return T(1) / (s2 > T(1e-60) ? s2 : T(1e-60));
    }
    return P::wgrav(*this, s);
  }
  __device__ __forceinline__ T wpot(T s) const {
    if (TAB)
      return s < range() ? P::wpot(*this, q(s))
                         : T(1) / (s > T(1e-30) ? s : T(1e-30));
    return P::wpot(*this, s);
  }

  // W at s^2 = ssqd (JAX's w0_s2)
  __device__ __forceinline__ T w0_s2(T ssqd) const {
    if (TAB) return ssqd < range2() ? P::w0(*this, q2(ssqd)) : T(0);
    return P::w0(*this, sqrt(ssqd));
  }
  // whether the functions of s (w1) or of s^2 (w0_s2, density) can be
  // non-zero at a pair: s < kernrange, and for a table s^2 < kernrange^2
  // (sqrt(ssqd) < kernrange otherwise, the test the direct forms make)
  __device__ __forceinline__ bool in_support(T s) const {
    return s < range();
  }
  __device__ __forceinline__ bool in_support_s2(T ssqd) const {
    if (TAB) return ssqd < range2();
    return sqrt(ssqd) < range();
  }

  // the density sums' terms at s^2 = ssqd (w0_s2, womega_s2, wzeta_s2);
  // false where all three vanish (beyond the support)
  __device__ __forceinline__ bool density(T ssqd, T* w0, T* wom,
                                          T* wz) const {
    T s;
    if (TAB) {
      if (!(ssqd < range2())) return false;
      s = q2(ssqd);
    } else {
      s = sqrt(ssqd);
      if (s >= range()) return false;
    }
    *w0 = P::w0(*this, s);
    *wom = P::womega(*this, s);
    *wz = P::wzeta(*this, s);
    return true;
  }
};

// the kernel object of a family on the host: the norm and ndim of the
// smoothing kernel, the drag kernel's norm and, with a table of `res`
// entries, its steps (in double, then cast, as torch and JAX take a
// Python float)
template <class K>
K make_kernel(double norm, int ndim, int res, double normdrag = 0.0) {
  using T = decltype(K::norm);
  const double range = K::P::kRange;
  K k;
  k.norm = T(norm);
  k.nd = T(ndim);
  k.m2norm = T(-2.0 * norm);
  k.step = T(res > 0 ? range / res : 1.0);
  k.step2 = T(res > 0 ? range * range / res : 1.0);
  k.normdrag = T(normdrag);
  return k;
}

// calls f(kernel) with the Kernel<T, FAM, TAB> of family FAM, tabulated
// where res > 0 (a source built for one family: K23, K24)
template <typename T, int FAM, typename F>
bool with_family(int res, double norm, int ndim, F&& f,
                 double normdrag = 0.0) {
  if (res > 0)
    f(make_kernel<Kernel<T, FAM, true>>(norm, ndim, res, normdrag));
  else
    f(make_kernel<Kernel<T, FAM, false>>(norm, ndim, res, normdrag));
  return true;
}

// calls f(kernel) with the Kernel<T, FAM, TAB> of the runtime family and
// table resolution (res 0: evaluated directly); false for an unknown
// family.  The gaussian is left out with kGravity (no softened gravity).
template <typename T, bool kGravity = false, typename F>
bool with_kernel(int family, int res, double norm, int ndim, F&& f) {
  if (family == kM4) return with_family<T, kM4>(res, norm, ndim, f);
  if (family == kQuintic)
    return with_family<T, kQuintic>(res, norm, ndim, f);
  if constexpr (!kGravity) {
    if (family == kGaussian)
      return with_family<T, kGaussian>(res, norm, ndim, f);
  }
  return false;
}

}  // namespace kf
