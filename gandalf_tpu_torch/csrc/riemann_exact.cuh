// The exact Riemann solver of K12's exact mode (Toro 1999, ch. 4):
// gandalf_tpu/ops/mfv.py:exact_flux (:509) with exact_star_region (:424),
// _pressure_fn (:407) and _sample_zero (:466), for one face.
//
// The JAX functions are branchless: they evaluate the shock and the
// rarefaction form of each pressure function, and both sides and every
// wave form of the sample at x/t = 0, then select.  Here each value is
// computed on the branch that selects it, in the same order of
// operations, with the same pow calls (one per side per Newton step,
// p^g1; ptl^(1/g1); ratio^gm, ratio^(1/gamma); (cfan/ck)^(2/(gamma-1))
// and ^(2 gamma/(gamma-1))): the values agree to rounding.  Newton takes
// exactly kNewtonSteps steps with no convergence test, as the JAX
// lax.scan of length 10.  A vacuum (2/(gamma-1)(cl + cr) <= ur - ul)
// gives p* = 0 and a zero flux.
//
// The one-dimensional problem (the star region and the sample at x/t =
// 0, with their eleven pow calls) is one __noinline__ function of the
// scalar states, in registers: a source of K12 instantiates 24 kernels
// with up to three solves each, and inlining the solver into every one
// made the exact sources the longest part of the build.  Its arithmetic
// is the same; only the call is new (python -m
// gandalf_tpu_torch.time_mfv_exact times both forms).
#pragma once

#include "mfv.cuh"

namespace mfv {

constexpr int kNewtonSteps = 10;

// the gamma-only constants, formed in double as the JAX package's Python
// floats are, then cast
template <typename T>
struct ExactConsts {
  T gamma, gm1, gp1, g1, inv_g1, g6, gp, g7, two_gp1, two_gm1, pfan_exp,
      inv_gamma, half_gm1;
};

template <typename T>
ExactConsts<T> exact_consts(double gamma) {
  return {T(gamma),
          T(gamma - 1.0),
          T(gamma + 1.0),
          T((gamma - 1.0) / (2.0 * gamma)),
          T(1.0 / ((gamma - 1.0) / (2.0 * gamma))),
          T((gamma - 1.0) / (gamma + 1.0)),
          T((gamma + 1.0) / (2.0 * gamma)),
          T(0.5 * (gamma - 1.0)),
          T(2.0 / (gamma + 1.0)),
          T(2.0 / (gamma - 1.0)),
          T(2.0 * gamma / (gamma - 1.0)),
          T(1.0 / gamma),
          T(0.5 * (gamma - 1.0))};
}

// f_K(p) and f_K'(p) (ExactRiemannSolver::Prefun)
template <typename T>
__device__ __forceinline__ void pressure_fn(T p, T pk, T dk, T ck,
                                            const ExactConsts<T>& c, T* f,
                                            T* fd) {
  if (p > pk) {
    const T ak = T(2) / (c.gp1 * dk);
    const T bk = c.g6 * pk;
    const T sq = sqrt(ak / (p + bk));
    *f = (p - pk) * sq;
    *fd = sq * (T(1) - T(0.5) * (p - pk) / (p + bk));
  } else {
    const T pr = max(p / pk, T(1e-30));
    const T q = pow(pr, c.g1);
    *f = T(2) * ck / c.gm1 * (q - T(1));
    *fd = q / (pr * dk * ck);
  }
}

// (p*, u*) from Toro's adaptive guess and kNewtonSteps Newton steps
template <typename T>
__device__ __forceinline__ void star_region(T dl, T ul, T pl, T cl, T dr,
                                            T ur, T pr, T cr,
                                            const ExactConsts<T>& c,
                                            T* pstar, T* ustar) {
  if (c.two_gm1 * (cl + cr) <= ur - ul) {  // vacuum
    *pstar = T(0);
    *ustar = T(0);
    return;
  }
  const T cup = T(0.25) * (dl + dr) * (cl + cr);
  const T ppv = max(T(0.5) * (pl + pr) + T(0.5) * (ul - ur) * cup, T(0));
  const T pmin = min(pl, pr);
  const T pmax = max(pl, pr);
  T p0;
  if (pmax / pmin <= T(2) && pmin <= ppv && ppv <= pmax) {
    p0 = ppv;
  } else if (ppv < pmin) {  // two rarefactions
    const T pq = pow(max(pl / pr, T(1e-30)), c.g1);
    const T um = (pq * ul / cl + ur / cr + c.two_gm1 * (pq - T(1)))
                 / (pq / cl + T(1) / cr);
    const T ptl = max(T(1) + c.half_gm1 * (ul - um) / cl, T(1e-30));
    const T ptr = max(T(1) + c.half_gm1 * (um - ur) / cr, T(1e-30));
    p0 = T(0.5) * (pl * pow(ptl, c.inv_g1) + pr * pow(ptr, c.inv_g1));
  } else {  // two shocks
    const T gel = sqrt((T(2) / (c.gp1 * dl)) / (c.g6 * pl + ppv));
    const T ger = sqrt((T(2) / (c.gp1 * dr)) / (c.g6 * pr + ppv));
    p0 = (gel * pl + ger * pr - (ur - ul)) / (gel + ger);
  }
  T p = max(p0, T(1e-30));
  T fl, flp, fr, frp;
#pragma unroll 1
  for (int it = 0; it < kNewtonSteps; ++it) {
    pressure_fn<T>(p, pl, dl, cl, c, &fl, &flp);
    pressure_fn<T>(p, pr, dr, cr, c, &fr, &frp);
    p = max(p - (fl + fr + ur - ul) / (flp + frp), T(1e-30));
  }
  pressure_fn<T>(p, pl, dl, cl, c, &fl, &flp);
  pressure_fn<T>(p, pr, dr, cr, c, &fr, &frp);
  *pstar = p;
  *ustar = T(0.5) * (ul + ur) + T(0.5) * (fr - fl);
}

// (rho, u, p) at x/t = 0 (ExactRiemannSolver::SampleExactSolution): the
// side of the contact the face lies on, then its wave
template <typename T>
__device__ __forceinline__ void sample_zero(T pstar, T ustar, T dl, T ul,
                                            T pl, T cl, T dr, T ur, T pr,
                                            T cr, const ExactConsts<T>& c,
                                            T* d, T* u, T* p) {
  const bool left = ustar >= T(0);
  const T sign = left ? T(1) : T(-1);
  const T dk = left ? dl : dr, uk = left ? ul : ur;
  const T pk = left ? pl : pr, ck = left ? cl : cr;
  const T un = sign * uk;
  const T ratio = max(pstar / pk, T(1e-30));
  T dd, uu, pp;
  if (pstar > pk) {  // shock
    const T sK = un - ck * sqrt(c.gp * ratio + c.g1);
    if (sK >= T(0)) {
      dd = dk;
      uu = un;
      pp = pk;
    } else {
      dd = dk * (ratio + c.g6) / (c.g6 * ratio + T(1));
      uu = sign * ustar;
      pp = pstar;
    }
  } else {  // rarefaction
    const T shK = un - ck;
    const T stK = sign * ustar - ck * pow(ratio, c.g1);
    if (shK >= T(0)) {
      dd = dk;
      uu = un;
      pp = pk;
    } else if (stK <= T(0)) {
      dd = dk * pow(ratio, c.inv_gamma);
      uu = sign * ustar;
      pp = pstar;
    } else {
      const T cfan = c.two_gp1 * (ck + c.g7 * un);
      const T x = max(cfan / ck, T(0));
      dd = dk * pow(x, c.two_gm1);
      uu = cfan;
      pp = pk * pow(x, c.pfan_exp);
    }
  }
  *d = dd;
  *u = sign * uu;
  *p = pp;
}

// p*, and (rho, u, p) at x/t = 0 of the one-dimensional problem (p* =
// 0: a vacuum, the sample unset)
template <typename T>
struct Sample1d {
  T pstar, d, u, p;
};

template <typename T>
__device__ __noinline__ Sample1d<T> solve_1d(T rl, T vll, T pl, T cl, T rr,
                                              T vlr, T pr, T cr,
                                              const ExactConsts<T> c) {
  Sample1d<T> out;
  T ustar;
  star_region<T>(rl, vll, pl, cl, rr, vlr, pr, cr, c, &out.pstar, &ustar);
  if (!(out.pstar > T(0))) return out;
  sample_zero<T>(out.pstar, ustar, rl, vll, pl, cl, rr, vlr, pr, cr, c,
                 &out.d, &out.u, &out.p);
  return out;
}

// The exact Godunov flux along n (ExactRiemannSolver::ComputeFluxes),
// with hllc's interface: face-frame primitives in, the lab-frame flux
// along n out; the transverse velocity from the upwind side
template <typename T, int NDIM>
__device__ __forceinline__ void exact(const T Wl[Dims<NDIM>::kNvar],
                                      const T Wr[Dims<NDIM>::kNvar],
                                      const T n[NDIM], const T vface[NDIM],
                                      const ExactConsts<T>& c, bool zmf,
                                      T flux[Dims<NDIM>::kNvar]) {
  constexpr int kNvar = Dims<NDIM>::kNvar;
  constexpr int kRho = Dims<NDIM>::kRho;
  constexpr int kP = Dims<NDIM>::kP;
  const T rl = Wl[kRho], pl = Wl[kP], rr = Wr[kRho], pr = Wr[kP];
  const T vll = dot<T, NDIM>(Wl, n);
  const T vlr = dot<T, NDIM>(Wr, n);
  const T cl = sqrt(c.gamma * pl / rl);
  const T cr = sqrt(c.gamma * pr / rr);
  const Sample1d<T> s = solve_1d<T>(rl, vll, pl, cl, rr, vlr, pr, cr, c);
  if (!(s.pstar > T(0))) {  // vacuum
#pragma unroll
    for (int v = 0; v < kNvar; ++v) flux[v] = T(0);
    return;
  }
  const T d0 = s.d, u0 = s.u, p0 = s.p;
  const bool up_left = u0 > T(0);
  const T* Wup = up_left ? Wl : Wr;
  const T vup = up_left ? vll : vlr;
  const T un = zmf ? T(0) : u0;
  T Wv[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    const T vt = Wup[k] - vup * n[k];
    const T vf = zmf ? vface[k] + u0 * n[k] : vface[k];
    Wv[k] = vt + un * n[k] + vf;
  }
  const T etot = T(0.5) * dot<T, NDIM>(Wv, Wv)
                 + p0 / (c.gm1 * max(d0, T(1e-30)));
  const T f_rho = d0 * un;
#pragma unroll
  for (int k = 0; k < NDIM; ++k) flux[k] = f_rho * Wv[k] + p0 * n[k];
  flux[kRho] = f_rho;
  flux[kP] = d0 * etot * un + p0 * dot<T, NDIM>(Wv, n);
}

}  // namespace mfv
