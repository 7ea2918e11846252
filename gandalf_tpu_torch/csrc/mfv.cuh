// Meshless finite-volume pair arithmetic shared by the gradient (K11),
// limiter (K31) and flux (K12) kernels in 1, 2 or 3 dims: the
// closed-form inverse of the least-squares matrix, the face
// reconstruction of each slope limiter, the face state with its
// primitive time derivative and the HLLC Riemann solver.
//
// Each is gandalf_tpu_torch/ops/mfv.py (and gandalf_tpu/ops/mfv.py)
// written for one face, in the same order of operations, so float64
// results agree to rounding.  W = (v_0..v_{NDIM-1}, rho, p); the guards
// T(1e-300) are 0 in float32, as the JAX package's literals are there.
#pragma once

#include "m4.cuh"

namespace mfv {

template <int NDIM>
struct Dims {
  static constexpr int kNvar = NDIM + 2;
  static constexpr int kRho = NDIM;
  static constexpr int kP = NDIM + 1;
};

// the face reconstruction of a slope limiter class: the Gizmo pairwise
// clamp; the plain extrapolation with the cell alphas (null, scalar,
// tvdscalar, springel2009); none (zeroslope)
enum Limiter { kGizmo = 0, kCell = 1, kZeroSlope = 2 };

// jnp.sign: -1, 0 or +1 (0 at 0)
template <typename T>
__device__ __forceinline__ int sgn(T x) {
  return (x > T(0)) - (x < T(0));
}

template <typename T>
__device__ __forceinline__ T guard(T x) {
  return fabs(x) < T(1e-300) ? T(1e-300) : x;
}

// B = E^-1, row-major NDIM x NDIM (ops/mfv.py:_invert_small): 1/E with
// E = 0 replaced by 1e-300 in 1D, the adjugate over the determinant
// (floored to 1e-300 in magnitude) in 2D and 3D
template <typename T, int NDIM>
__device__ __forceinline__ void invert(const T m[NDIM * NDIM],
                                       T B[NDIM * NDIM]) {
  if (NDIM == 1) {
    B[0] = T(1) / (m[0] == T(0) ? T(1e-300) : m[0]);
  } else if (NDIM == 2) {
    T det = m[0] * m[3] - m[1] * m[2];
    if (fabs(det) < T(1e-300)) det = T(1e-300);
    B[0] = m[3] / det;
    B[1] = -m[1] / det;
    B[2] = -m[2] / det;
    B[3] = m[0] / det;
  } else {
    const T c00 = m[4] * m[8] - m[5] * m[7];
    const T c01 = m[5] * m[6] - m[3] * m[8];
    const T c02 = m[3] * m[7] - m[4] * m[6];
    T det = m[0] * c00 + m[1] * c01 + m[2] * c02;
    if (fabs(det) < T(1e-300)) det = T(1e-300);
    const T c10 = m[2] * m[7] - m[1] * m[8];
    const T c11 = m[0] * m[8] - m[2] * m[6];
    const T c12 = m[1] * m[6] - m[0] * m[7];
    const T c20 = m[1] * m[5] - m[2] * m[4];
    const T c21 = m[2] * m[3] - m[0] * m[5];
    const T c22 = m[0] * m[4] - m[1] * m[3];
    B[0] = c00 / det; B[1] = c10 / det; B[2] = c20 / det;
    B[3] = c01 / det; B[4] = c11 / det; B[5] = c21 / det;
    B[6] = c02 / det; B[7] = c12 / det; B[8] = c22 / det;
  }
}

// phimid - Wi of GizmoLimiter::ComputeLimitedSlopes for one variable:
// the reconstruction Wi + dW0 clamped to the bracket of (Wi, Wj) widened
// by psi1 |Wi - Wj| and around the interpolant by psi2 |Wi - Wj|
template <typename T>
__device__ __forceinline__ T gizmo_clamp(T Wi, T Wj, T dW0, T ratio) {
  const T delta1 = T(0.5) * fabs(Wi - Wj);
  const T delta2 = T(0.375) * fabs(Wi - Wj);
  const T phimin = min(Wi, Wj);
  const T phimax = max(Wi, Wj);
  const T phibar = Wi + (Wj - Wi) * ratio;
  const T phimid0 = Wi + dW0;
  T phimid;
  if (Wi < Wj) {
    const T lo = sgn(phimin - delta1) == sgn(phimin)
                     ? phimin - delta1
                     : phimin / (T(1) + delta1 / max(fabs(phimin),
                                                     T(1e-300)));
    phimid = max(lo, min(phibar + delta2, phimid0));
  } else if (Wi > Wj) {
    const T hi = sgn(phimax + delta1) == sgn(phimax)
                     ? phimax + delta1
                     : phimax / (T(1) + delta1 / max(fabs(phimax),
                                                     T(1e-300)));
    phimid = min(hi, max(phibar - delta2, phimid0));
  } else {
    phimid = Wi;
  }
  return phimid - Wi;
}

// One face state: W reconstructed to the face (draux from the particle)
// by limiter class LIM, the face velocity taken out, and its primitive
// time derivative (FV::CalculatePrimitiveTimeDerivative, with the
// particle's sound speed) plus the acceleration.  gradW is the limited
// gradient (alpha * grad, or grad, or 0 under zeroslope), row-major
// (nvar, NDIM); Wo the neighbour's primitives.
template <typename T, int NDIM, int LIM>
__device__ __forceinline__ void face_state(
    const T W[Dims<NDIM>::kNvar], const T Wo[Dims<NDIM>::kNvar],
    const T gradW[Dims<NDIM>::kNvar * NDIM], const T draux[NDIM], T ratio,
    const T vface[NDIM], T sound, const T acc[NDIM],
    T out[Dims<NDIM>::kNvar], T Wdot[Dims<NDIM>::kNvar]) {
  constexpr int kNvar = Dims<NDIM>::kNvar;
  constexpr int kRho = Dims<NDIM>::kRho;
  constexpr int kP = Dims<NDIM>::kP;
#pragma unroll
  for (int v = 0; v < kNvar; ++v) {
    if (LIM == kZeroSlope) {
      out[v] = W[v];
      continue;
    }
    T dW0 = gradW[NDIM * v] * draux[0];
#pragma unroll
    for (int a = 1; a < NDIM; ++a) dW0 += gradW[NDIM * v + a] * draux[a];
    out[v] = LIM == kGizmo ? W[v] + gizmo_clamp(W[v], Wo[v], dW0, ratio)
                           : W[v] + dW0;
  }
#pragma unroll
  for (int k = 0; k < NDIM; ++k) out[k] = out[k] - vface[k];
  const T rho = out[kRho];
  if (LIM == kZeroSlope) {
#pragma unroll
    for (int v = 0; v < kNvar; ++v) Wdot[v] = T(0);
#pragma unroll
    for (int k = 0; k < NDIM; ++k) Wdot[k] = acc[k];
    return;
  }
  T divV = gradW[0];
#pragma unroll
  for (int k = 1; k < NDIM; ++k) divV += gradW[NDIM * k + k];
#pragma unroll
  for (int v = 0; v < kNvar; ++v) {
    T adv = out[0] * gradW[NDIM * v];
#pragma unroll
    for (int a = 1; a < NDIM; ++a) adv += out[a] * gradW[NDIM * v + a];
    Wdot[v] = -adv;
  }
#pragma unroll
  for (int k = 0; k < NDIM; ++k)
    Wdot[k] = Wdot[k] - gradW[NDIM * kP + k] / rho + acc[k];
  Wdot[kRho] = Wdot[kRho] + (-rho * divV);
  Wdot[kP] = Wdot[kP] + (-rho * sound * sound * divV);
}

// the positivity floors 1e-15 of a face state's rho and p
template <typename T, int NDIM>
__device__ __forceinline__ void sanitise(T W[Dims<NDIM>::kNvar]) {
  W[Dims<NDIM>::kRho] = max(W[Dims<NDIM>::kRho], T(1e-15));
  W[Dims<NDIM>::kP] = max(W[Dims<NDIM>::kP], T(1e-15));
}

template <typename T, int NDIM>
__device__ __forceinline__ T dot(const T a[NDIM], const T b[NDIM]) {
  T s = a[0] * b[0];
#pragma unroll
  for (int k = 1; k < NDIM; ++k) s += a[k] * b[k];
  return s;
}

// Rankine-Hugoniot star-state correction of one side (add_RH_flux),
// added to f
template <typename T, int NDIM>
__device__ __forceinline__ void add_rh(T rho, T press, const T v[NDIM],
                                       T vline, T e, T vwave, T vm,
                                       const T n[NDIM],
                                       T f[Dims<NDIM>::kNvar]) {
  const T dms = rho * (vline - vwave);
  const T qs_rho = rho * (vwave - vline) / guard(vwave - vm);
  const T qs_E = qs_rho * (e / rho + (vm - vline) * (vm - press / guard(dms)));
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    const T qs_v = qs_rho * (v[k] + (vm - vline) * n[k]);
    f[k] = f[k] + vwave * (qs_v - rho * v[k]);
  }
  f[Dims<NDIM>::kRho] = f[Dims<NDIM>::kRho] + vwave * (qs_rho - rho);
  f[Dims<NDIM>::kP] = f[Dims<NDIM>::kP] + vwave * (qs_E - e);
}

// HLLC flux along n between face-frame states Wl, Wr
// (HllcRiemannSolver.solve, ops/mfv.py:hllc_flux), returned in the lab
// frame.  With zero mass flux the solution is boosted into the contact
// frame and keeps the lab-frame energies, as the reference does.  gm1 is
// gamma - 1 formed in double, as the JAX package's Python float is.
template <typename T, int NDIM>
__device__ __forceinline__ void hllc(const T Wl[Dims<NDIM>::kNvar],
                                     const T Wr[Dims<NDIM>::kNvar],
                                     const T n[NDIM], const T vface_in[NDIM],
                                     T gamma, T gm1, bool zmf,
                                     T flux[Dims<NDIM>::kNvar]) {
  constexpr int kNvar = Dims<NDIM>::kNvar;
  constexpr int kRho = Dims<NDIM>::kRho;
  constexpr int kP = Dims<NDIM>::kP;
  T vl[NDIM], vr[NDIM], vface[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    vl[k] = Wl[k];
    vr[k] = Wr[k];
    vface[k] = vface_in[k];
  }
  const T rl = Wl[kRho], pl = Wl[kP], rr = Wr[kRho], pr = Wr[kP];
  T vll = dot<T, NDIM>(vl, n);
  T vlr = dot<T, NDIM>(vr, n);
  const T cl = sqrt(gamma * pl / rl), cr = sqrt(gamma * pr / rr);
  const T el = T(0.5) * rl * dot<T, NDIM>(vl, vl) + pl / gm1;
  const T er = T(0.5) * rr * dot<T, NDIM>(vr, vr) + pr / gm1;
  // Roe-averaged wave speeds (HLL_Speeds)
  const T R = sqrt(rr / rl);
  const T fl = T(1) / (T(1) + R);
  const T fr = T(1) - fl;
  const T v_av = fl * vll + fr * vlr;
  T dv2 = (vl[0] - vr[0]) * (vl[0] - vr[0]);
#pragma unroll
  for (int k = 1; k < NDIM; ++k) dv2 += (vl[k] - vr[k]) * (vl[k] - vr[k]);
  const T gam_eff = max((rl * cl * cl + rr * cr * cr) / (pl + pr), T(1));
  const T cs_av = sqrt(fl * cl * cl + fr * cr * cr
                       + T(0.5) * fl * fr * (gam_eff - T(1)) * dv2);
  T Smin = min(vll - cl, v_av - cs_av);
  T Smax = max(vlr + cr, v_av + cs_av);
  // contact speed
  const T dml = rl * (vll - Smin);
  const T dmr = rr * (vlr - Smax);
  const T Pl = vll * dml + pl;
  const T Pr = vlr * dmr + pr;
  T vm = (Pr - Pl) / guard(dmr - dml);
  if (zmf) {
    Smin = Smin - vm;
    Smax = Smax - vm;
    vll = vll - vm;
    vlr = vlr - vm;
#pragma unroll
    for (int k = 0; k < NDIM; ++k) {
      vl[k] = vl[k] - vm * n[k];
      vr[k] = vr[k] - vm * n[k];
      vface[k] = vface[k] + vm * n[k];
    }
    vm = T(0);
  }
  // the side that the solution at the face takes
  const bool right = Smax <= T(0) || (!(Smin >= T(0)) && !(vm > T(0)));
  const T rho = right ? rr : rl, press = right ? pr : pl;
  const T vline = right ? vlr : vll, e = right ? er : el;
  const T* v = right ? vr : vl;
  T f[kNvar];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) f[k] = rho * vline * v[k] + press * n[k];
  f[kRho] = rho * vline;
  f[kP] = (press + e) * vline;
  if (!(Smax <= T(0)) && !(Smin >= T(0)))
    add_rh<T, NDIM>(rho, press, v, vline, e, right ? Smax : Smin, vm, n, f);
  if (zmf) f[kRho] = T(0);
  // back to the lab frame
  const T fE = f[kP] + dot<T, NDIM>(f, vface)
               + f[kRho] * T(0.5) * dot<T, NDIM>(vface, vface);
#pragma unroll
  for (int k = 0; k < NDIM; ++k) flux[k] = f[k] + f[kRho] * vface[k];
  flux[kRho] = f[kRho];
  flux[kP] = fE;
}

}  // namespace mfv
