// Meshless finite-volume pair arithmetic shared by the gradient (K11)
// and flux (K12) kernels: the closed-form 3x3 inverse, the Gizmo face
// clamp, the primitive time derivative and the HLLC Riemann solver.
//
// Each is gandalf_tpu_torch/ops/mfv.py (and gandalf_tpu/ops/mfv.py)
// written for one face, in the same order of operations, so float64
// results agree to rounding.  W = (v0, v1, v2, rho, p); the guards
// T(1e-300) are 0 in float32, as the JAX package's literals are there.
#pragma once

#include "m4.cuh"

namespace mfv {

constexpr int kNvar = 5;
constexpr int kRho = 3;
constexpr int kP = 4;

// jnp.sign: -1, 0 or +1 (0 at 0)
template <typename T>
__device__ __forceinline__ int sgn(T x) {
  return (x > T(0)) - (x < T(0));
}

// B = adj(E) / det(E), det floored to 1e-300 in magnitude
// (ops/mfv.py:_invert_small, ndim 3); row-major 3x3
template <typename T>
__device__ __forceinline__ void invert3(const T m[9], T B[9]) {
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

// One face state: W + the Gizmo-limited slope to the face (draux from the
// particle), the face velocity taken out, then the MUSCL half step with
// the primitive time derivative (FV::CalculatePrimitiveTimeDerivative,
// with the particle's sound speed) plus the acceleration.  gradW is
// alpha * grad, row-major (5, 3); Wo the neighbour's primitives.
template <typename T>
__device__ __forceinline__ void face_state(const T W[kNvar],
                                           const T Wo[kNvar],
                                           const T gradW[kNvar * 3],
                                           const T draux[3], T ratio,
                                           const T vface[3], T sound,
                                           const T acc[3], T dt,
                                           T out[kNvar]) {
#pragma unroll
  for (int v = 0; v < kNvar; ++v) {
    const T dW0 = gradW[3 * v] * draux[0] + gradW[3 * v + 1] * draux[1]
                  + gradW[3 * v + 2] * draux[2];
    out[v] = W[v] + gizmo_clamp(W[v], Wo[v], dW0, ratio);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = out[k] - vface[k];
  const T divV = gradW[0] + gradW[4] + gradW[8];
  const T rho = out[kRho];
  T Wdot[kNvar];
#pragma unroll
  for (int v = 0; v < kNvar; ++v)
    Wdot[v] = -(out[0] * gradW[3 * v] + out[1] * gradW[3 * v + 1]
                + out[2] * gradW[3 * v + 2]);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    Wdot[k] = Wdot[k] - gradW[3 * kP + k] / rho + acc[k];
  Wdot[kRho] = Wdot[kRho] + (-rho * divV);
  Wdot[kP] = Wdot[kP] + (-rho * sound * sound * divV);
#pragma unroll
  for (int v = 0; v < kNvar; ++v) out[v] = out[v] + T(0.5) * Wdot[v] * dt;
}

template <typename T>
__device__ __forceinline__ T guard(T x) {
  return fabs(x) < T(1e-300) ? T(1e-300) : x;
}

// Rankine-Hugoniot star-state correction of one side (add_RH_flux),
// added to f
template <typename T>
__device__ __forceinline__ void add_rh(T rho, T press, const T v[3],
                                       T vline, T e, T vwave, T vm,
                                       const T n[3], T f[kNvar]) {
  const T dms = rho * (vline - vwave);
  const T qs_rho = rho * (vwave - vline) / guard(vwave - vm);
  const T qs_E = qs_rho * (e / rho + (vm - vline) * (vm - press / guard(dms)));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T qs_v = qs_rho * (v[k] + (vm - vline) * n[k]);
    f[k] = f[k] + vwave * (qs_v - rho * v[k]);
  }
  f[kRho] = f[kRho] + vwave * (qs_rho - rho);
  f[kP] = f[kP] + vwave * (qs_E - e);
}

// HLLC flux along n between face-frame states Wl, Wr
// (HllcRiemannSolver.solve, ops/mfv.py:hllc_flux), returned in the lab
// frame.  With zero mass flux the solution is boosted into the contact
// frame and keeps the lab-frame energies, as the reference does.  gm1 is
// gamma - 1 formed in double, as the JAX package's Python float is.
template <typename T>
__device__ __forceinline__ void hllc(const T Wl[kNvar], const T Wr[kNvar],
                                     const T n[3], const T vface_in[3],
                                     T gamma, T gm1, bool zmf,
                                     T flux[kNvar]) {
  T vl[3] = {Wl[0], Wl[1], Wl[2]}, vr[3] = {Wr[0], Wr[1], Wr[2]};
  T vface[3] = {vface_in[0], vface_in[1], vface_in[2]};
  const T rl = Wl[kRho], pl = Wl[kP], rr = Wr[kRho], pr = Wr[kP];
  T vll = vl[0] * n[0] + vl[1] * n[1] + vl[2] * n[2];
  T vlr = vr[0] * n[0] + vr[1] * n[1] + vr[2] * n[2];
  const T cl = sqrt(gamma * pl / rl), cr = sqrt(gamma * pr / rr);
  const T el = T(0.5) * rl * (vl[0] * vl[0] + vl[1] * vl[1] + vl[2] * vl[2])
               + pl / gm1;
  const T er = T(0.5) * rr * (vr[0] * vr[0] + vr[1] * vr[1] + vr[2] * vr[2])
               + pr / gm1;
  // Roe-averaged wave speeds (HLL_Speeds)
  const T R = sqrt(rr / rl);
  const T fl = T(1) / (T(1) + R);
  const T fr = T(1) - fl;
  const T v_av = fl * vll + fr * vlr;
  const T dvx = vl[0] - vr[0], dvy = vl[1] - vr[1], dvz = vl[2] - vr[2];
  const T dv2 = dvx * dvx + dvy * dvy + dvz * dvz;
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
    for (int k = 0; k < 3; ++k) {
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
  for (int k = 0; k < 3; ++k) f[k] = rho * vline * v[k] + press * n[k];
  f[kRho] = rho * vline;
  f[kP] = (press + e) * vline;
  if (!(Smax <= T(0)) && !(Smin >= T(0)))
    add_rh(rho, press, v, vline, e, right ? Smax : Smin, vm, n, f);
  if (zmf) f[kRho] = T(0);
  // back to the lab frame
  const T fE = f[kP] + (f[0] * vface[0] + f[1] * vface[1] + f[2] * vface[2])
               + f[kRho] * T(0.5)
                     * (vface[0] * vface[0] + vface[1] * vface[1]
                        + vface[2] * vface[2]);
#pragma unroll
  for (int k = 0; k < 3; ++k) flux[k] = f[k] + f[kRho] * vface[k];
  flux[kRho] = f[kRho];
  flux[kP] = fE;
}

}  // namespace mfv
