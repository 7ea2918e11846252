// One SPH pair's share of the grad-h hydro force sums, shared by the
// grid force kernel (K3) and the active-subset force kernel (K9), each
// in 1, 2 or 3 dims.
//
// The packed per-particle scalars are ops/sph_grid27.py:FORCE_SCALARS.
// A pair adds m_j paux / d * dr to the acceleration, its viscous and
// conductive heating to du/dt and -m_j dvdr W'_i to the unnormalised
// velocity divergence: the conservative grad-h pressure term, mon97
// viscosity (or the mean of the two alphas) on approaching pairs with
// the signal velocity, and the Wadsley (2008) or Price (2008)
// conductivity.  Separations and dvdr are computed directly.  The
// kernel derivative is the family's (kernel_family.cuh), a template
// parameter of the callers.
#pragma once

#include "kernel_family.cuh"

namespace sph {

// dissipation codes of gandalf_tpu_torch/ops/forces.py
constexpr int kAviscNone = 0;
constexpr int kAviscMon97 = 1;
constexpr int kAcondWadsley2008 = 1;
constexpr int kAcondPrice2008 = 2;

enum Scalar { kM, kH, kRho, kU, kPress, kSound, kInvom, kHfac, kAlpha,
              kNScalars };

struct Dissipation {
  int avisc, acond;
  double alpha_visc, beta_visc;
};

// the target particle's values that every pair reads
template <typename T>
struct Own {
  T invh, invrho, press, sound, u, hfac, alpha, pterm;

  __device__ __forceinline__ explicit Own(const T* si)
      : invh(T(1) / max(si[kH], T(1e-30))),
        invrho(T(1) / max(si[kRho], T(1e-300))),
        press(si[kPress]), sound(si[kSound]), u(si[kU]), hfac(si[kHfac]),
        alpha(si[kAlpha]),
        pterm(si[kPress] * si[kInvom] * invrho * invrho) {}
};

// sums over NDIM dims: acc[0..NDIM-1] the acceleration, acc[NDIM] dudt,
// acc[NDIM+1] divv.  dv = v_j - v_i; dr = r_j - r_i; drmag = |dr| > 0.
template <typename T, int NDIM, class KF>
__device__ __forceinline__ void pair_add_n(const Own<T>& o, const T* sj,
                                           const T* dr, const T* dv,
                                           T drmag, const KF& kern,
                                           const Dissipation& dis,
                                           T* acc) {
  const T inv_drmag = T(1) / drmag;
  const T m_j = sj[kM];
  const T invrho_j = T(1) / sj[kRho];
  const T wkerni = o.hfac * kern.w1(drmag * o.invh);
  const T wkernj = sj[kHfac] * kern.w1(drmag / sj[kH]);
  T dvdr_sum = dv[0] * dr[0];
#pragma unroll
  for (int k = 1; k < NDIM; ++k) dvdr_sum += dv[k] * dr[k];
  const T dvdr = dvdr_sum * inv_drmag;
  acc[NDIM + 1] -= m_j * dvdr * wkerni;
  T paux = o.pterm * wkerni
           + sj[kPress] * sj[kInvom] * invrho_j * invrho_j * wkernj;
  if (dis.avisc != kAviscNone && dvdr < T(0)) {
    const T winvrho = T(0.25) * (wkerni + wkernj) * (o.invrho + invrho_j);
    const T alpha_eff = dis.avisc == kAviscMon97
                            ? T(dis.alpha_visc)
                            : T(0.5) * (o.alpha + sj[kAlpha]);
    const T vsignal = o.sound + sj[kSound]
                      - T(dis.beta_visc) * alpha_eff * dvdr;
    paux -= alpha_eff * vsignal * dvdr * winvrho;
    acc[NDIM] -= T(0.5) * m_j * alpha_eff * vsignal * dvdr * dvdr * winvrho;
    if (dis.acond == kAcondWadsley2008) {
      acc[NDIM] += m_j * dvdr * (sj[kU] - o.u)
                   * (o.invrho * wkerni + invrho_j * wkernj);
    } else if (dis.acond == kAcondPrice2008) {
      acc[NDIM] += T(0.5) * m_j * (o.u - sj[kU]) * winvrho
                   * (o.invrho + invrho_j) * sqrt(fabs(o.press - sj[kPress]));
    }
  }
  const T w_pair = m_j * paux * inv_drmag;
#pragma unroll
  for (int k = 0; k < NDIM; ++k) acc[k] += w_pair * dr[k];
}

}  // namespace sph
