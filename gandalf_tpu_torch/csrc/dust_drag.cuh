// K23 dust_drag_sums and K24 dust_drag_deposit: the semi-implicit
// gas-dust drag over the 3^NDIM-cell stencil, in 1, 2 or 3 dims.
//
// Replaces gandalf_tpu/ops/dust.py:drag_pass_grid (:269) and its pair
// sums drag_twofluid_view (:177-266) (GANDALF's
// DustSemiImplictForces::ComputeDragForces, src/Common/Dust.cpp:
// 1004-1135): for every gas-dust pair of a particle's candidates, the
// drag kernel wdrag taken with the gas side's h, the stopping time of
// the drag law (fixed, density, epstein or lp12; DragLaws.h), the exact
// integral of the linear drag over the target's step (Xi, Lambda, with
// the series form where tau <= 1e-3) and the pair's acceleration along
// the separation.  K23 gives each target a_drag, the normalisation
// sum_j m_j / rho_j wdrag, the dust's sound speed (the largest over its
// gas partners) and its largest |dv| over h.  The JAX package scatters
// each dust particle's heating onto its gas candidates (:255-264); K24
// is the gather form of drag_pass_dense (:485-497): a gas target sums
// wraw(|r_ij|, h_i) P_j over its dust candidates (P = m dEk / norm,
// computed between the two launches), divides by rho_i and adds -dEk_i.
//
// Bound on the card: the candidate loads.  Every target sweeps the filled
// slots of its 3^NDIM cells (the dust's sound speed and |dv| take every
// cross-type candidate, inside the kernel's support or not, as in the
// JAX package); K1 fills a cell's slots from 0 up, so a cell's sweep ends
// at its first empty slot rather than at K.  In 3D the function needs
// about 38 operations for each cross-type candidate and about 77 more
// for one inside the drag kernel's support (the kernel, the law, an exp
// and two divisions; check.FLOPS_PER).
//
// Design: one thread per slot of K1's slot map (particle id per slot, -1
// empty; the dead are binned out), flat over (cell, slot) as K22, NDIM,
// the drag law and the smoothing kernel (M4, quintic or gaussian, direct
// or tabulated: kernel_family.cuh) template parameters.  The drag kernel
// is the family's wdrag, normdrag s^2 W(s), at s = |dr| / h_gas, a table
// quantising s on the s grid; any kernel but the direct M4 sums d^2 in
// the plain version's rounded steps (kExactD2), so that s, and a table
// index, are the plain version's.  Each family builds from a source of
// its own (dust_drag_{m4,quintic,gaussian}.cu, the direct and tabulated
// kernels in each), so that the build compiles them in parallel.  The
// slot map may hold mirror images (ids from n_targets on, from K19):
// those slots are neighbours only.  A thread keeps its sums in registers
// and writes each output once, so no atomics.  The separation, dv - dt/2
// da0 and da are formed directly, in the plain version's order, with no
// dot-product expansion.  Outputs are in particle order; a target without
// a slot keeps the wrapper's zeros.  No shared-memory staging yet.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "grid27.cuh"
#include "kernel_family.cuh"

namespace dust_k23 {

constexpr int kThreads = 128;
constexpr int kGas = 0, kDust = 3;  // state.py's GAS_TYPE and DUST_TYPE
// columns of the packed scalars (ops/dust.py:DRAG_SCALARS)
constexpr int kM = 0, kH = 1, kRho = 2, kSound = 3, kCols = 4;
enum { kFixed = 0, kDensity = 1, kEpstein = 2, kLp12 = 3 };
// 3 sqrt(pi/8) / 4 (DragLaws.h:73)
constexpr double kEpsteinNorm = 0.4699928014933126;

template <typename T, int NDIM>
__device__ __forceinline__ T ipow(T x) {
  return NDIM == 1 ? x : NDIM == 2 ? x * x : x * x * x;
}

// the stopping time of the law (ops/dust.py:DragLaw.t_stop)
template <typename T, int LAW>
__device__ __forceinline__ T t_stop(T grho, T drho, T gsound, T coeff,
                                    T inv_coeff) {
  if (LAW == kFixed) return inv_coeff;
  if (LAW == kDensity) return T(1) / ((grho + drho) * coeff);
  if (LAW == kEpstein)
    return T(kEpsteinNorm) / ((grho + drho) * gsound * coeff);
  return drho * grho / ((grho + drho) * coeff);
}

struct DragArgs {
  Grid3 g;
  int n_cells;
  int n_targets;
  double coeff, inv_coeff;
  int test_particle;
};

template <typename T, int NDIM, int LAW, class KF>
__device__ __forceinline__ void sums_slot(
    const int* __restrict__ ids, const T* __restrict__ r,
    const T* __restrict__ vec, const T* __restrict__ sc,
    const int* __restrict__ pt, const T* __restrict__ dt,
    const DragArgs& A, const KF& kern, long long t, T* __restrict__ a_out,
    T* __restrict__ norm_out, T* __restrict__ sound_out,
    T* __restrict__ divv_out) {
  const Grid3& g = A.g;
  const int K = g.K;
  const int p = ids[t];
  if (p < 0 || p >= A.n_targets) return;
  const int pti = pt[p];
  const bool gas_i = pti == kGas, dust_i = pti == kDust;
  const T coeff = T(A.coeff), inv_coeff = T(A.inv_coeff);
  int cc[3];
  cell_coords(g, static_cast<int>(t / K), cc);
  T xi[NDIM], vi[NDIM], ai[NDIM], a0i[NDIM];
  const T* own = vec + 3 * NDIM * static_cast<long long>(p);
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    xi[k] = r[NDIM * static_cast<long long>(p) + k];
    vi[k] = own[k];
    ai[k] = own[NDIM + k];
    a0i[k] = own[2 * NDIM + k];
  }
  const T* si = sc + kCols * static_cast<long long>(p);
  const T h_i = si[kH], rho_i = si[kRho], sound_i = si[kSound];
  const T dti = dt[p];
  const T dt_safe = max(dti, T(1e-30));
  const T half_dt = T(0.5) * dti;
  T acc[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) acc[k] = T(0);
  T nrm = T(0), smax = T(0), dvmax = T(0);
  if (gas_i || dust_i) {
    const int want = gas_i ? kDust : kGas;
    for (int d = 0; d < Stencil<NDIM>::kSize; ++d) {
      int nc;
      T sh[3];
      if (!neighbour_cell<T, NDIM>(g, cc, d, &nc, sh)) continue;
      const int* slots = ids + static_cast<long long>(nc) * K;
      for (int j = 0; j < K; ++j) {
        const int q = slots[j];
        if (q < 0) break;  // K1 fills a cell's slots from 0 up
        if (pt[q] != want) continue;
        T drij[NDIM];
        T d2 = T(0);
#pragma unroll
        for (int k = 0; k < NDIM; ++k) {
          // r_i - r_j = -(r_j + shift - r_i), exactly
          drij[k] = -((r[NDIM * static_cast<long long>(q) + k] + sh[k])
                      - xi[k]);
          if (KF::kExactD2)
            d2 = kf::add(d2, kf::mul(drij[k], drij[k]));
          else
            d2 += drij[k] * drij[k];
        }
        if (!(d2 > T(0))) continue;
        const T* sq = sc + kCols * static_cast<long long>(q);
        const T* vq = vec + 3 * NDIM * static_cast<long long>(q);
        const T drmag = sqrt(d2);
        const T h_gas = max(gas_i ? h_i : sq[kH], T(1e-30));
        const T invh = T(1) / h_gas;
        const T wraw = ipow<T, NDIM>(invh) * kern.wdrag(drmag * invh);
        const T rho_j = sq[kRho];
        const T wkern = wraw * sq[kM] / max(rho_j, T(1e-30));
        T dvdr = T(0), dadr = T(0), dv2 = T(0);
#pragma unroll
        for (int k = 0; k < NDIM; ++k) {
          const T unit = drij[k] / drmag;
          const T dv = (vi[k] - vq[k]) - half_dt * (a0i[k] - vq[2 * NDIM + k]);
          const T da = ai[k] - vq[NDIM + k];
          dvdr += dv * unit;
          dadr += da * unit;
          dv2 += dv * dv;
        }
        const T grho = gas_i ? rho_i : rho_j;
        const T drho = A.test_particle ? T(0) : (gas_i ? rho_j : rho_i);
        const T gsound = gas_i ? sound_i : sq[kSound];
        const T t_s = max(t_stop<T, LAW>(grho, drho, gsound, coeff,
                                         inv_coeff), T(1e-30));
        const T rho_t = grho + drho;
        const T tau = dti / t_s;
        T Xi, Lam;
        if (tau > T(1e-3)) {
          Xi = (T(1) - exp(-tau)) / (dt_safe * rho_t);
          Lam = (dti + t_s) * Xi - T(1) / rho_t;
        } else {
          const T xs0 = (T(1) - T(0.5) * tau * (T(1) - tau / T(3))) / rho_t;
          Lam = (T(1) + tau) * xs0 - T(1) / rho_t;
          Xi = xs0 / t_s;
        }
        const T S = (dvdr + dti * dadr) * Xi - dadr * Lam;
        const T contrib = T(NDIM) * rho_j * S * wkern;
#pragma unroll
        for (int k = 0; k < NDIM; ++k) acc[k] += contrib * (drij[k] / drmag);
        nrm += wkern;
        smax = max(smax, gsound);
        dvmax = max(dvmax, sqrt(max(dv2, T(0))));
      }
    }
  }
  const bool zero_a = A.test_particle && !dust_i;
#pragma unroll
  for (int k = 0; k < NDIM; ++k)
    a_out[NDIM * static_cast<long long>(p) + k] = zero_a ? T(0) : -acc[k];
  norm_out[p] = nrm;
  sound_out[p] = smax;
  divv_out[p] = dvmax / max(h_i, T(1e-30));
}

template <typename T, int NDIM, int LAW, class KF>
__global__ void __launch_bounds__(kThreads) dust_sums_kernel(
    const int* __restrict__ ids, const T* __restrict__ r,
    const T* __restrict__ vec, const T* __restrict__ sc,
    const int* __restrict__ pt, const T* __restrict__ dt, DragArgs A,
    KF kern, T* __restrict__ a_out, T* __restrict__ norm_out,
    T* __restrict__ sound_out, T* __restrict__ divv_out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (t >= static_cast<long long>(A.n_cells) * A.g.K) return;
  sums_slot<T, NDIM, LAW>(ids, r, vec, sc, pt, dt, A, kern, t, a_out,
                          norm_out, sound_out, divv_out);
}

template <typename T, int NDIM, class KF>
__global__ void __launch_bounds__(kThreads) dust_deposit_kernel(
    const int* __restrict__ ids, const T* __restrict__ r,
    const T* __restrict__ sc, const int* __restrict__ pt,
    const T* __restrict__ payload, const T* __restrict__ dek, DragArgs A,
    KF kern, T* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const Grid3& g = A.g;
  const int K = g.K;
  if (t >= static_cast<long long>(A.n_cells) * K) return;
  const int p = ids[t];
  if (p < 0 || p >= A.n_targets || pt[p] != kGas) return;
  int cc[3];
  cell_coords(g, static_cast<int>(t / K), cc);
  T xi[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) xi[k] = r[NDIM * static_cast<long long>(p) + k];
  const T* si = sc + kCols * static_cast<long long>(p);
  const T invh = T(1) / max(si[kH], T(1e-30));
  const T hfac = ipow<T, NDIM>(invh);
  T dep = T(0);
  for (int d = 0; d < Stencil<NDIM>::kSize; ++d) {
    int nc;
    T sh[3];
    if (!neighbour_cell<T, NDIM>(g, cc, d, &nc, sh)) continue;
    const int* slots = ids + static_cast<long long>(nc) * K;
    for (int j = 0; j < K; ++j) {
      const int q = slots[j];
      if (q < 0) break;  // K1 fills a cell's slots from 0 up
      if (pt[q] != kDust) continue;
      T d2 = T(0);
#pragma unroll
      for (int k = 0; k < NDIM; ++k) {
        const T dx = (r[NDIM * static_cast<long long>(q) + k] + sh[k]) - xi[k];
        if (KF::kExactD2)
          d2 = kf::add(d2, kf::mul(dx, dx));
        else
          d2 += dx * dx;
      }
      if (!(d2 > T(0))) continue;
      const T s = sqrt(d2) * invh;
      if (!kern.in_support(s)) continue;  // wdrag = 0 from the edge on
      dep += hfac * kern.wdrag(s) * payload[q];
    }
  }
  out[p] = -dek[p] - dep / max(si[kRho], T(1e-30));
}

inline int blocks_for(long long slots) {
  return static_cast<int>((slots + kThreads - 1) / kThreads);
}

template <typename T, int NDIM, class KF>
void launch_sums(int law, const int* ids, const T* r, const T* vec,
                 const T* sc, const int* pt, const T* dt, const DragArgs& A,
                 const KF& kern, T* a, T* nrm, T* snd, T* divv,
                 cudaStream_t stream) {
  const int blocks = blocks_for(static_cast<long long>(A.n_cells) * A.g.K);
#define DUST_SUMS(LAW)                                                      \
  dust_sums_kernel<T, NDIM, LAW, KF><<<blocks, kThreads, 0, stream>>>(      \
      ids, r, vec, sc, pt, dt, A, kern, a, nrm, snd, divv)
  switch (law) {
    case kFixed: DUST_SUMS(kFixed); break;
    case kDensity: DUST_SUMS(kDensity); break;
    case kEpstein: DUST_SUMS(kEpstein); break;
    default: DUST_SUMS(kLp12); break;
  }
#undef DUST_SUMS
}

inline DragArgs make_args(int n0, int n1, int n2, int k_cell, int per0,
                          int per1, int per2, double L0, double L1,
                          double L2, int n_targets, double coeff,
                          double inv_coeff, int test_particle) {
  DragArgs A;
  A.g = {{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell};
  A.n_cells = n0 * n1 * n2;
  A.n_targets = n_targets;
  A.coeff = coeff;
  A.inv_coeff = inv_coeff;
  A.test_particle = test_particle;
  return A;
}

template <typename T, int FAM>
int run_sums(const int* ids, int n_targets, const T* r, const T* vec,
             const T* sc, const int* pt, const T* dt, int ndim, int n0,
             int n1, int n2, int k_cell, int per0, int per1, int per2,
             double L0, double L1, double L2, double norm, double normdrag,
             int res, int law, double coeff, double inv_coeff,
             int test_particle, T* a, T* nrm, T* snd, T* divv, int device,
             void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ndim < 1 || ndim > 3 || law < 0 || law > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const DragArgs A = make_args(n0, n1, n2, k_cell, per0, per1, per2, L0,
                               L1, L2, n_targets, coeff, inv_coeff,
                               test_particle);
  if (A.n_cells > 0 && k_cell > 0) {
    kf::with_family<T, FAM>(
        res, norm, ndim,
        [&](const auto& kern) {
          if (ndim == 1)
            launch_sums<T, 1>(law, ids, r, vec, sc, pt, dt, A, kern, a, nrm,
                              snd, divv, stream);
          else if (ndim == 2)
            launch_sums<T, 2>(law, ids, r, vec, sc, pt, dt, A, kern, a, nrm,
                              snd, divv, stream);
          else
            launch_sums<T, 3>(law, ids, r, vec, sc, pt, dt, A, kern, a, nrm,
                              snd, divv, stream);
        },
        normdrag);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int FAM>
int run_deposit(const int* ids, int n_targets, const T* r, const T* sc,
                const int* pt, const T* payload, const T* dek, int ndim,
                int n0, int n1, int n2, int k_cell, int per0, int per1,
                int per2, double L0, double L1, double L2, double norm,
                double normdrag, int res, T* out, int device,
                void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ndim < 1 || ndim > 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const DragArgs A = make_args(n0, n1, n2, k_cell, per0, per1, per2, L0,
                               L1, L2, n_targets, 0.0, 0.0, 0);
  if (A.n_cells > 0 && k_cell > 0) {
    const int blocks = blocks_for(static_cast<long long>(A.n_cells) * k_cell);
    kf::with_family<T, FAM>(
        res, norm, ndim,
        [&](const auto& kern) {
          using KF = std::decay_t<decltype(kern)>;
          if (ndim == 1)
            dust_deposit_kernel<T, 1, KF><<<blocks, kThreads, 0, stream>>>(
                ids, r, sc, pt, payload, dek, A, kern, out);
          else if (ndim == 2)
            dust_deposit_kernel<T, 2, KF><<<blocks, kThreads, 0, stream>>>(
                ids, r, sc, pt, payload, dek, A, kern, out);
          else
            dust_deposit_kernel<T, 3, KF><<<blocks, kThreads, 0, stream>>>(
                ids, r, sc, pt, payload, dek, A, kern, out);
        },
        normdrag);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dust_k23

// the C entry points of one kernel family (direct or tabulated by `res`),
// float32 and float64: dust_drag_sums_<family>_f32 and _f64,
// dust_drag_deposit_<family>_f32 and _f64
#define DUST_SUMS_ENTRY(NAME, T, FAM)                                       \
  extern "C" int NAME(const int* ids, int n_targets, const T* r,            \
                      const T* vec, const T* sc, const int* pt,             \
                      const T* dt, int ndim, int n0, int n1, int n2,        \
                      int k_cell, int per0, int per1, int per2, double L0,  \
                      double L1, double L2, double norm, double normdrag,   \
                      int res, int law, double coeff, double inv_coeff,     \
                      int test_particle, T* a, T* nrm, T* snd, T* divv,     \
                      int device, void* stream) {                           \
    return dust_k23::run_sums<T, FAM>(                                      \
        ids, n_targets, r, vec, sc, pt, dt, ndim, n0, n1, n2, k_cell, per0, \
        per1, per2, L0, L1, L2, norm, normdrag, res, law, coeff, inv_coeff, \
        test_particle, a, nrm, snd, divv, device, stream);                  \
  }

#define DUST_DEPOSIT_ENTRY(NAME, T, FAM)                                    \
  extern "C" int NAME(const int* ids, int n_targets, const T* r,            \
                      const T* sc, const int* pt, const T* payload,         \
                      const T* dek, int ndim, int n0, int n1, int n2,       \
                      int k_cell, int per0, int per1, int per2, double L0,  \
                      double L1, double L2, double norm, double normdrag,   \
                      int res, T* out, int device, void* stream) {          \
    return dust_k23::run_deposit<T, FAM>(                                   \
        ids, n_targets, r, sc, pt, payload, dek, ndim, n0, n1, n2, k_cell,  \
        per0, per1, per2, L0, L1, L2, norm, normdrag, res, out, device,     \
        stream);                                                            \
  }

// K23 and K24 with one family in float32 and float64
#define DUST_DRAG_FAMILY(FAMNAME, FAM)                                      \
  DUST_SUMS_ENTRY(dust_drag_sums_##FAMNAME##_f32, float, FAM)               \
  DUST_SUMS_ENTRY(dust_drag_sums_##FAMNAME##_f64, double, FAM)              \
  DUST_DEPOSIT_ENTRY(dust_drag_deposit_##FAMNAME##_f32, float, FAM)         \
  DUST_DEPOSIT_ENTRY(dust_drag_deposit_##FAMNAME##_f64, double, FAM)
