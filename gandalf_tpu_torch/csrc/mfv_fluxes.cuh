// K12 mfv_fluxes: the Godunov face fluxes of the meshless finite-volume
// scheme over the 3^NDIM-cell stencil, in 1, 2 or 3 dims, in every mode
// of the JAX flux pass, with every smoothing kernel.  Each of
// mfv_fluxes_{hllc,exact}_{1,2,3}d_{m4,quintic,gaussian}.cu instantiates
// it for one Riemann solver (HLLC, or the exact one of
// riemann_exact.cuh), one NDIM and one kernel family, direct and
// tabulated, so that nvcc builds the eighteen in parallel.
//
// Replaces gandalf_tpu/ops/mfv_grid27.py:fluxes_mfv_grid27 (:342-478,
// global timestep and block mode) with gandalf_tpu/ops/mfv.py:
// compute_godunov_fluxes (:671-819), hllc_flux (:553-645) and exact_flux
// (:509): there each of
// the 3^ndim shifted slices of a ghosted (cells, K, columns) table is
// broadcast to a (cells*K, K) pair block and every face quantity is an
// XLA array.
//
// Bound on the card: pair arithmetic and the neighbour's row.  One pass
// is about 4.6e8 pair candidates at 262,144 particles in 3D, of which
// some 60 per particle lie within a support; each of those reads the
// neighbour's row (41 values in 3D, 26 in 2D, 15 in 1D: position, h,
// number density, W, sound speed, a0, B, the gradients, the cell alphas
// and the bad-gradient flag) and costs a few hundred operations: the two
// psi vectors, two reconstructed face states with their time
// derivatives, and a Riemann solve (HLLC: a square root and a dozen
// divisions; exact: 10 Newton steps of two pressure functions, a pow
// each where a side rarefies), twice under RK2.
//
// Design: K2's layout, one thread per slot of K1's slot map (one block
// per cell in 3D with K >= 32, else flat over (cell, slot)).  NDIM, the
// Riemann solver and the limiter class (the Gizmo clamp; the cell
// alphas, which the caller packs as 1 for null; zeroslope's none) are
// template parameters; the time scheme (the MUSCL half step, or RK2's mean of
// the fluxes of the states before and after a full step, each floored
// alone), static particles (a face velocity of 0) and zero mass flux
// are runtime flags: they touch a few lines.  The thread keeps its
// particle's row (with the limited gradient formed once) and its sums
// dQdt (nvar) and rdmdt_dot (NDIM) in registers and walks the
// neighbour cells, ending a cell's sweep at its first empty slot.  Each
// directed pair is evaluated once, for the target only, as the JAX
// package evaluates every pair from both sides: no atomics, and the sums
// are deterministic.  A pair beyond both supports has a zero face and is
// skipped.  dt is read on the device (no host sync).  Outputs are in
// particle order.  No shared-memory staging of neighbour rows yet: that
// is later work (see the register and spill counts in PERF.md).
//
// The smoothing kernel (kernel_family.cuh) is a template parameter, as
// the limiter class is: W comes through the s^2 form (w0_s2 at d^2 /
// h^2) and W' through the s form (w1 at |dr| / h), each side at its own
// h, as ops/mfv.py's flux terms take them; a pair is skipped where all
// four vanish.  Any kernel but the direct M4 sums d^2 in the plain
// version's rounded steps (kExactD2), so that a table index comes from
// the plain version's d^2.
//
// Block-timestep mode (MUSCL only; ops/mfv.py:761-783, :815-819) is a
// template parameter, so that the global-dt kernels keep their code and
// registers (a runtime mode branch slowed K6/K7, PERF.md): the table
// gains two columns, each particle's own step dt_own and a start flag;
// a pair's half step takes dt_pair = min(dt_own_i, dt_own_j) in place
// of dt, and besides dQdt and rdmdt_dot the thread sums the committed
// exchange dQ -= f |A| dt_pair and rdmdt += dr f_rho |A| dt_pair over
// the pairs whose either member starts a step.
#pragma once

#include <cuda_runtime.h>

#include "grid27.cuh"
#include "kernel_family.cuh"
#include "mfv.cuh"
#include "riemann_exact.cuh"

namespace mfv_k12 {

enum Riemann { kHllc = 0, kExact = 1 };

template <typename T>
struct FluxArgs {
  T gamma, gm1;
  mfv::ExactConsts<T> ec;
  bool zmf, rk2, stat;
};

// columns of the packed per-particle table (ops/mfv_grid27.py:flux_cols),
// with BLOCK the own step and the start flag after them
template <int NDIM, bool BLOCK = false>
struct Cols {
  static constexpr int kNvar = NDIM + 2;
  static constexpr int kH = 0, kNdens = 1, kW = 2;
  static constexpr int kSound = kW + kNvar;
  static constexpr int kA0 = kSound + 1;
  static constexpr int kB = kA0 + NDIM;
  static constexpr int kGrad = kB + NDIM * NDIM;
  static constexpr int kAlpha = kGrad + kNvar * NDIM;
  static constexpr int kBad = kAlpha + kNvar;
  static constexpr int kDtOwn = kBad + 1;
  static constexpr int kStart = kBad + 2;
  static constexpr int kCount = kBad + (BLOCK ? 3 : 1);
};

template <typename T, int NDIM, int RIEMANN>
__device__ __forceinline__ void solve(const T Wl[NDIM + 2],
                                      const T Wr[NDIM + 2], const T n[NDIM],
                                      const T vface[NDIM],
                                      const FluxArgs<T>& a,
                                      T flux[NDIM + 2]) {
  if (RIEMANN == kExact)
    mfv::exact<T, NDIM>(Wl, Wr, n, vface, a.ec, a.zmf, flux);
  else
    mfv::hllc<T, NDIM>(Wl, Wr, n, vface, a.gamma, a.gm1, a.zmf, flux);
}

// the limited gradient of one particle's row: alpha * grad; unused
// under zeroslope
template <typename T, int NDIM, int LIM>
__device__ __forceinline__ void limited_gradient(const T* row,
                                                 T gW[(NDIM + 2) * NDIM]) {
  using C = Cols<NDIM>;
#pragma unroll
  for (int v = 0; v < C::kNvar; ++v)
#pragma unroll
    for (int a = 0; a < NDIM; ++a) {
      const T gr = row[C::kGrad + NDIM * v + a];
      gW[NDIM * v + a] =
          LIM == mfv::kZeroSlope ? T(0) : row[C::kAlpha + v] * gr;
    }
}

template <typename T, int NDIM, int RIEMANN, int LIM, bool BLOCK, class KF>
__device__ __forceinline__ void flux_slot(
    const int* __restrict__ ids, const T* __restrict__ r,
    const T* __restrict__ pk, const Grid3& g, int c, int i, T dt,
    const KF& kern, const FluxArgs<T>& a, T* __restrict__ dQdt_out,
    T* __restrict__ rdmdt_out, T* __restrict__ dQ_out,
    T* __restrict__ rdm_out) {
  using C = Cols<NDIM, BLOCK>;
  constexpr int kNvar = C::kNvar;
  constexpr int kRho = mfv::Dims<NDIM>::kRho;
  const int K = g.K;
  const int p = ids[static_cast<long long>(c) * K + i];
  if (p < 0) return;
  int cc[3];
  cell_coords(g, c, cc);
  const T* own = pk + C::kCount * static_cast<long long>(p);
  T xi[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) xi[k] = r[NDIM * p + k];
  const T invh_i = T(1) / max(own[C::kH], T(1e-30));
  const T vol_i = T(1) / max(own[C::kNdens], T(1e-300));
  const T sound_i = own[C::kSound];
  const bool bad_i = own[C::kBad] > T(0.5);
  T hn_i = invh_i;
#pragma unroll
  for (int k = 1; k < NDIM; ++k) hn_i *= invh_i;
  T Wi[kNvar], gWi[kNvar * NDIM], Bi[NDIM * NDIM], a0i[NDIM];
#pragma unroll
  for (int v = 0; v < kNvar; ++v) Wi[v] = own[C::kW + v];
  limited_gradient<T, NDIM, LIM>(own, gWi);
#pragma unroll
  for (int k = 0; k < NDIM * NDIM; ++k) Bi[k] = own[C::kB + k];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) a0i[k] = own[C::kA0 + k];
  T dQ[kNvar], rdm[NDIM];
  // block mode: the committed exchange (unused otherwise)
  T dQc[BLOCK ? kNvar : 1], rdmc[BLOCK ? NDIM : 1];
#pragma unroll
  for (int v = 0; v < kNvar; ++v) dQ[v] = T(0);
#pragma unroll
  for (int k = 0; k < NDIM; ++k) rdm[k] = T(0);
  T dt_i = T(0);
  bool start_i = false;
  if (BLOCK) {
    dt_i = own[C::kDtOwn];
    start_i = own[C::kStart] > T(0.5);
#pragma unroll
    for (int v = 0; v < (BLOCK ? kNvar : 1); ++v) dQc[v] = T(0);
#pragma unroll
    for (int k = 0; k < (BLOCK ? NDIM : 1); ++k) rdmc[k] = T(0);
  }
  for (int d = 0; d < Stencil<NDIM>::kSize; ++d) {
    int nc;
    T sh[3];
    if (!neighbour_cell<T, NDIM>(g, cc, d, &nc, sh)) continue;
    const int* q0 = ids + static_cast<long long>(nc) * K;
    for (int j = 0; j < K; ++j) {
      const int q = q0[j];
      if (q < 0) break;
      T dr[NDIM];
      T d2 = T(0);
#pragma unroll
      for (int k = 0; k < NDIM; ++k) {
        dr[k] = (r[NDIM * q + k] + sh[k]) - xi[k];
        if (KF::kExactD2)
          d2 = kf::add(d2, kf::mul(dr[k], dr[k]));
        else
          d2 += dr[k] * dr[k];
      }
      if (!(d2 > T(0))) continue;
      const T* pq = pk + C::kCount * static_cast<long long>(q);
      const T invh_j = T(1) / pq[C::kH];
      const T drmag = sqrt(d2);
      const T ssq_i = d2 * (invh_i * invh_i), s1_i = drmag * invh_i;
      const T ssq_j = d2 * (invh_j * invh_j), s1_j = drmag * invh_j;
      if (!kern.in_support_s2(ssq_i) && !kern.in_support(s1_i)
          && !kern.in_support_s2(ssq_j) && !kern.in_support(s1_j))
        continue;  // beyond both supports the face area is zero
      const T vol_j = T(1) / max(pq[C::kNdens], T(1e-300));
      T hn_j = invh_j;
#pragma unroll
      for (int k = 1; k < NDIM; ++k) hn_j *= invh_j;
      // psi-tilde face vectors (ComputeGodunovFlux:110-137)
      const T w0_i = hn_i * kern.w0_s2(ssq_i);
      const T w0_j = hn_j * kern.w0_s2(ssq_j);
      const T w1_i = hn_i * invh_i * kern.w1(s1_i);
      const T w1_j = hn_j * invh_j * kern.w1(s1_j);
      const bool bad_j = pq[C::kBad] > T(0.5);
      T A[NDIM];
#pragma unroll
      for (int k = 0; k < NDIM; ++k) {
        const T unit = dr[k] / drmag;
        T bi = Bi[NDIM * k] * dr[0], bj = pq[C::kB + NDIM * k] * dr[0];
#pragma unroll
        for (int b = 1; b < NDIM; ++b) {
          bi += Bi[NDIM * k + b] * dr[b];
          bj += pq[C::kB + NDIM * k + b] * dr[b];
        }
        const T psi_j = bad_i ? -unit * (w1_i * vol_i) : bi * (w0_i * vol_i);
        const T psi_i = bad_j ? unit * (w1_j * vol_j) : -bj * (w0_j * vol_j);
        A[k] = vol_i * psi_j - vol_j * psi_i;
      }
      const T Amag = sqrt(mfv::dot<T, NDIM>(A, A));
      if (!(Amag > T(0))) continue;
      const T an = max(Amag, T(1e-300));
      T n[NDIM], Wj[kNvar], gWj[kNvar * NDIM], vface[NDIM], half[NDIM],
          mhalf[NDIM], a0j[NDIM];
#pragma unroll
      for (int k = 0; k < NDIM; ++k) n[k] = A[k] / an;
#pragma unroll
      for (int v = 0; v < kNvar; ++v) Wj[v] = pq[C::kW + v];
      limited_gradient<T, NDIM, LIM>(pq, gWj);
#pragma unroll
      for (int k = 0; k < NDIM; ++k) {
        vface[k] = a.stat ? T(0) : T(0.5) * (Wi[k] + Wj[k]);
        half[k] = T(0.5) * dr[k];
        mhalf[k] = -half[k];
        a0j[k] = pq[C::kA0 + k];
      }
      const T fmag = sqrt(mfv::dot<T, NDIM>(half, half));
      const T ratio = fmag / max(drmag, T(1e-300));
      T Wl[kNvar], Wr[kNvar], Wdl[kNvar], Wdr[kNvar], flux[kNvar];
      mfv::face_state<T, NDIM, LIM>(Wi, Wj, gWi, half, ratio, vface,
                                    sound_i, a0i, Wl, Wdl);
      mfv::face_state<T, NDIM, LIM>(Wj, Wi, gWj, mhalf, ratio, vface,
                                    pq[C::kSound], a0j, Wr, Wdr);
      // the half step's length: dt, or the pair's in block mode
      const T dtp = BLOCK ? min(dt_i, pq[C::kDtOwn]) : dt;
      if (!BLOCK && a.rk2) {
        // Heun: the states as they are, then advanced a full dt
        T Wl2[kNvar], Wr2[kNvar], f2[kNvar];
#pragma unroll
        for (int v = 0; v < kNvar; ++v) {
          Wl2[v] = Wl[v] + Wdl[v] * dt;
          Wr2[v] = Wr[v] + Wdr[v] * dt;
        }
        mfv::sanitise<T, NDIM>(Wl);
        mfv::sanitise<T, NDIM>(Wr);
        mfv::sanitise<T, NDIM>(Wl2);
        mfv::sanitise<T, NDIM>(Wr2);
        solve<T, NDIM, RIEMANN>(Wl, Wr, n, vface, a, flux);
        solve<T, NDIM, RIEMANN>(Wl2, Wr2, n, vface, a, f2);
#pragma unroll
        for (int v = 0; v < kNvar; ++v) flux[v] = T(0.5) * (flux[v] + f2[v]);
      } else {
        // MUSCL: the half-step prediction
#pragma unroll
        for (int v = 0; v < kNvar; ++v) {
          Wl[v] = Wl[v] + T(0.5) * Wdl[v] * dtp;
          Wr[v] = Wr[v] + T(0.5) * Wdr[v] * dtp;
        }
        mfv::sanitise<T, NDIM>(Wl);
        mfv::sanitise<T, NDIM>(Wr);
        solve<T, NDIM, RIEMANN>(Wl, Wr, n, vface, a, flux);
      }
#pragma unroll
      for (int v = 0; v < kNvar; ++v) dQ[v] -= flux[v] * Amag;
      const T fm = flux[kRho] * Amag;
#pragma unroll
      for (int k = 0; k < NDIM; ++k) rdm[k] += dr[k] * fm;
      if (BLOCK && (start_i || pq[C::kStart] > T(0.5))) {
#pragma unroll
        for (int v = 0; v < (BLOCK ? kNvar : 1); ++v)
          dQc[v] -= (flux[v] * Amag) * dtp;
        const T fmdt = fm * dtp;
#pragma unroll
        for (int k = 0; k < (BLOCK ? NDIM : 1); ++k) rdmc[k] += dr[k] * fmdt;
      }
    }
  }
#pragma unroll
  for (int v = 0; v < kNvar; ++v)
    dQdt_out[kNvar * static_cast<long long>(p) + v] = dQ[v];
#pragma unroll
  for (int k = 0; k < NDIM; ++k)
    rdmdt_out[NDIM * static_cast<long long>(p) + k] = rdm[k];
  if (BLOCK) {
#pragma unroll
    for (int v = 0; v < (BLOCK ? kNvar : 1); ++v)
      dQ_out[kNvar * static_cast<long long>(p) + v] = dQc[v];
#pragma unroll
    for (int k = 0; k < (BLOCK ? NDIM : 1); ++k)
      rdm_out[NDIM * static_cast<long long>(p) + k] = rdmc[k];
  }
}

template <typename T, int NDIM, int RIEMANN, int LIM, bool BLOCK, class KF>
__global__ void __launch_bounds__(128) mfv_fluxes_kernel(
    const int* __restrict__ ids, const T* __restrict__ r,
    const T* __restrict__ pk, const T* __restrict__ dt_ptr, Grid3 g,
    int n_cells, bool flat, KF kern, FluxArgs<T> a, T* __restrict__ dQdt_out,
    T* __restrict__ rdmdt_out, T* __restrict__ dQ_out,
    T* __restrict__ rdm_out) {
  const T dt = *dt_ptr;
  if (flat) {
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
    if (t >= static_cast<long long>(n_cells) * g.K) return;
    flux_slot<T, NDIM, RIEMANN, LIM, BLOCK>(
        ids, r, pk, g, static_cast<int>(t / g.K), static_cast<int>(t % g.K),
        dt, kern, a, dQdt_out, rdmdt_out, dQ_out, rdm_out);
    return;
  }
  for (int i = threadIdx.x; i < g.K; i += blockDim.x)
    flux_slot<T, NDIM, RIEMANN, LIM, BLOCK>(ids, r, pk, g, blockIdx.x, i, dt,
                                            kern, a, dQdt_out, rdmdt_out,
                                            dQ_out, rdm_out);
}

template <typename T, int NDIM, int RIEMANN, int LIM, bool BLOCK, class KF>
void launch(const int* ids, const T* r, const T* pk, const T* dt,
            const Grid3& g, int n_cells, bool flat, const KF& kern,
            const FluxArgs<T>& a, T* dQdt, T* rdmdt, T* dQ, T* rdm,
            cudaStream_t stream) {
  constexpr int kThreads = 128;
  const long long slots = static_cast<long long>(n_cells) * g.K;
  const int blocks = flat ? static_cast<int>((slots + kThreads - 1)
                                             / kThreads)
                          : n_cells;
  const int threads = flat ? kThreads
                           : (slot_threads(g.K) < kThreads
                                  ? slot_threads(g.K) : kThreads);
  mfv_fluxes_kernel<T, NDIM, RIEMANN, LIM, BLOCK, KF>
      <<<blocks, threads, 0, stream>>>(ids, r, pk, dt, g, n_cells, flat,
                                       kern, a, dQdt, rdmdt, dQ, rdm);
}

template <typename T, int NDIM, int RIEMANN, bool BLOCK, class KF>
void launch_limiter(int limiter, const int* ids, const T* r, const T* pk,
                    const T* dt, const Grid3& g, int n_cells, bool flat,
                    const KF& kern, const FluxArgs<T>& a, T* dQdt, T* rdmdt,
                    T* dQ, T* rdm, cudaStream_t stream) {
  if (limiter == mfv::kGizmo)
    launch<T, NDIM, RIEMANN, mfv::kGizmo, BLOCK>(ids, r, pk, dt, g, n_cells,
                                                 flat, kern, a, dQdt, rdmdt,
                                                 dQ, rdm, stream);
  else if (limiter == mfv::kCell)
    launch<T, NDIM, RIEMANN, mfv::kCell, BLOCK>(ids, r, pk, dt, g, n_cells,
                                                flat, kern, a, dQdt, rdmdt,
                                                dQ, rdm, stream);
  else
    launch<T, NDIM, RIEMANN, mfv::kZeroSlope, BLOCK>(ids, r, pk, dt, g,
                                                     n_cells, flat, kern, a,
                                                     dQdt, rdmdt, dQ, rdm,
                                                     stream);
}

template <typename T, int NDIM, int RIEMANN, class KF>
void launch_mode(int block, int limiter, const int* ids, const T* r,
                 const T* pk, const T* dt, const Grid3& g, int n_cells,
                 bool flat, const KF& kern, const FluxArgs<T>& a, T* dQdt,
                 T* rdmdt, T* dQ, T* rdm, cudaStream_t stream) {
  if (block)
    launch_limiter<T, NDIM, RIEMANN, true>(limiter, ids, r, pk, dt, g,
                                           n_cells, flat, kern, a, dQdt,
                                           rdmdt, dQ, rdm, stream);
  else
    launch_limiter<T, NDIM, RIEMANN, false>(limiter, ids, r, pk, dt, g,
                                            n_cells, flat, kern, a, dQdt,
                                            rdmdt, nullptr, nullptr, stream);
}

template <typename T, int RIEMANN, int NDIM, int FAM>
int run_fluxes(const int* ids, const T* r, const T* pk, const T* dt,
               int n0, int n1, int n2, int k_cell, int per0, int per1,
               int per2, double L0, double L1, double L2, double norm,
               int res, double gamma, int zmf, int limiter, int rk2,
               int stat, int block, int mapping, T* dQdt, T* rdmdt, T* dQ,
               T* rdm, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (limiter < 0 || limiter > 2 || (block && (rk2 || !dQ || !rdm)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Grid3 g = {{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell};
  const int n_cells = n0 * n1 * n2;
  const bool flat = slot_mapping_flat(mapping, NDIM, k_cell);
  const FluxArgs<T> a = {T(gamma), T(gamma - 1.0),
                         mfv::exact_consts<T>(gamma), zmf != 0, rk2 != 0,
                         stat != 0};
  if (n_cells > 0 && k_cell > 0) {
    // the family's kernel, direct (res 0) or tabulated
    if (res > 0)
      launch_mode<T, NDIM, RIEMANN>(
          block, limiter, ids, r, pk, dt, g, n_cells, flat,
          kf::make_kernel<kf::Kernel<T, FAM, true>>(norm, NDIM, res), a,
          dQdt, rdmdt, dQ, rdm, stream);
    else
      launch_mode<T, NDIM, RIEMANN>(
          block, limiter, ids, r, pk, dt, g, n_cells, flat,
          kf::make_kernel<kf::Kernel<T, FAM, false>>(norm, NDIM, 0), a,
          dQdt, rdmdt, dQ, rdm, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mfv_k12

// the C entry points of one Riemann solver, one NDIM and one kernel
// family (direct or tabulated by `res`), float32 and float64:
// mfv_fluxes_<solver>_<NDIM>d_<family>_f32 and _f64
#define MFV_FLUXES_ENTRY(NAME, T, RIEMANN, NDIM, FAM)                       \
  extern "C" int NAME(const int* ids, const T* r, const T* pk, const T* dt, \
                      int n0, int n1, int n2, int k_cell, int per0,         \
                      int per1, int per2, double L0, double L1, double L2,  \
                      double norm, int res, double gamma, int zmf,          \
                      int limiter, int rk2, int stat, int block,            \
                      int mapping, T* dQdt, T* rdmdt, T* dQ, T* rdm,        \
                      int device, void* stream) {                           \
    return mfv_k12::run_fluxes<T, RIEMANN, NDIM, FAM>(                      \
        ids, r, pk, dt, n0, n1, n2, k_cell, per0, per1, per2, L0, L1, L2,   \
        norm, res, gamma, zmf, limiter, rk2, stat, block, mapping, dQdt,    \
        rdmdt, dQ, rdm, device, stream);                                    \
  }

// one Riemann solver, NDIM and family in float32 and float64
#define MFV_FLUXES_FAMILY(SOLVER, RIEMANN, NDIM, FAMNAME, FAM)              \
  MFV_FLUXES_ENTRY(mfv_fluxes_##SOLVER##_##NDIM##d_##FAMNAME##_f32, float,  \
                   RIEMANN, NDIM, FAM)                                      \
  MFV_FLUXES_ENTRY(mfv_fluxes_##SOLVER##_##NDIM##d_##FAMNAME##_f64, double, \
                   RIEMANN, NDIM, FAM)
