// K12 mfv_fluxes: MUSCL Godunov face fluxes of the meshless
// finite-volume scheme over the 27-cell stencil.
//
// Replaces gandalf_tpu/ops/mfv_grid27.py:fluxes_mfv_grid27 (:342-478,
// global timestep) with gandalf_tpu/ops/mfv.py:compute_godunov_fluxes
// (:671-819, MUSCL, Gizmo limiter) and hllc_flux (:553-645): there each
// of 27 shifted slices of a ghosted (cells, K, 45) table is broadcast to
// a (cells*K, K) pair block and every face quantity is an XLA array.
//
// Bound on the card: pair arithmetic and the neighbour's row.  One pass
// is about 4.6e8 pair candidates at 262,144 particles, of which some 60
// per particle lie within a support; each of those reads 45 values of the
// neighbour (position, h, number density, W, sound speed, a0, B, the
// gradients, the cell alphas and the bad-gradient flag) and costs a few
// hundred flops: the two psi vectors, two Gizmo-limited and half-step
// predicted face states, and an HLLC solve with a square root and a
// dozen divisions.
//
// Design: K2's layout, one block per cell and one thread per slot of K1's
// slot map.  The thread keeps its particle's row (with alpha * grad
// formed once) and its sums dQdt (5) and rdmdt_dot (3) in registers and
// walks the 27 neighbour cells; neighbour rows are read from global
// memory as the whole block reads the same row at the same time.  Each
// directed pair is evaluated once, for the target only, as the JAX
// package evaluates every pair from both sides: no atomics, and the sums
// are deterministic.  A pair beyond both supports has a zero face and is
// skipped.  dt is read on the device (no host sync).  Outputs are in
// particle order.  No shared-memory staging of neighbour rows yet: that
// is later work (see the register and spill counts in PERF.md).
#include <cuda_runtime.h>

#include "grid27.cuh"
#include "m4.cuh"
#include "mfv.cuh"

namespace {

using mfv::kNvar;

// columns of the packed per-particle table (ops/mfv_grid27.py:FLUX_COLS)
constexpr int kH = 0, kNdens = 1, kW = 2, kSound = 7, kA0 = 8, kB = 11,
              kGrad = 20, kAlpha = 35, kBad = 40, kCols = 41;

template <typename T>
__global__ void __launch_bounds__(128) mfv_fluxes_kernel(
    const int* __restrict__ ids, const T* __restrict__ r,
    const T* __restrict__ pk, const T* __restrict__ dt_ptr, Grid3 g, T norm,
    T gamma, T gm1, int zmf, T* __restrict__ dQdt_out,
    T* __restrict__ rdmdt_out) {
  const int c = blockIdx.x;
  const int K = g.K;
  int cc[3];
  cell_coords(g, c, cc);
  const T dt = *dt_ptr;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const int p = ids[static_cast<long long>(c) * K + i];
    if (p < 0) continue;
    const T* own = pk + kCols * p;
    const T xi = r[3 * p], yi = r[3 * p + 1], zi = r[3 * p + 2];
    const T invh_i = T(1) / max(own[kH], T(1e-30));
    const T vol_i = T(1) / max(own[kNdens], T(1e-300));
    const T sound_i = own[kSound];
    const bool bad_i = own[kBad] > T(0.5);
    T Wi[kNvar], gWi[kNvar * 3], Bi[9], a0i[3];
#pragma unroll
    for (int v = 0; v < kNvar; ++v) {
      Wi[v] = own[kW + v];
#pragma unroll
      for (int a = 0; a < 3; ++a)
        gWi[3 * v + a] = own[kAlpha + v] * own[kGrad + 3 * v + a];
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) Bi[k] = own[kB + k];
#pragma unroll
    for (int k = 0; k < 3; ++k) a0i[k] = own[kA0 + k];
    T dQ[kNvar] = {T(0), T(0), T(0), T(0), T(0)};
    T rdm[3] = {T(0), T(0), T(0)};
    for (int d = 0; d < 27; ++d) {
      int nc;
      T sh[3];
      if (!neighbour_cell<T>(g, cc, d, &nc, sh)) continue;
      const int* q0 = ids + static_cast<long long>(nc) * K;
      for (int j = 0; j < K; ++j) {
        const int q = q0[j];
        if (q < 0) continue;
        const T dr[3] = {(r[3 * q] + sh[0]) - xi, (r[3 * q + 1] + sh[1]) - yi,
                         (r[3 * q + 2] + sh[2]) - zi};
        const T d2 = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2];
        if (!(d2 > T(0))) continue;
        const T* pq = pk + kCols * q;
        const T invh_j = T(1) / pq[kH];
        const T drmag = sqrt(d2);
        const T s0_i = sqrt(d2 * (invh_i * invh_i)), s1_i = drmag * invh_i;
        const T s0_j = sqrt(d2 * (invh_j * invh_j)), s1_j = drmag * invh_j;
        if (s0_i >= T(2) && s1_i >= T(2) && s0_j >= T(2) && s1_j >= T(2))
          continue;  // beyond both supports the face area is zero
        const T vol_j = T(1) / max(pq[kNdens], T(1e-300));
        // psi-tilde face vectors (ComputeGodunovFlux:110-137)
        const T w0_i = invh_i * invh_i * invh_i * m4_w0<T>(s0_i, norm);
        const T w0_j = invh_j * invh_j * invh_j * m4_w0<T>(s0_j, norm);
        const T w1_i = invh_i * invh_i * invh_i * invh_i
                       * m4_w1<T>(s1_i, norm);
        const T w1_j = invh_j * invh_j * invh_j * invh_j
                       * m4_w1<T>(s1_j, norm);
        const bool bad_j = pq[kBad] > T(0.5);
        T A[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const T unit = dr[k] / drmag;
          const T psi_j =
              bad_i ? -unit * (w1_i * vol_i)
                    : (Bi[3 * k] * dr[0] + Bi[3 * k + 1] * dr[1]
                       + Bi[3 * k + 2] * dr[2]) * (w0_i * vol_i);
          const T psi_i =
              bad_j ? unit * (w1_j * vol_j)
                    : -(pq[kB + 3 * k] * dr[0] + pq[kB + 3 * k + 1] * dr[1]
                        + pq[kB + 3 * k + 2] * dr[2]) * (w0_j * vol_j);
          A[k] = vol_i * psi_j - vol_j * psi_i;
        }
        const T Amag = sqrt(A[0] * A[0] + A[1] * A[1] + A[2] * A[2]);
        if (!(Amag > T(0))) continue;
        const T an = max(Amag, T(1e-300));
        const T n[3] = {A[0] / an, A[1] / an, A[2] / an};
        T Wj[kNvar], gWj[kNvar * 3];
#pragma unroll
        for (int v = 0; v < kNvar; ++v) {
          Wj[v] = pq[kW + v];
#pragma unroll
          for (int a = 0; a < 3; ++a)
            gWj[3 * v + a] = pq[kAlpha + v] * pq[kGrad + 3 * v + a];
        }
        const T vface[3] = {T(0.5) * (Wi[0] + Wj[0]),
                            T(0.5) * (Wi[1] + Wj[1]),
                            T(0.5) * (Wi[2] + Wj[2])};
        const T half[3] = {T(0.5) * dr[0], T(0.5) * dr[1], T(0.5) * dr[2]};
        const T mhalf[3] = {-half[0], -half[1], -half[2]};
        const T fmag = sqrt(half[0] * half[0] + half[1] * half[1]
                            + half[2] * half[2]);
        const T ratio = fmag / max(drmag, T(1e-300));
        const T a0j[3] = {pq[kA0], pq[kA0 + 1], pq[kA0 + 2]};
        T Wl[kNvar], Wr[kNvar];
        mfv::face_state<T>(Wi, Wj, gWi, half, ratio, vface, sound_i, a0i, dt,
                           Wl);
        mfv::face_state<T>(Wj, Wi, gWj, mhalf, ratio, vface, pq[kSound], a0j,
                           dt, Wr);
        // positivity floors of the face states
        Wl[mfv::kRho] = max(Wl[mfv::kRho], T(1e-15));
        Wl[mfv::kP] = max(Wl[mfv::kP], T(1e-15));
        Wr[mfv::kRho] = max(Wr[mfv::kRho], T(1e-15));
        Wr[mfv::kP] = max(Wr[mfv::kP], T(1e-15));
        T flux[kNvar];
        mfv::hllc<T>(Wl, Wr, n, vface, gamma, gm1, zmf != 0, flux);
#pragma unroll
        for (int v = 0; v < kNvar; ++v) dQ[v] -= flux[v] * Amag;
        const T fm = flux[mfv::kRho] * Amag;
#pragma unroll
        for (int k = 0; k < 3; ++k) rdm[k] += dr[k] * fm;
      }
    }
#pragma unroll
    for (int v = 0; v < kNvar; ++v)
      dQdt_out[kNvar * static_cast<long long>(p) + v] = dQ[v];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      rdmdt_out[3 * static_cast<long long>(p) + k] = rdm[k];
  }
}

template <typename T>
int run_fluxes(const int* ids, const T* r, const T* pk, const T* dt, int n0,
               int n1, int n2, int k_cell, int per0, int per1, int per2,
               double L0, double L1, double L2, double norm, double gamma,
               int zmf, T* dQdt, T* rdmdt, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Grid3 g = {{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell};
  const int n_cells = n0 * n1 * n2;
  const int threads = slot_threads(k_cell) < 128 ? slot_threads(k_cell)
                                                 : 128;
  if (n_cells > 0 && k_cell > 0)
    mfv_fluxes_kernel<T><<<n_cells, threads, 0, stream>>>(
        ids, r, pk, dt, g, T(norm), T(gamma), T(gamma - 1.0), zmf, dQdt,
        rdmdt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define MFV_FLUXES_ENTRY(NAME, T)                                           \
  int NAME(const int* ids, const T* r, const T* pk, const T* dt, int n0,    \
           int n1, int n2, int k_cell, int per0, int per1, int per2,        \
           double L0, double L1, double L2, double norm, double gamma,      \
           int zmf, T* dQdt, T* rdmdt, int device, void* stream) {          \
    return run_fluxes<T>(ids, r, pk, dt, n0, n1, n2, k_cell, per0, per1,    \
                         per2, L0, L1, L2, norm, gamma, zmf, dQdt, rdmdt,   \
                         device, stream);                                   \
  }

MFV_FLUXES_ENTRY(mfv_fluxes_f32, float)
MFV_FLUXES_ENTRY(mfv_fluxes_f64, double)

}  // extern "C"
