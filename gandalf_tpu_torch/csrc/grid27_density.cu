// K2 grid27_density: the grad-h h-rho iteration over the 3^NDIM-cell
// stencil, in 1, 2 or 3 dims.
//
// Replaces gandalf_tpu/ops/sph_grid27.py:density_grid27 (:359-505), whose
// slabs of cells iterate in lockstep (lax.while_loop) over a concatenated
// (cells, K, 3^ndim K) pair table built from ghost-layer copies.
//
// Bound on the card: pair arithmetic and the load of each neighbour.  At
// 262,144 particles in 3D one sweep is about 4.6e8 pair evaluations
// (1,755 candidates per particle), and a particle needs a few sweeps to
// converge; every pair costs a square root and three kernel polynomials.
// In 2D a particle tests 9 K candidates, in 1D 3 K.
//
// Design: one thread per slot (grid27.cuh: one block per cell in 3D
// with K >= 32, else threads over the flattened (cell, slot) index),
// NDIM a template parameter.  A thread runs its own particle's iteration in
// registers: every step sweeps the neighbour cells (wrapped indices,
// positions shifted by the box length on periodic dims, no ghost
// copies), sums m W, the Omega term and the zeta term, then takes a
// fixed-point step (steps 0..29) or a bisection step (30..149), until
// |h - h(rho)| / h < h_converge.  A converged particle stops; the JAX
// lockstep loop keeps a converged lane's h frozen and re-evaluates the
// same sums, so the two agree.  A slot outside the optional `target`
// mask (a mirror image: it takes its parent's fields afterwards) is a
// neighbour only: it iterates nothing and comes back with zero sums,
// converged.  Outputs are the sums at the final h and the converged
// flag; the per-slot finish (h from rho, invomega, zeta, hfactor,
// overflow) stays elementwise torch.  No shared-memory staging yet:
// that is later work.
#include <cuda_runtime.h>

#include "grid27.cuh"
#include "m4.cuh"

namespace {

constexpr int kIterFixedPoint = 30;
constexpr int kIterMax = 150;

template <typename T, int NDIM>
__device__ __forceinline__ void density_slot(
    const T* __restrict__ r, const T* __restrict__ m,
    const T* __restrict__ h, const unsigned char* __restrict__ fill,
    const unsigned char* __restrict__ target, const Grid3& g, int c, int i,
    T norm, T h_fac, T h_converge, T h_lo, T h_hi, T* __restrict__ rho_out,
    T* __restrict__ invom_out, T* __restrict__ zeta_out,
    unsigned char* __restrict__ done_out) {
  const int K = g.K;
  const long long p = static_cast<long long>(c) * K + i;
  if (!fill[p] || (target != nullptr && !target[p])) {
    rho_out[p] = T(0);
    invom_out[p] = T(0);
    zeta_out[p] = T(0);
    done_out[p] = 1;
    return;
  }
  int cc[3];
  cell_coords(g, c, cc);
  T xi[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) xi[k] = r[NDIM * p + k];
  const T nd = T(NDIM);
  const T invndim = T(1.0 / NDIM);
  const T m_t = max(m[p], T(1e-30));
  T hh = min(max(h[p], h_lo), h_hi);
  T lo = T(0), hi = h_hi;
  T rho = T(0), invom = T(0), zeta = T(0);
  bool conv = false;
  for (int it = 0; it < kIterMax; ++it) {
    const T invh = T(1) / hh;
    const T invhsqd = invh * invh;
    T s_rho = T(0), s_om = T(0), s_zeta = T(0);
    for (int d = 0; d < Stencil<NDIM>::kSize; ++d) {
      int nc;
      T sh[3];
      if (!neighbour_cell<T, NDIM>(g, cc, d, &nc, sh)) continue;
      const long long q0 = static_cast<long long>(nc) * K;
      for (int j = 0; j < K; ++j) {
        const long long q = q0 + j;
        if (!fill[q]) continue;
        T d2 = T(0);
#pragma unroll
        for (int k = 0; k < NDIM; ++k) {
          const T dk = (r[NDIM * q + k] + sh[k]) - xi[k];
          d2 += dk * dk;
        }
        const T s = sqrt(d2 * invhsqd);
        if (s >= T(2)) continue;  // every M4 term is zero there
        const T mj = m[q];
        s_rho += mj * m4_w0<T>(s, norm);
        s_om += mj * m4_womega<T>(s, norm, nd);
        s_zeta += mj * m4_wzeta<T>(s);
      }
    }
    T hfac = invh;
#pragma unroll
    for (int k = 1; k < NDIM; ++k) hfac *= invh;
    rho = s_rho * hfac;
    invom = s_om * hfac * invh;
    zeta = s_zeta * invhsqd;
    const T h_target = h_fac * pow(m_t / max(rho, T(1e-300)), invndim);
    conv = (rho > T(0)) && (fabs(hh - h_target) / hh < h_converge);
    if (conv) break;
    const bool too_big = (rho < T(1e-30)) || (hh > h_target);
    if (it >= kIterFixedPoint) {
      if (too_big)
        hi = hh;
      else
        lo = hh;
    }
    const T h_new = it < kIterFixedPoint ? h_target : T(0.5) * (lo + hi);
    hh = min(max(h_new, h_lo), h_hi);
  }
  rho_out[p] = rho;
  invom_out[p] = invom;
  zeta_out[p] = zeta;
  done_out[p] = conv ? 1 : 0;
}

template <typename T, int NDIM, bool kFlat>
__global__ void __launch_bounds__(256) grid27_density_kernel(
    const T* __restrict__ r, const T* __restrict__ m,
    const T* __restrict__ h, const unsigned char* __restrict__ fill,
    const unsigned char* __restrict__ target, Grid3 g, int n_cells, T norm,
    T h_fac, T h_converge, T h_lo, T h_hi, T* __restrict__ rho_out,
    T* __restrict__ invom_out, T* __restrict__ zeta_out,
    unsigned char* __restrict__ done_out) {
  if (kFlat) {
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
    if (t >= static_cast<long long>(n_cells) * g.K) return;
    density_slot<T, NDIM>(r, m, h, fill, target, g,
                          static_cast<int>(t / g.K),
                          static_cast<int>(t % g.K), norm, h_fac,
                          h_converge, h_lo, h_hi, rho_out, invom_out,
                          zeta_out, done_out);
    return;
  }
  for (int i = threadIdx.x; i < g.K; i += blockDim.x)
    density_slot<T, NDIM>(r, m, h, fill, target, g, blockIdx.x, i, norm,
                          h_fac, h_converge, h_lo, h_hi, rho_out, invom_out,
                          zeta_out, done_out);
}

template <typename T, int NDIM, bool kFlat>
void launch_density(const T* r, const T* m, const T* h,
                    const unsigned char* fill, const unsigned char* target,
                    const Grid3& g, int n_cells, T norm, T h_fac,
                    T h_converge, T h_lo, T h_hi, T* rho, T* invom, T* zeta,
                    unsigned char* done, cudaStream_t stream) {
  const long long slots = static_cast<long long>(n_cells) * g.K;
  const int blocks = kFlat ? static_cast<int>((slots + kFlatThreads - 1)
                                              / kFlatThreads)
                           : n_cells;
  const int threads = kFlat ? kFlatThreads : slot_threads(g.K);
  grid27_density_kernel<T, NDIM, kFlat><<<blocks, threads, 0, stream>>>(
      r, m, h, fill, target, g, n_cells, norm, h_fac, h_converge, h_lo,
      h_hi, rho, invom, zeta, done);
}

template <typename T, int NDIM>
void launch_density_ndim(const T* r, const T* m, const T* h,
                         const unsigned char* fill,
                         const unsigned char* target, const Grid3& g,
                         int n_cells, T norm, T h_fac, T h_converge, T h_lo,
                         T h_hi, T* rho, T* invom, T* zeta,
                         unsigned char* done, bool flat,
                         cudaStream_t stream) {
  if (flat)
    launch_density<T, NDIM, true>(r, m, h, fill, target, g, n_cells, norm,
                                  h_fac, h_converge, h_lo, h_hi, rho, invom,
                                  zeta, done, stream);
  else
    launch_density<T, NDIM, false>(r, m, h, fill, target, g, n_cells, norm,
                                   h_fac, h_converge, h_lo, h_hi, rho,
                                   invom, zeta, done, stream);
}

template <typename T>
int run_density(const T* r, const T* m, const T* h,
                const unsigned char* fill, const unsigned char* target,
                int ndim, int n0, int n1, int n2, int k_cell, int per0,
                int per1, int per2, double L0, double L1, double L2,
                double norm, double h_fac, double h_converge, double hmax,
                T* rho, T* invom, T* zeta, unsigned char* done, int mapping,
                int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ndim < 1 || ndim > 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Grid3 g = {{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell};
  const int n_cells = n0 * n1 * n2;
  const bool flat = slot_mapping_flat(mapping, ndim, k_cell);
  if (n_cells > 0 && k_cell > 0) {
    // bounds as the JAX code forms them: in double, then cast
    const T args[] = {T(norm), T(h_fac), T(h_converge), T(1e-6 * hmax),
                      T(hmax)};
    if (ndim == 1)
      launch_density_ndim<T, 1>(r, m, h, fill, target, g, n_cells, args[0],
                                args[1], args[2], args[3], args[4], rho,
                                invom, zeta, done, flat, stream);
    else if (ndim == 2)
      launch_density_ndim<T, 2>(r, m, h, fill, target, g, n_cells, args[0],
                                args[1], args[2], args[3], args[4], rho,
                                invom, zeta, done, flat, stream);
    else
      launch_density_ndim<T, 3>(r, m, h, fill, target, g, n_cells, args[0],
                                args[1], args[2], args[3], args[4], rho,
                                invom, zeta, done, flat, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define GRID27_DENSITY_ENTRY(NAME, T)                                       \
  int NAME(const T* r, const T* m, const T* h, const unsigned char* fill,   \
           const unsigned char* target, int ndim, int n0, int n1, int n2,   \
           int k_cell, int per0, int per1, int per2, double L0, double L1,  \
           double L2, double norm, double h_fac, double h_converge,         \
           double hmax, T* rho, T* invom, T* zeta, unsigned char* done,     \
           int mapping, int device, void* stream) {                         \
    return run_density<T>(r, m, h, fill, target, ndim, n0, n1, n2, k_cell,  \
                          per0, per1, per2, L0, L1, L2, norm, h_fac,        \
                          h_converge, hmax, rho, invom, zeta, done,         \
                          mapping, device, stream);                         \
  }

GRID27_DENSITY_ENTRY(grid27_density_f32, float)
GRID27_DENSITY_ENTRY(grid27_density_f64, double)

}  // extern "C"
