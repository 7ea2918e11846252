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
//
// The smoothing kernel (M4, quintic or gaussian, direct or tabulated:
// kernel_family.cuh) is a template parameter; a pair counts where the
// family's density terms do not all vanish (s < kernrange, or for a
// tabulated kernel s^2 < kernrange^2, JAX's w0_s2 cut).  Any kernel but
// the direct M4 sums d^2 in the plain version's rounded steps (kExactD2),
// so that s^2, and a table index, come from the same d^2.  At kernrange
// 3 (quintic, gaussian) and the same h_fac a 3D particle meets (3/2)^3 =
// 3.4 times M4's candidates and neighbours.
//
// The distributed pass (gandalf_tpu/parallel/halo.py:
// hydro_pass_grid27_sharded, parallel/dist.py:dist_hydro_pass) runs the
// same kernel on a shard's ghosted slab: the stencil is qz rows deep
// along dim 0 (neighbour_cell_q, a template instance of its own for
// qz > 1; qz = 1 is the single-device stencil)
// and the launch covers the cells of a run-time window of dim-0 rows
// [row0, row0 + nrows), the shard's own; the halo rows are neighbours
// only and their outputs are not written.
#include <cuda_runtime.h>

#include "grid27.cuh"
#include "kernel_family.cuh"

namespace {

constexpr int kIterFixedPoint = 30;
constexpr int kIterMax = 150;

template <typename T, int NDIM, bool kDeep, class KF>
__device__ __forceinline__ void density_slot(
    const T* __restrict__ r, const T* __restrict__ m,
    const T* __restrict__ h, const unsigned char* __restrict__ fill,
    const unsigned char* __restrict__ target, const Grid3& g, int c, int i,
    const KF& kern, T h_fac, T h_converge, T h_lo, T h_hi,
    T* __restrict__ rho_out,
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
    // qz = 1 keeps the compile-time 3^NDIM stencil: a run-time bound
    // slowed M4 at the 64^3 box by 5% on an H100 (time_grid27)
    const int n_sh = kDeep ? stencil_size<NDIM>(g) : Stencil<NDIM>::kSize;
    for (int d = 0; d < n_sh; ++d) {
      int nc;
      T sh[3];
      if (kDeep ? !neighbour_cell_q<T, NDIM>(g, cc, d, &nc, sh)
                : !neighbour_cell<T, NDIM>(g, cc, d, &nc, sh))
        continue;
      const long long q0 = static_cast<long long>(nc) * K;
      for (int j = 0; j < K; ++j) {
        const long long q = q0 + j;
        if (!fill[q]) continue;
        T d2 = T(0);
#pragma unroll
        for (int k = 0; k < NDIM; ++k) {
          const T dk = (r[NDIM * q + k] + sh[k]) - xi[k];
          if (KF::kExactD2)
            d2 = kf::add(d2, kf::mul(dk, dk));
          else
            d2 += dk * dk;
        }
        T w0, wom, wz;
        // every term is zero beyond the support
        if (!kern.density(d2 * invhsqd, &w0, &wom, &wz)) continue;
        const T mj = m[q];
        s_rho += mj * w0;
        s_om += mj * wom;
        s_zeta += mj * wz;
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

template <typename T, int NDIM, bool kFlat, bool kDeep, class KF>
__global__ void __launch_bounds__(256) grid27_density_kernel(
    const T* __restrict__ r, const T* __restrict__ m,
    const T* __restrict__ h, const unsigned char* __restrict__ fill,
    const unsigned char* __restrict__ target, Grid3 g, int c0, int n_cells,
    KF kern, T h_fac, T h_converge, T h_lo, T h_hi, T* __restrict__ rho_out,
    T* __restrict__ invom_out, T* __restrict__ zeta_out,
    unsigned char* __restrict__ done_out) {
  // cells [c0, c0 + n_cells): the row window's
  if (kFlat) {
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
    if (t >= static_cast<long long>(n_cells) * g.K) return;
    density_slot<T, NDIM, kDeep>(r, m, h, fill, target, g,
                          c0 + static_cast<int>(t / g.K),
                          static_cast<int>(t % g.K), kern, h_fac,
                          h_converge, h_lo, h_hi, rho_out, invom_out,
                          zeta_out, done_out);
    return;
  }
  for (int i = threadIdx.x; i < g.K; i += blockDim.x)
    density_slot<T, NDIM, kDeep>(r, m, h, fill, target, g, c0 + blockIdx.x,
                                 i,
                          kern, h_fac, h_converge, h_lo, h_hi, rho_out,
                          invom_out, zeta_out, done_out);
}

template <typename T, int NDIM, bool kFlat, bool kDeep, class KF>
void launch_density(const T* r, const T* m, const T* h,
                    const unsigned char* fill, const unsigned char* target,
                    const Grid3& g, int c0, int n_cells, const KF& kern,
                    T h_fac, T h_converge, T h_lo, T h_hi, T* rho, T* invom,
                    T* zeta, unsigned char* done, cudaStream_t stream) {
  const long long slots = static_cast<long long>(n_cells) * g.K;
  const int blocks = kFlat ? static_cast<int>((slots + kFlatThreads - 1)
                                              / kFlatThreads)
                           : n_cells;
  const int threads = kFlat ? kFlatThreads : slot_threads(g.K);
  grid27_density_kernel<T, NDIM, kFlat, kDeep, KF><<<blocks, threads, 0,
                                                      stream>>>(
      r, m, h, fill, target, g, c0, n_cells, kern, h_fac, h_converge, h_lo,
      h_hi, rho, invom, zeta, done);
}

template <typename T, int NDIM, class KF>
void launch_density_ndim(const T* r, const T* m, const T* h,
                         const unsigned char* fill,
                         const unsigned char* target, const Grid3& g,
                         int c0, int n_cells, const KF& kern, T h_fac,
                         T h_converge,
                         T h_lo, T h_hi, T* rho, T* invom, T* zeta,
                         unsigned char* done, bool flat,
                         cudaStream_t stream) {
  // the stencil deeper than one row a side only for a thin slab (qz > 1)
  const bool deep = g.qz > 1;
  if (flat && deep)
    launch_density<T, NDIM, true, true>(r, m, h, fill, target, g, c0,
                                        n_cells, kern, h_fac, h_converge,
                                        h_lo, h_hi, rho, invom, zeta, done,
                                        stream);
  else if (flat)
    launch_density<T, NDIM, true, false>(r, m, h, fill, target, g, c0,
                                         n_cells, kern, h_fac, h_converge,
                                         h_lo, h_hi, rho, invom, zeta, done,
                                         stream);
  else if (deep)
    launch_density<T, NDIM, false, true>(r, m, h, fill, target, g, c0,
                                         n_cells, kern, h_fac, h_converge,
                                         h_lo, h_hi, rho, invom, zeta, done,
                                         stream);
  else
    launch_density<T, NDIM, false, false>(r, m, h, fill, target, g, c0,
                                          n_cells, kern, h_fac, h_converge,
                                          h_lo, h_hi, rho, invom, zeta,
                                          done, stream);
}

template <typename T>
int run_density(const T* r, const T* m, const T* h,
                const unsigned char* fill, const unsigned char* target,
                int ndim, int n0, int n1, int n2, int k_cell, int per0,
                int per1, int per2, double L0, double L1, double L2,
                double norm, int family, int res, double h_fac,
                double h_converge, double hmax, T* rho, T* invom, T* zeta,
                unsigned char* done, int qz, int row0, int nrows,
                int mapping, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ndim < 1 || ndim > 3 || qz < 1 || row0 < 0 || nrows < 0
      || row0 + nrows > n0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Grid3 g = {{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell, qz};
  const int c0 = row0 * n1 * n2;
  const int n_cells = nrows * n1 * n2;
  const bool flat = slot_mapping_flat(mapping, ndim, k_cell);
  if (n_cells > 0 && k_cell > 0) {
    // bounds as the JAX code forms them: in double, then cast
    const T args[] = {T(h_fac), T(h_converge), T(1e-6 * hmax), T(hmax)};
    const bool known = kf::with_kernel<T>(
        family, res, norm, ndim, [&](const auto& kern) {
          if (ndim == 1)
            launch_density_ndim<T, 1>(r, m, h, fill, target, g, c0,
                                      n_cells,
                                      kern, args[0], args[1], args[2],
                                      args[3], rho, invom, zeta, done, flat,
                                      stream);
          else if (ndim == 2)
            launch_density_ndim<T, 2>(r, m, h, fill, target, g, c0,
                                      n_cells,
                                      kern, args[0], args[1], args[2],
                                      args[3], rho, invom, zeta, done, flat,
                                      stream);
          else
            launch_density_ndim<T, 3>(r, m, h, fill, target, g, c0,
                                      n_cells,
                                      kern, args[0], args[1], args[2],
                                      args[3], rho, invom, zeta, done, flat,
                                      stream);
        });
    if (!known) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define GRID27_DENSITY_ENTRY(NAME, T)                                       \
  int NAME(const T* r, const T* m, const T* h, const unsigned char* fill,   \
           const unsigned char* target, int ndim, int n0, int n1, int n2,   \
           int k_cell, int per0, int per1, int per2, double L0, double L1,  \
           double L2, double norm, int family, int res, double h_fac,       \
           double h_converge, double hmax, T* rho, T* invom, T* zeta,       \
           unsigned char* done, int qz, int row0, int nrows, int mapping,   \
           int device, void* stream) {                                      \
    return run_density<T>(r, m, h, fill, target, ndim, n0, n1, n2, k_cell,  \
                          per0, per1, per2, L0, L1, L2, norm, family, res,  \
                          h_fac, h_converge, hmax, rho, invom, zeta, done,  \
                          qz, row0, nrows, mapping, device, stream);        \
  }

GRID27_DENSITY_ENTRY(grid27_density_f32, float)
GRID27_DENSITY_ENTRY(grid27_density_f64, double)

}  // extern "C"
