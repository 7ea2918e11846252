// K10 mfv_density: the meshless finite-volume h iteration on the number
// density over the 3^NDIM-cell stencil, in 1, 2 or 3 dims.
//
// Replaces gandalf_tpu/ops/mfv_grid27.py:density_mfv_grid27 (:70-185),
// whose slabs of cells iterate in lockstep (lax.while_loop) over the
// 3^ndim shifted slices of ghost-layer copies of the dense cell tensors.
//
// Bound on the card: pair arithmetic.  At 262,144 particles in 3D one
// sweep is about 4.6e8 pair candidates (1,755 per particle at K = 65),
// each a square root and, inside the support, three kernel polynomials;
// with the absolute convergence test |h - h(ndens)| < h_converge of the
// JAX package nearly every particle stops after one sweep.  In 2D a
// particle tests 9 K candidates, in 1D 3 K.
//
// Design: K2's.  One thread per slot of K1's slot map (-1 empty): one
// block per cell in 3D with K >= 32, else threads over the flattened
// (cell, slot) index (grid27.cuh), NDIM a template parameter.  The
// iteration runs in registers: each step sweeps the neighbour cells
// (wrapped indices, positions shifted by the box length where an index
// wrapped; a cell's sweep ends at its first empty slot, since K1 fills
// slots from 0 up) and sums W (number density), the Omega term and m_j
// times the zeta term, the particle itself included; then a fixed-point
// step h = h_fac ndens^(-1/NDIM) (steps 0..29) or a bisection step
// (30..149), h clamped to [1e-6 hmax, hmax], until converged.  Outputs
// are the sums at the final h and the converged flag, in particle
// order; the finish (h from the number density, rho, the Omega and zeta
// corrections, hfactor, overflow) is elementwise torch.
//
// The smoothing kernel (M4, quintic or gaussian, direct or tabulated:
// kernel_family.cuh) is a template parameter, as in K2: a pair counts
// where the family's density terms do not all vanish (s < kernrange, or
// for a tabulated kernel s^2 < kernrange^2, JAX's w0_s2 cut), and any
// kernel but the direct M4 sums d^2 in the plain version's rounded steps
// (kExactD2), so that s^2 and a table index come from the same d^2.  At
// kernrange 3 a 3D particle meets (3/2)^3 = 3.4 times M4's neighbours
// at the same h_fac.
#include <cuda_runtime.h>

#include "grid27.cuh"
#include "kernel_family.cuh"

namespace {

constexpr int kIterFixedPoint = 30;
constexpr int kIterMax = 150;

template <typename T>
struct DensityArgs {
  T h_fac, h_fac_nd, h_converge, h_lo, h_hi;
};

template <typename T, int NDIM, class KF>
__device__ __forceinline__ void density_slot(
    const int* __restrict__ ids, const T* __restrict__ r,
    const T* __restrict__ m, const T* __restrict__ h, const Grid3& g, int c,
    int i, const KF& kern, const DensityArgs<T>& a,
    T* __restrict__ ndens_out, T* __restrict__ invom_out,
    T* __restrict__ zeta_out,
    unsigned char* __restrict__ done_out) {
  const int K = g.K;
  const int p = ids[static_cast<long long>(c) * K + i];
  if (p < 0) return;
  int cc[3];
  cell_coords(g, c, cc);
  T xi[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) xi[k] = r[NDIM * p + k];
  const T invndim = T(1.0 / NDIM);
  T hh = min(max(h[p], a.h_lo), a.h_hi);
  T lo = T(0), hi = a.h_hi;
  T ndens = T(0), invom = T(0), zeta = T(0);
  bool conv = false;
  for (int it = 0; it < kIterMax; ++it) {
    const T invh = T(1) / hh;
    const T invhsqd = invh * invh;
    T s_nd = T(0), s_om = T(0), s_zeta = T(0);
    for (int d = 0; d < Stencil<NDIM>::kSize; ++d) {
      int nc;
      T sh[3];
      if (!neighbour_cell<T, NDIM>(g, cc, d, &nc, sh)) continue;
      const int* q0 = ids + static_cast<long long>(nc) * K;
      for (int j = 0; j < K; ++j) {
        const int q = q0[j];
        if (q < 0) break;
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
        s_nd += w0;
        s_om += wom;
        s_zeta += m[q] * wz;
      }
    }
    T hfac = invh;
#pragma unroll
    for (int k = 1; k < NDIM; ++k) hfac *= invh;
    ndens = s_nd * hfac;
    invom = s_om * hfac * invh;
    zeta = s_zeta * invhsqd;
    const T tgt = a.h_fac * pow(T(1) / max(ndens, T(1e-300)), invndim);
    conv = (ndens > T(0)) && (fabs(hh - tgt) < a.h_converge);
    if (conv) break;
    T hnd = hh;
#pragma unroll
    for (int k = 1; k < NDIM; ++k) hnd *= hh;
    const bool too_big = (ndens < T(1e-30)) || (ndens * hnd > a.h_fac_nd);
    if (it >= kIterFixedPoint) {
      if (too_big)
        hi = hh;
      else
        lo = hh;
    }
    const T h_new = it < kIterFixedPoint ? tgt : T(0.5) * (lo + hi);
    hh = min(max(h_new, a.h_lo), a.h_hi);
  }
  ndens_out[p] = ndens;
  invom_out[p] = invom;
  zeta_out[p] = zeta;
  done_out[p] = conv ? 1 : 0;
}

template <typename T, int NDIM, class KF>
__global__ void __launch_bounds__(256) mfv_density_kernel(
    const int* __restrict__ ids, const T* __restrict__ r,
    const T* __restrict__ m, const T* __restrict__ h, Grid3 g, int n_cells,
    bool flat, KF kern, DensityArgs<T> a, T* __restrict__ ndens_out,
    T* __restrict__ invom_out, T* __restrict__ zeta_out,
    unsigned char* __restrict__ done_out) {
  if (flat) {
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
    if (t >= static_cast<long long>(n_cells) * g.K) return;
    density_slot<T, NDIM>(ids, r, m, h, g, static_cast<int>(t / g.K),
                          static_cast<int>(t % g.K), kern, a, ndens_out,
                          invom_out, zeta_out, done_out);
    return;
  }
  for (int i = threadIdx.x; i < g.K; i += blockDim.x)
    density_slot<T, NDIM>(ids, r, m, h, g, blockIdx.x, i, kern, a, ndens_out,
                          invom_out, zeta_out, done_out);
}

template <typename T, int NDIM, class KF>
void launch(const int* ids, const T* r, const T* m, const T* h,
            const Grid3& g, int n_cells, bool flat, const KF& kern,
            const DensityArgs<T>& a, T* ndens, T* invom, T* zeta,
            unsigned char* done, cudaStream_t stream) {
  const long long slots = static_cast<long long>(n_cells) * g.K;
  const int blocks = flat ? static_cast<int>((slots + kFlatThreads - 1)
                                             / kFlatThreads)
                          : n_cells;
  const int threads = flat ? kFlatThreads : slot_threads(g.K);
  mfv_density_kernel<T, NDIM, KF><<<blocks, threads, 0, stream>>>(
      ids, r, m, h, g, n_cells, flat, kern, a, ndens, invom, zeta, done);
}

template <typename T>
int run_density(const int* ids, const T* r, const T* m, const T* h,
                int ndim, int n0, int n1, int n2, int k_cell, int per0,
                int per1, int per2, double L0, double L1, double L2,
                double norm, int family, int res, double h_fac,
                double h_fac_nd, double h_converge, double hmax,
                int mapping, T* ndens,
                T* invom, T* zeta, unsigned char* done, int device,
                void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ndim < 1 || ndim > 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Grid3 g = {{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell};
  const int n_cells = n0 * n1 * n2;
  const bool flat = slot_mapping_flat(mapping, ndim, k_cell);
  // constants as the JAX code forms them (h_fac ** ndim in Python): in
  // double, then cast
  const DensityArgs<T> a = {T(h_fac), T(h_fac_nd), T(h_converge),
                            T(1e-6 * hmax), T(hmax)};
  if (n_cells > 0 && k_cell > 0) {
    const bool known = kf::with_kernel<T>(
        family, res, norm, ndim, [&](const auto& kern) {
          if (ndim == 1)
            launch<T, 1>(ids, r, m, h, g, n_cells, flat, kern, a, ndens,
                         invom, zeta, done, stream);
          else if (ndim == 2)
            launch<T, 2>(ids, r, m, h, g, n_cells, flat, kern, a, ndens,
                         invom, zeta, done, stream);
          else
            launch<T, 3>(ids, r, m, h, g, n_cells, flat, kern, a, ndens,
                         invom, zeta, done, stream);
        });
    if (!known) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define MFV_DENSITY_ENTRY(NAME, T)                                          \
  int NAME(const int* ids, const T* r, const T* m, const T* h, int ndim,    \
           int n0, int n1, int n2, int k_cell, int per0, int per1,          \
           int per2, double L0, double L1, double L2, double norm,          \
           int family, int res, double h_fac, double h_fac_nd,              \
           double h_converge, double hmax, int mapping, T* ndens,           \
           T* invom, T* zeta, unsigned char* done, int device,              \
           void* stream) {                                                  \
    return run_density<T>(ids, r, m, h, ndim, n0, n1, n2, k_cell, per0,     \
                          per1, per2, L0, L1, L2, norm, family, res,        \
                          h_fac, h_fac_nd, h_converge, hmax, mapping,       \
                          ndens, invom, zeta, done, device, stream);        \
  }

MFV_DENSITY_ENTRY(mfv_density_f32, float)
MFV_DENSITY_ENTRY(mfv_density_f64, double)

}  // extern "C"
