// K8 active_density: the grad-h h-rho iteration of a listed subset of
// particles (the active particles of a block-timestep tick) over the
// 3^NDIM-cell stencil, in 1, 2 or 3 dims.
//
// Replaces gandalf_tpu/ops/active_grid.py:active_hydro_pass (:107-138),
// which gathers an (n_cap, 3^nd K) candidate block per active particle
// from ghost-layer copies (gather_active_candidates, :59-94) and runs
// ops/density.py:compute_h (:68-134) over it in lockstep, at any nd.
//
// Bound on the card: pair arithmetic and the dependent loads of each
// candidate (slot -> particle -> position), as in K2, but only for the
// listed particles: the work follows the active fraction.
//
// Design: one thread per listed particle, 128 to a block, NDIM a
// template parameter (no run-time branch on the dims).  The thread
// finds its cell from K1's cell id and sweeps the 3^NDIM neighbour cells
// (grid27.cuh's order) of K1's dense slot map (particle id per slot, -1
// empty) with wrapped indices and positions shifted by the box length on
// periodic dims.  Its
// iteration follows compute_h, not K2: it starts from the particle's own
// h, unclamped, with the bracket [0, hmax], and never clamps the
// fixed-point h (K2 clamps to [1e-6 hmax, hmax]).  A converged particle
// stops; the lockstep loop of the JAX package keeps a converged row's h
// and re-evaluates the same sums, so the two agree.  Outputs are the
// sums at the final h and the converged flag; the finish (h from rho,
// invomega, zeta, hfactor) is elementwise torch on the listed rows.
// rho takes h^-NDIM and h_target the NDIM-th root, as compute_h's
// invndim and hfac = invh^ndim.  The smoothing kernel (kernel_family.cuh)
// is a template parameter, with K2's support cut; d^2 sums the NDIM
// terms in the plain version's order, in rounded steps for any kernel
// but the direct M4 (kExactD2).
#include <cuda_runtime.h>

#include "grid27.cuh"
#include "kernel_family.cuh"

namespace {

constexpr int kIterFixedPoint = 30;
constexpr int kIterMax = 150;
constexpr int kThreads = 128;

template <typename T, int NDIM, class KF>
__global__ void __launch_bounds__(kThreads) active_density_kernel(
    const int* __restrict__ idx, int n, const int* __restrict__ cell_of,
    const int* __restrict__ ids_d, const T* __restrict__ r,
    const T* __restrict__ m, const T* __restrict__ h, Grid3 g, KF kern,
    T h_fac, T h_converge, T hmax, T* __restrict__ rho_out,
    T* __restrict__ invom_out, T* __restrict__ zeta_out,
    unsigned char* __restrict__ done_out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int i = idx[k];
  const int K = g.K;
  int cc[3];
  cell_coords(g, cell_of[i], cc);
  const T invndim = T(1.0 / NDIM);
  T xi[NDIM];
#pragma unroll
  for (int e = 0; e < NDIM; ++e) xi[e] = r[NDIM * static_cast<long long>(i)
                                         + e];
  const T m_i = m[i];
  T hh = h[i];
  T lo = T(0), hi = hmax;
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
      const int* slots = ids_d + static_cast<long long>(nc) * K;
      for (int j = 0; j < K; ++j) {
        const int q = slots[j];
        if (q < 0) continue;
        T d2 = T(0);
#pragma unroll
        for (int e = 0; e < NDIM; ++e) {
          const T dk = (r[NDIM * static_cast<long long>(q) + e] + sh[e])
                       - xi[e];
          if (KF::kExactD2)
            d2 = e == 0 ? kf::mul(dk, dk) : kf::add(d2, kf::mul(dk, dk));
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
    for (int e = 1; e < NDIM; ++e) hfac *= invh;
    rho = s_rho * hfac;
    invom = s_om * hfac * invh;
    zeta = s_zeta * invhsqd;
    const T h_target = h_fac * pow(m_i / max(rho, T(1e-300)), invndim);
    conv = rho > T(0) && hh > T(0)
           && fabs(hh - h_target) / hh < h_converge;
    if (conv) break;
    const bool too_big = (rho < T(1e-30)) || (hh > h_target);
    if (it >= kIterFixedPoint) {
      if (too_big)
        hi = hh;
      else
        lo = hh;
    }
    hh = it < kIterFixedPoint ? h_target : T(0.5) * (lo + hi);
  }
  rho_out[k] = rho;
  invom_out[k] = invom;
  zeta_out[k] = zeta;
  done_out[k] = conv ? 1 : 0;
}

template <typename T, int NDIM, class KF>
void launch(const int* idx, int n, const int* cell_of, const int* ids_d,
            const T* r, const T* m, const T* h, const Grid3& g,
            const KF& kern, T h_fac, T h_converge, T hmax, T* rho, T* invom,
            T* zeta, unsigned char* done, cudaStream_t stream) {
  active_density_kernel<T, NDIM, KF>
      <<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          idx, n, cell_of, ids_d, r, m, h, g, kern, h_fac, h_converge, hmax,
          rho, invom, zeta, done);
}

template <typename T>
int run_active_density(const int* idx, int n, const int* cell_of,
                       const int* ids_d, const T* r, const T* m, const T* h,
                       int ndim, int n0, int n1, int n2, int k_cell,
                       int per0, int per1, int per2, double L0, double L1,
                       double L2, double norm, int family, int res,
                       double h_fac,
                       double h_converge, double hmax, T* rho, T* invom,
                       T* zeta, unsigned char* done, int device,
                       void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ndim < 1 || ndim > 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Grid3 g = {{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell};
  if (n > 0) {
    const T args[] = {T(h_fac), T(h_converge), T(hmax)};
    const bool known = kf::with_kernel<T>(
        family, res, norm, ndim, [&](const auto& kern) {
          if (ndim == 1)
            launch<T, 1>(idx, n, cell_of, ids_d, r, m, h, g, kern, args[0],
                         args[1], args[2], rho, invom, zeta, done, stream);
          else if (ndim == 2)
            launch<T, 2>(idx, n, cell_of, ids_d, r, m, h, g, kern, args[0],
                         args[1], args[2], rho, invom, zeta, done, stream);
          else
            launch<T, 3>(idx, n, cell_of, ids_d, r, m, h, g, kern, args[0],
                         args[1], args[2], rho, invom, zeta, done, stream);
        });
    if (!known) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define ACTIVE_DENSITY_ENTRY(NAME, T)                                       \
  int NAME(const int* idx, int n, const int* cell_of, const int* ids_d,     \
           const T* r, const T* m, const T* h, int ndim, int n0, int n1,    \
           int n2, int k_cell, int per0, int per1, int per2, double L0,     \
           double L1, double L2, double norm, int family, int res,          \
           double h_fac, double h_converge, double hmax, T* rho, T* invom,  \
           T* zeta, unsigned char* done, int device, void* stream) {        \
    return run_active_density<T>(idx, n, cell_of, ids_d, r, m, h, ndim, n0, \
                                 n1, n2, k_cell, per0, per1, per2, L0, L1,  \
                                 L2, norm, family, res, h_fac, h_converge,  \
                                 hmax, rho, invom, zeta, done, device,      \
                                 stream);                                   \
  }

ACTIVE_DENSITY_ENTRY(active_density_f32, float)
ACTIVE_DENSITY_ENTRY(active_density_f64, double)

}  // extern "C"
