// K8 active_density: the grad-h h-rho iteration of a listed subset of
// particles (the active particles of a block-timestep tick) over the
// 27-cell stencil.
//
// Replaces gandalf_tpu/ops/active_grid.py:active_hydro_pass (:107-138),
// which gathers an (n_cap, 27K) candidate block per active particle from
// ghost-layer copies (gather_active_candidates, :59-94) and runs
// ops/density.py:compute_h (:68-134) over it in lockstep.
//
// Bound on the card: pair arithmetic and the dependent loads of each
// candidate (slot -> particle -> position), as in K2, but only for the
// listed particles: the work follows the active fraction.
//
// Design: one thread per listed particle, 128 to a block.  The thread
// finds its cell from K1's cell id and sweeps the 27 neighbour cells of
// K1's dense slot map (particle id per slot, -1 empty) with wrapped
// indices and positions shifted by the box length on periodic dims.  Its
// iteration follows compute_h, not K2: it starts from the particle's own
// h, unclamped, with the bracket [0, hmax], and never clamps the
// fixed-point h (K2 clamps to [1e-6 hmax, hmax]).  A converged particle
// stops; the lockstep loop of the JAX package keeps a converged row's h
// and re-evaluates the same sums, so the two agree.  Outputs are the
// sums at the final h and the converged flag; the finish (h from rho,
// invomega, zeta, hfactor) is elementwise torch on the listed rows.
// The smoothing kernel (kernel_family.cuh) is a template parameter, with
// K2's support cut; any kernel but the direct M4 sums d^2 in rounded
// steps (kExactD2).
#include <cuda_runtime.h>

#include <type_traits>

#include "grid27.cuh"
#include "kernel_family.cuh"

namespace {

constexpr int kIterFixedPoint = 30;
constexpr int kIterMax = 150;
constexpr int kThreads = 128;

template <typename T, class KF>
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
  const T invndim = T(1.0 / 3.0);
  const T xi = r[3 * i], yi = r[3 * i + 1], zi = r[3 * i + 2];
  const T m_i = m[i];
  T hh = h[i];
  T lo = T(0), hi = hmax;
  T rho = T(0), invom = T(0), zeta = T(0);
  bool conv = false;
  for (int it = 0; it < kIterMax; ++it) {
    const T invh = T(1) / hh;
    const T invhsqd = invh * invh;
    T s_rho = T(0), s_om = T(0), s_zeta = T(0);
    for (int d = 0; d < 27; ++d) {
      int nc;
      T sh[3];
      if (!neighbour_cell<T>(g, cc, d, &nc, sh)) continue;
      const int* slots = ids_d + static_cast<long long>(nc) * K;
      for (int j = 0; j < K; ++j) {
        const int q = slots[j];
        if (q < 0) continue;
        const T dx = (r[3 * q] + sh[0]) - xi;
        const T dy = (r[3 * q + 1] + sh[1]) - yi;
        const T dz = (r[3 * q + 2] + sh[2]) - zi;
        const T d2 = KF::kExactD2 ? kf::add(kf::add(kf::mul(dx, dx),
                                                kf::mul(dy, dy)),
                                        kf::mul(dz, dz))
                              : dx * dx + dy * dy + dz * dz;
        T w0, wom, wz;
        // every term is zero beyond the support
        if (!kern.density(d2 * invhsqd, &w0, &wom, &wz)) continue;
        const T mj = m[q];
        s_rho += mj * w0;
        s_om += mj * wom;
        s_zeta += mj * wz;
      }
    }
    const T hfac = invh * invh * invh;
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

template <typename T>
int run_active_density(const int* idx, int n, const int* cell_of,
                       const int* ids_d, const T* r, const T* m, const T* h,
                       int n0, int n1, int n2, int k_cell, int per0,
                       int per1, int per2, double L0, double L1, double L2,
                       double norm, int family, int res, double h_fac,
                       double h_converge, double hmax, T* rho, T* invom,
                       T* zeta, unsigned char* done, int device,
                       void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Grid3 g = {{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell};
  if (n > 0) {
    const bool known = kf::with_kernel<T>(
        family, res, norm, 3, [&](const auto& kern) {
          using KF = std::decay_t<decltype(kern)>;
          active_density_kernel<T, KF><<<(n + kThreads - 1) / kThreads,
                                         kThreads, 0, stream>>>(
              idx, n, cell_of, ids_d, r, m, h, g, kern, T(h_fac),
              T(h_converge), T(hmax), rho, invom, zeta, done);
        });
    if (!known) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define ACTIVE_DENSITY_ENTRY(NAME, T)                                       \
  int NAME(const int* idx, int n, const int* cell_of, const int* ids_d,     \
           const T* r, const T* m, const T* h, int n0, int n1, int n2,      \
           int k_cell, int per0, int per1, int per2, double L0, double L1,  \
           double L2, double norm, int family, int res, double h_fac,       \
           double h_converge, double hmax, T* rho, T* invom, T* zeta,       \
           unsigned char* done, int device, void* stream) {                 \
    return run_active_density<T>(idx, n, cell_of, ids_d, r, m, h, n0, n1,   \
                                 n2, k_cell, per0, per1, per2, L0, L1, L2,  \
                                 norm, family, res, h_fac, h_converge,      \
                                 hmax, rho, invom, zeta, done, device,      \
                                 stream);                                   \
  }

ACTIVE_DENSITY_ENTRY(active_density_f32, float)
ACTIVE_DENSITY_ENTRY(active_density_f64, double)

}  // extern "C"
