// K2 grid27_density: the grad-h h-rho iteration over the 27-cell stencil.
//
// Replaces gandalf_tpu/ops/sph_grid27.py:density_grid27 (:359-505), whose
// slabs of cells iterate in lockstep (lax.while_loop) over a concatenated
// (cells, K, 27K) pair table built from ghost-layer copies.
//
// Bound on the card: pair arithmetic and the load of each neighbour.  At
// 262,144 particles one sweep is about 4.6e8 pair evaluations (1,755
// candidates per particle), and a particle needs a few sweeps to converge;
// every pair costs a square root and three kernel polynomials.
//
// Design: one block per cell and one thread per slot.  A thread runs its
// own particle's iteration in registers: every step sweeps the 27
// neighbour cells (wrapped indices, positions shifted by the box length on
// periodic dims, no ghost copies), sums m W, the Omega term and the zeta
// term, then takes a fixed-point step (steps 0..29) or a bisection step
// (30..149), until |h - h(rho)| / h < h_converge.  A converged particle
// stops; the JAX lockstep loop keeps a converged lane's h frozen and
// re-evaluates the same sums, so the two agree.  Threads of a warp read
// the same neighbour at the same time, so each load is one broadcast from
// L1/L2.  Outputs are the sums at the final h and the converged flag; the
// per-slot finish (h from rho, invomega, zeta, hfactor, overflow) stays
// elementwise torch.  No shared-memory staging yet: that is later work.
#include <cuda_runtime.h>

#include "grid27.cuh"
#include "m4.cuh"

namespace {

constexpr int kIterFixedPoint = 30;
constexpr int kIterMax = 150;

template <typename T>
__global__ void __launch_bounds__(256) grid27_density_kernel(
    const T* __restrict__ r, const T* __restrict__ m,
    const T* __restrict__ h, const unsigned char* __restrict__ fill,
    Grid3 g, T norm, T h_fac, T h_converge, T h_lo, T h_hi,
    T* __restrict__ rho_out, T* __restrict__ invom_out,
    T* __restrict__ zeta_out, unsigned char* __restrict__ done_out) {
  const int c = blockIdx.x;
  const int K = g.K;
  int cc[3];
  cell_coords(g, c, cc);
  const T nd = T(3);
  const T invndim = T(1.0 / 3.0);
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const long long p = static_cast<long long>(c) * K + i;
    if (!fill[p]) {
      rho_out[p] = T(0);
      invom_out[p] = T(0);
      zeta_out[p] = T(0);
      done_out[p] = 1;
      continue;
    }
    const T xi = r[3 * p], yi = r[3 * p + 1], zi = r[3 * p + 2];
    const T m_t = max(m[p], T(1e-30));
    T hh = min(max(h[p], h_lo), h_hi);
    T lo = T(0), hi = h_hi;
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
        const long long q0 = static_cast<long long>(nc) * K;
        for (int j = 0; j < K; ++j) {
          const long long q = q0 + j;
          if (!fill[q]) continue;
          const T dx = (r[3 * q] + sh[0]) - xi;
          const T dy = (r[3 * q + 1] + sh[1]) - yi;
          const T dz = (r[3 * q + 2] + sh[2]) - zi;
          const T s = sqrt((dx * dx + dy * dy + dz * dz) * invhsqd);
          if (s >= T(2)) continue;  // every M4 term is zero there
          const T mj = m[q];
          s_rho += mj * m4_w0<T>(s, norm);
          s_om += mj * m4_womega<T>(s, norm, nd);
          s_zeta += mj * m4_wzeta<T>(s);
        }
      }
      const T hfac = invh * invh * invh;
      rho = s_rho * hfac;
      invom = s_om * hfac * invh;
      zeta = s_zeta * invhsqd;
      const T h_target =
          h_fac * pow(m_t / max(rho, T(1e-300)), invndim);
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
}

template <typename T>
int run_density(const T* r, const T* m, const T* h,
                const unsigned char* fill, int n0, int n1, int n2,
                int k_cell, int per0, int per1, int per2, double L0,
                double L1, double L2, double norm, double h_fac,
                double h_converge, double hmax, T* rho, T* invom, T* zeta,
                unsigned char* done, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Grid3 g = {{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell};
  const int n_cells = n0 * n1 * n2;
  if (n_cells > 0 && k_cell > 0)
    // bounds as the JAX code forms them: in double, then cast
    grid27_density_kernel<T><<<n_cells, slot_threads(k_cell), 0, stream>>>(
        r, m, h, fill, g, T(norm), T(h_fac), T(h_converge),
        T(1e-6 * hmax), T(hmax), rho, invom, zeta, done);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define GRID27_DENSITY_ENTRY(NAME, T)                                       \
  int NAME(const T* r, const T* m, const T* h, const unsigned char* fill,   \
           int n0, int n1, int n2, int k_cell, int per0, int per1,          \
           int per2, double L0, double L1, double L2, double norm,          \
           double h_fac, double h_converge, double hmax, T* rho,            \
           T* invom, T* zeta, unsigned char* done, int device,              \
           void* stream) {                                                  \
    return run_density<T>(r, m, h, fill, n0, n1, n2, k_cell, per0, per1,    \
                          per2, L0, L1, L2, norm, h_fac, h_converge, hmax,  \
                          rho, invom, zeta, done, device, stream);          \
  }

GRID27_DENSITY_ENTRY(grid27_density_f32, float)
GRID27_DENSITY_ENTRY(grid27_density_f64, double)

}  // extern "C"
