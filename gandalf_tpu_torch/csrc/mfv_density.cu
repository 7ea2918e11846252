// K10 mfv_density: the meshless finite-volume h iteration on the number
// density over the 27-cell stencil.
//
// Replaces gandalf_tpu/ops/mfv_grid27.py:density_mfv_grid27 (:70-185),
// whose slabs of cells iterate in lockstep (lax.while_loop) over the 27
// shifted slices of ghost-layer copies of the dense cell tensors.
//
// Bound on the card: pair arithmetic.  At 262,144 particles one sweep is
// about 4.6e8 pair candidates (1,755 per particle at K = 65), each a
// square root and, inside the support, three kernel polynomials; with
// the absolute convergence test |h - h(ndens)| < h_converge of the JAX
// package nearly every particle stops after one sweep.
//
// Design: K2's.  One block per cell, one thread per slot of K1's slot map
// (-1 empty), the iteration in registers: each step sweeps the 27
// neighbour cells (wrapped indices, positions shifted by the box length
// where an index wrapped) and sums W (number density), the Omega term and
// m_j times the zeta term, the particle itself included; then a
// fixed-point step h = h_fac ndens^(-1/3) (steps 0..29) or a bisection
// step (30..149), h clamped to [1e-6 hmax, hmax], until converged.
// Threads of a block read the same neighbour at the same time (a
// broadcast from L1).  Outputs are the sums at the final h and the
// converged flag, in particle order; the finish (h from the number
// density, rho, the Omega and zeta corrections, hfactor, overflow) is
// elementwise torch.
#include <cuda_runtime.h>

#include "grid27.cuh"
#include "m4.cuh"

namespace {

constexpr int kIterFixedPoint = 30;
constexpr int kIterMax = 150;

template <typename T>
__global__ void __launch_bounds__(256) mfv_density_kernel(
    const int* __restrict__ ids, const T* __restrict__ r,
    const T* __restrict__ m, const T* __restrict__ h, Grid3 g, T norm,
    T h_fac, T h_fac3, T h_converge, T h_lo, T h_hi,
    T* __restrict__ ndens_out, T* __restrict__ invom_out,
    T* __restrict__ zeta_out, unsigned char* __restrict__ done_out) {
  const int c = blockIdx.x;
  const int K = g.K;
  int cc[3];
  cell_coords(g, c, cc);
  const T nd = T(3);
  const T invndim = T(1.0 / 3.0);
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const int p = ids[static_cast<long long>(c) * K + i];
    if (p < 0) continue;
    const T xi = r[3 * p], yi = r[3 * p + 1], zi = r[3 * p + 2];
    T hh = min(max(h[p], h_lo), h_hi);
    T lo = T(0), hi = h_hi;
    T ndens = T(0), invom = T(0), zeta = T(0);
    bool conv = false;
    for (int it = 0; it < kIterMax; ++it) {
      const T invh = T(1) / hh;
      const T invhsqd = invh * invh;
      T s_nd = T(0), s_om = T(0), s_zeta = T(0);
      for (int d = 0; d < 27; ++d) {
        int nc;
        T sh[3];
        if (!neighbour_cell<T>(g, cc, d, &nc, sh)) continue;
        const int* q0 = ids + static_cast<long long>(nc) * K;
        for (int j = 0; j < K; ++j) {
          const int q = q0[j];
          if (q < 0) continue;
          const T dx = (r[3 * q] + sh[0]) - xi;
          const T dy = (r[3 * q + 1] + sh[1]) - yi;
          const T dz = (r[3 * q + 2] + sh[2]) - zi;
          const T s = sqrt((dx * dx + dy * dy + dz * dz) * invhsqd);
          if (s >= T(2)) continue;  // every M4 term is zero there
          s_nd += m4_w0<T>(s, norm);
          s_om += m4_womega<T>(s, norm, nd);
          s_zeta += m[q] * m4_wzeta<T>(s);
        }
      }
      const T hfac = invh * invh * invh;
      ndens = s_nd * hfac;
      invom = s_om * hfac * invh;
      zeta = s_zeta * invhsqd;
      const T tgt = h_fac * pow(T(1) / max(ndens, T(1e-300)), invndim);
      conv = (ndens > T(0)) && (fabs(hh - tgt) < h_converge);
      if (conv) break;
      const bool too_big = (ndens < T(1e-30)) || (ndens * (hh * hh * hh)
                                                   > h_fac3);
      if (it >= kIterFixedPoint) {
        if (too_big)
          hi = hh;
        else
          lo = hh;
      }
      const T h_new = it < kIterFixedPoint ? tgt : T(0.5) * (lo + hi);
      hh = min(max(h_new, h_lo), h_hi);
    }
    ndens_out[p] = ndens;
    invom_out[p] = invom;
    zeta_out[p] = zeta;
    done_out[p] = conv ? 1 : 0;
  }
}

template <typename T>
int run_density(const int* ids, const T* r, const T* m, const T* h, int n0,
                int n1, int n2, int k_cell, int per0, int per1, int per2,
                double L0, double L1, double L2, double norm, double h_fac,
                double h_fac3, double h_converge, double hmax, T* ndens,
                T* invom, T* zeta, unsigned char* done, int device,
                void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Grid3 g = {{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell};
  const int n_cells = n0 * n1 * n2;
  if (n_cells > 0 && k_cell > 0)
    // constants as the JAX code forms them (h_fac3 = h_fac ** 3 in
    // Python): in double, then cast
    mfv_density_kernel<T><<<n_cells, slot_threads(k_cell), 0, stream>>>(
        ids, r, m, h, g, T(norm), T(h_fac), T(h_fac3),
        T(h_converge), T(1e-6 * hmax), T(hmax), ndens, invom, zeta, done);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define MFV_DENSITY_ENTRY(NAME, T)                                          \
  int NAME(const int* ids, const T* r, const T* m, const T* h, int n0,      \
           int n1, int n2, int k_cell, int per0, int per1, int per2,        \
           double L0, double L1, double L2, double norm, double h_fac,      \
           double h_fac3, double h_converge, double hmax, T* ndens,         \
           T* invom, T* zeta, unsigned char* done, int device,              \
           void* stream) {                                                  \
    return run_density<T>(ids, r, m, h, n0, n1, n2, k_cell, per0, per1,     \
                          per2, L0, L1, L2, norm, h_fac, h_fac3,            \
                          h_converge, hmax, ndens, invom, zeta, done,       \
                          device, stream);                                  \
  }

MFV_DENSITY_ENTRY(mfv_density_f32, float)
MFV_DENSITY_ENTRY(mfv_density_f64, double)

}  // extern "C"
