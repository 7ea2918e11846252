// K11 mfv_gradients: least-squares gradient matrices, primitive gradients
// and the cell limiter of the meshless finite-volume scheme over the
// 27-cell stencil.
//
// Replaces gandalf_tpu/ops/mfv_grid27.py:gradients_mfv_grid27 (:198-279,
// the cell-limiter branch) with gandalf_tpu/ops/mfv.py:gradient_accumulate
// and gradient_finalize (:194-285): there the running sums are (N, ...)
// arrays accumulated over 27 shifted slices of ghost-layer copies and
// finished by elementwise XLA code.
//
// Bound on the card: pair arithmetic and the load of each neighbour (its
// position, W and sound speed, 9 values).  One pass is about 4.6e8 pair
// candidates at 262,144 particles; a pair inside the support costs a
// square root, two kernel polynomials and some 60 multiply-adds for E
// and the two gradient sums.
//
// Design: K2's layout, one block per cell and one thread per slot of K1's
// slot map.  A thread keeps its particle's running sums in registers: E
// (3x3), grad_tmp and grad_sph (5x3 each), vsig_max, Wmax and Wmin (5
// each) and drmax^2.  E and the gradient sums take every pair with d^2 >
// 0 (so the particle itself and coincident partners drop out), weighted
// by the compact kernel; vsig, Wmax/Wmin and drmax take the pairs within
// kernrange h_i only.  The finish runs in the kernel too: the adjugate
// inverse B, the condition guard |E|^2 |B|^2 / 9 >= 1e4 that selects the
// SPH gradient, vsig_max >= sound and the cell alphas.  Outputs are in
// particle order.  No shared-memory staging yet: that is later work.
#include <cuda_runtime.h>

#include "grid27.cuh"
#include "m4.cuh"
#include "mfv.cuh"

namespace {

using mfv::kNvar;

// columns of the packed per-particle table (ops/mfv_grid27.py:GRAD_COLS)
constexpr int kH = 0, kNdens = 1, kW = 2, kSound = 7, kCols = 8;

template <typename T>
__global__ void __launch_bounds__(256) mfv_gradients_kernel(
    const int* __restrict__ ids, const T* __restrict__ r,
    const T* __restrict__ pk, Grid3 g, T norm, T kernrange,
    T* __restrict__ B_out, T* __restrict__ grad_out,
    T* __restrict__ alpha_out, T* __restrict__ vsig_out,
    unsigned char* __restrict__ bad_out) {
  const int c = blockIdx.x;
  const int K = g.K;
  int cc[3];
  cell_coords(g, c, cc);
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const int p = ids[static_cast<long long>(c) * K + i];
    if (p < 0) continue;
    const T* own = pk + kCols * p;
    const T xi = r[3 * p], yi = r[3 * p + 1], zi = r[3 * p + 2];
    const T h = max(own[kH], T(1e-30));
    const T invh = T(1) / h;
    const T invhsqd = invh * invh;
    const T wnorm = invh * invh * invh / max(own[kNdens], T(1e-300));
    const T w1norm = invh * invh * invh * invh / max(own[kNdens], T(1e-300));
    const T sound = own[kSound];
    const T rad2 = (kernrange * h) * (kernrange * h);
    T Wi[kNvar];
#pragma unroll
    for (int v = 0; v < kNvar; ++v) Wi[v] = own[kW + v];
    T E[9], gt[kNvar * 3], gs[kNvar * 3], Wmax[kNvar], Wmin[kNvar];
#pragma unroll
    for (int k = 0; k < 9; ++k) E[k] = T(0);
#pragma unroll
    for (int k = 0; k < kNvar * 3; ++k) gt[k] = gs[k] = T(0);
#pragma unroll
    for (int v = 0; v < kNvar; ++v) {
      Wmax[v] = T(-1e30);
      Wmin[v] = T(1e30);
    }
    T vsig_max = T(0), drmax2 = T(0);
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
        const T drmag = sqrt(d2);
        if (d2 > rad2 && drmag * invh >= T(2) && sqrt(d2 * invhsqd) >= T(2))
          continue;  // W, W' and the kernel-range statistics are all 0
        const T* pq = pk + kCols * q;
        T dW[kNvar];
#pragma unroll
        for (int v = 0; v < kNvar; ++v) dW[v] = pq[kW + v] - Wi[v];
        const T w = wnorm * m4_w0<T>(sqrt(d2 * invhsqd), norm);
        const T w1 = w1norm * m4_w1<T>(drmag * invh, norm);
        const T unit[3] = {dr[0] / drmag, dr[1] / drmag, dr[2] / drmag};
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b) E[3 * a + b] += w * dr[a] * dr[b];
#pragma unroll
        for (int v = 0; v < kNvar; ++v)
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            gt[3 * v + a] += w * dW[v] * dr[a];
            gs[3 * v + a] -= w1 * dW[v] * unit[a];
          }
        if (d2 <= rad2) {
          const T dvdr = (pq[kW] - Wi[0]) * dr[0]
                         + (pq[kW + 1] - Wi[1]) * dr[1]
                         + (pq[kW + 2] - Wi[2]) * dr[2];
          const T vsig = sound + pq[kSound]
                         - min(T(0), dvdr / (drmag + T(1e-30)));
          vsig_max = max(vsig_max, vsig);
#pragma unroll
          for (int v = 0; v < kNvar; ++v) {
            Wmax[v] = max(Wmax[v], pq[kW + v]);
            Wmin[v] = min(Wmin[v], pq[kW + v]);
          }
          drmax2 = max(drmax2, d2);
        }
      }
    }
    // the finish (gradient_finalize)
    T B[9];
    mfv::invert3<T>(E, B);
    T modE = T(0), modB = T(0);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      modE += E[k] * E[k];
      modB += B[k] * B[k];
    }
    const bool bad = modE * modB / T(9) >= T(1e4);
    T grad[kNvar * 3];
#pragma unroll
    for (int v = 0; v < kNvar; ++v)
#pragma unroll
      for (int a = 0; a < 3; ++a)
        grad[3 * v + a] = bad ? gs[3 * v + a]
                              : B[3 * a] * gt[3 * v]
                                    + B[3 * a + 1] * gt[3 * v + 1]
                                    + B[3 * a + 2] * gt[3 * v + 2];
    const T drmax = max(sqrt(drmax2), T(2) * h) * T(0.51);
    T* alpha = alpha_out + kNvar * static_cast<long long>(p);
#pragma unroll
    for (int v = 0; v < kNvar; ++v) {
      const T gradmag = sqrt(grad[3 * v] * grad[3 * v]
                             + grad[3 * v + 1] * grad[3 * v + 1]
                             + grad[3 * v + 2] * grad[3 * v + 2]);
      const T dWlim = drmax * gradmag;
      const T dWmax = max(Wmax[v], Wi[v]) - Wi[v];
      const T dWmin = Wi[v] - min(Wmin[v], Wi[v]);
      const T lim = max(dWlim, T(1e-300));
      alpha[v] = dWlim != T(0)
                     ? min(max(min(dWmax / lim, dWmin / lim), T(0)), T(1))
                     : T(1);
    }
#pragma unroll
    for (int k = 0; k < 9; ++k)
      B_out[9 * static_cast<long long>(p) + k] = B[k];
#pragma unroll
    for (int k = 0; k < kNvar * 3; ++k)
      grad_out[kNvar * 3 * static_cast<long long>(p) + k] = grad[k];
    vsig_out[p] = max(vsig_max, sound);
    bad_out[p] = bad ? 1 : 0;
  }
}

template <typename T>
int run_gradients(const int* ids, const T* r, const T* pk, int n0, int n1,
                  int n2, int k_cell, int per0, int per1, int per2,
                  double L0, double L1, double L2, double norm,
                  double kernrange, T* B, T* grad, T* alpha, T* vsig,
                  unsigned char* bad, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Grid3 g = {{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell};
  const int n_cells = n0 * n1 * n2;
  if (n_cells > 0 && k_cell > 0)
    mfv_gradients_kernel<T><<<n_cells, slot_threads(k_cell), 0, stream>>>(
        ids, r, pk, g, T(norm), T(kernrange), B, grad, alpha, vsig, bad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define MFV_GRADIENTS_ENTRY(NAME, T)                                        \
  int NAME(const int* ids, const T* r, const T* pk, int n0, int n1,         \
           int n2, int k_cell, int per0, int per1, int per2, double L0,     \
           double L1, double L2, double norm, double kernrange, T* B,       \
           T* grad, T* alpha, T* vsig, unsigned char* bad, int device,      \
           void* stream) {                                                  \
    return run_gradients<T>(ids, r, pk, n0, n1, n2, k_cell, per0, per1,     \
                            per2, L0, L1, L2, norm, kernrange, B, grad,     \
                            alpha, vsig, bad, device, stream);              \
  }

MFV_GRADIENTS_ENTRY(mfv_gradients_f32, float)
MFV_GRADIENTS_ENTRY(mfv_gradients_f64, double)

}  // extern "C"
