// K31 mfv_limiter: the per-neighbour cell-limiter sweep of the
// tvdscalar and springel2009 slope limiters over the 3^NDIM-cell
// stencil, in 1, 2 or 3 dims.
//
// Replaces gandalf_tpu/ops/mfv_grid27.py:gradients_mfv_grid27's second
// shift sweep (:281-325) over gandalf_tpu/ops/mfv.py:
// limiter_alpha_accumulate (:320-356): there each of 3^ndim shifted
// slices of ghost-layer copies gives an (N, K, nvar) block of ratios,
// reduced by a running min.
//
// Bound on the card: pair arithmetic and the neighbour's load (its
// position and W, 2 NDIM + 2 values).  A particle tests 3^NDIM K
// candidates; a pair within kernrange h_i costs nvar dot products of
// the gradient with dr, a division and a min per variable.
//
// Design: K11's layout, one thread per slot (one block per cell in 3D
// with K >= 32, else flat over (cell, slot); NDIM a template parameter).
// The thread holds its particle's W, the finalised gradient (nvar x
// NDIM) and, for springel2009, the signed extrema Wmax - W and Wmin - W
// from K11, and keeps the running min alpha (from 1) in registers.  A
// pair counts where 0 < d^2 <= (kernrange h_i)^2: the support radius is
// kernrange h_i alone, as the JAX sweep's `near` takes it, not K11's
// stencil reach or max(h_i, h_j).  For each variable, dW = 0.51 grad.dr;
// where |dW| > 1e-300 (0 in float32, as the JAX literal rounds there)
// the ratio is (W_j - W_i) / dW clipped to [0, 1] (tvdscalar), or
// dWmax / dW for dW > 0 and dWmin / dW otherwise, unclipped
// (springel2009: only the running min from 1 bounds it).  A cell's sweep
// ends at its first empty slot; each target's alphas are written once.
#include <cuda_runtime.h>

#include "grid27.cuh"
#include "mfv.cuh"

namespace {

enum SweepLimiter { kTvdScalar = 0, kSpringel2009 = 1 };

template <typename T, int NDIM, int LIM>
__device__ __forceinline__ void limiter_slot(
    const int* __restrict__ ids, const T* __restrict__ r,
    const T* __restrict__ pk, const T* __restrict__ grad,
    const T* __restrict__ dWmax, const T* __restrict__ dWmin, const Grid3& g,
    int c, int i, T kernrange, T* __restrict__ alpha_out) {
  constexpr int kNvar = mfv::Dims<NDIM>::kNvar;
  // columns of the packed table (ops/mfv_grid27.py:gradients)
  constexpr int kH = 0, kW = 2, kCols = kNvar + 3;
  const int K = g.K;
  const int p = ids[static_cast<long long>(c) * K + i];
  if (p < 0) return;
  int cc[3];
  cell_coords(g, c, cc);
  const T* own = pk + kCols * static_cast<long long>(p);
  T xi[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) xi[k] = r[NDIM * p + k];
  const T h = max(own[kH], T(1e-30));
  const T rad = kernrange * h;
  const T rad2 = rad * rad;
  T Wi[kNvar], gi[kNvar * NDIM], mx[kNvar], mn[kNvar], alpha[kNvar];
#pragma unroll
  for (int v = 0; v < kNvar; ++v) {
    Wi[v] = own[kW + v];
    alpha[v] = T(1);
    if (LIM == kSpringel2009) {
      mx[v] = dWmax[kNvar * static_cast<long long>(p) + v];
      mn[v] = dWmin[kNvar * static_cast<long long>(p) + v];
    }
#pragma unroll
    for (int a = 0; a < NDIM; ++a)
      gi[NDIM * v + a] = grad[kNvar * NDIM * static_cast<long long>(p)
                              + NDIM * v + a];
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
        d2 += dr[k] * dr[k];
      }
      if (!(d2 > T(0)) || !(d2 <= rad2)) continue;
      const T* pq = pk + kCols * static_cast<long long>(q);
#pragma unroll
      for (int v = 0; v < kNvar; ++v) {
        T s = gi[NDIM * v] * dr[0];
#pragma unroll
        for (int a = 1; a < NDIM; ++a) s += gi[NDIM * v + a] * dr[a];
        const T dW = T(0.51) * s;
        if (!(fabs(dW) > T(1e-300))) continue;
        T ratio;
        if (LIM == kTvdScalar)
          ratio = min(max((pq[kW + v] - Wi[v]) / dW, T(0)), T(1));
        else
          ratio = dW > T(0) ? mx[v] / dW : mn[v] / dW;
        alpha[v] = min(alpha[v], ratio);
      }
    }
  }
#pragma unroll
  for (int v = 0; v < kNvar; ++v)
    alpha_out[kNvar * static_cast<long long>(p) + v] = alpha[v];
}

template <typename T, int NDIM, int LIM>
__global__ void __launch_bounds__(256) mfv_limiter_kernel(
    const int* __restrict__ ids, const T* __restrict__ r,
    const T* __restrict__ pk, const T* __restrict__ grad,
    const T* __restrict__ dWmax, const T* __restrict__ dWmin, Grid3 g,
    int n_cells, bool flat, T kernrange, T* __restrict__ alpha) {
  if (flat) {
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
    if (t >= static_cast<long long>(n_cells) * g.K) return;
    limiter_slot<T, NDIM, LIM>(ids, r, pk, grad, dWmax, dWmin, g,
                               static_cast<int>(t / g.K),
                               static_cast<int>(t % g.K), kernrange, alpha);
    return;
  }
  for (int i = threadIdx.x; i < g.K; i += blockDim.x)
    limiter_slot<T, NDIM, LIM>(ids, r, pk, grad, dWmax, dWmin, g, blockIdx.x,
                               i, kernrange, alpha);
}

template <typename T, int NDIM>
void launch(const int* ids, const T* r, const T* pk, const T* grad,
            const T* dWmax, const T* dWmin, const Grid3& g, int n_cells,
            bool flat, T kernrange, int limiter, T* alpha,
            cudaStream_t stream) {
  const long long slots = static_cast<long long>(n_cells) * g.K;
  const int blocks = flat ? static_cast<int>((slots + kFlatThreads - 1)
                                             / kFlatThreads)
                          : n_cells;
  const int threads = flat ? kFlatThreads : slot_threads(g.K);
  if (limiter == kTvdScalar)
    mfv_limiter_kernel<T, NDIM, kTvdScalar><<<blocks, threads, 0, stream>>>(
        ids, r, pk, grad, dWmax, dWmin, g, n_cells, flat, kernrange, alpha);
  else
    mfv_limiter_kernel<T, NDIM, kSpringel2009>
        <<<blocks, threads, 0, stream>>>(ids, r, pk, grad, dWmax, dWmin, g,
                                         n_cells, flat, kernrange, alpha);
}

template <typename T>
int run_limiter(const int* ids, const T* r, const T* pk, const T* grad,
                const T* dWmax, const T* dWmin, int ndim, int n0, int n1,
                int n2, int k_cell, int per0, int per1, int per2, double L0,
                double L1, double L2, double kernrange, int limiter,
                int mapping, T* alpha, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ndim < 1 || ndim > 3 || limiter < 0 || limiter > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Grid3 g = {{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell};
  const int n_cells = n0 * n1 * n2;
  const bool flat = slot_mapping_flat(mapping, ndim, k_cell);
  if (n_cells > 0 && k_cell > 0) {
    if (ndim == 1)
      launch<T, 1>(ids, r, pk, grad, dWmax, dWmin, g, n_cells, flat,
                   T(kernrange), limiter, alpha, stream);
    else if (ndim == 2)
      launch<T, 2>(ids, r, pk, grad, dWmax, dWmin, g, n_cells, flat,
                   T(kernrange), limiter, alpha, stream);
    else
      launch<T, 3>(ids, r, pk, grad, dWmax, dWmin, g, n_cells, flat,
                   T(kernrange), limiter, alpha, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define MFV_LIMITER_ENTRY(NAME, T)                                          \
  int NAME(const int* ids, const T* r, const T* pk, const T* grad,          \
           const T* dWmax, const T* dWmin, int ndim, int n0, int n1,        \
           int n2, int k_cell, int per0, int per1, int per2, double L0,     \
           double L1, double L2, double kernrange, int limiter,             \
           int mapping, T* alpha, int device, void* stream) {               \
    return run_limiter<T>(ids, r, pk, grad, dWmax, dWmin, ndim, n0, n1, n2, \
                          k_cell, per0, per1, per2, L0, L1, L2, kernrange,  \
                          limiter, mapping, alpha, device, stream);         \
  }

MFV_LIMITER_ENTRY(mfv_limiter_f32, float)
MFV_LIMITER_ENTRY(mfv_limiter_f64, double)

}  // extern "C"
