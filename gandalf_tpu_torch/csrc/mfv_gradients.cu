// K11 mfv_gradients: least-squares gradient matrices, primitive gradients
// and the cell limiter of the meshless finite-volume scheme over the
// 3^NDIM-cell stencil, in 1, 2 or 3 dims.
//
// Replaces gandalf_tpu/ops/mfv_grid27.py:gradients_mfv_grid27 (:198-279)
// with gandalf_tpu/ops/mfv.py:gradient_accumulate and gradient_finalize
// (:194-285): there the running sums are (N, ...) arrays accumulated over
// 3^ndim shifted slices of ghost-layer copies and finished by elementwise
// XLA code.
//
// Bound on the card: pair arithmetic and the load of each neighbour (its
// position, W and sound speed, 2 NDIM + 3 values).  One pass is about
// 4.6e8 pair candidates at 262,144 particles in 3D; a pair inside the
// support costs a square root, two kernel polynomials and some 60
// multiply-adds for E and the two gradient sums (3D).
//
// Design: K2's layout, one thread per slot of K1's slot map (one block
// per cell in 3D with K >= 32, else flat over (cell, slot); NDIM a
// template parameter).  A thread keeps its particle's running sums in
// registers: E (NDIM x NDIM), grad_tmp and grad_sph (nvar x NDIM each,
// nvar = NDIM + 2), vsig_max, Wmax and Wmin (nvar each) and drmax^2.  E
// and the gradient sums take every pair with d^2 > 0 (so the particle
// itself and coincident partners drop out), weighted by the compact
// kernel; vsig, Wmax/Wmin and drmax take the pairs within kernrange h_i
// only.  A cell's sweep ends at its first empty slot.  The finish runs in
// the kernel too: the inverse B (1/E in 1D, the adjugate in 2D and 3D),
// the condition guard |E|^2 |B|^2 / NDIM^2 >= 1e4 that selects the SPH
// gradient, vsig_max >= sound and the cell alphas.  With `dWmax` given,
// it also writes the signed extrema max(Wmax, W) - W and min(Wmin, W) - W
// that the per-neighbour limiter sweep (K31) reads.  Outputs are in
// particle order.  No shared-memory staging yet: that is later work.
//
// The smoothing kernel (kernel_family.cuh) is a template parameter: W
// comes through the s^2 form (w0_s2 at d^2 / h_i^2, as ops/mfv.py's
// gradient terms take it) and W' through the s form (w1 at |dr| / h_i),
// so a tabulated kernel quantises each on its own grid; a pair is
// skipped only where both forms vanish and it lies beyond kernrange h_i.
// Any kernel but the direct M4 sums d^2 in the plain version's rounded
// steps (kExactD2).
#include <cuda_runtime.h>

#include "grid27.cuh"
#include "kernel_family.cuh"
#include "mfv.cuh"

namespace {

// the floor of the edge distance drmax, in units of h: gradient_finalize's
// own 2 h whatever the kernel (not the kernel's range)
constexpr double kDrmaxFloor = 2.0;

template <typename T, int NDIM, class KF>
__device__ __forceinline__ void gradient_slot(
    const int* __restrict__ ids, const T* __restrict__ r,
    const T* __restrict__ pk, const Grid3& g, int c, int i, const KF& kern,
    T* __restrict__ B_out, T* __restrict__ grad_out,
    T* __restrict__ alpha_out, T* __restrict__ vsig_out,
    unsigned char* __restrict__ bad_out, T* __restrict__ dWmax_out,
    T* __restrict__ dWmin_out) {
  constexpr int kNvar = mfv::Dims<NDIM>::kNvar;
  // columns of the packed table (ops/mfv_grid27.py:gradients)
  constexpr int kH = 0, kNdens = 1, kW = 2, kSound = 2 + kNvar;
  constexpr int kCols = kSound + 1;
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
  const T invh = T(1) / h;
  const T invhsqd = invh * invh;
  T invh_nd = invh;
#pragma unroll
  for (int k = 1; k < NDIM; ++k) invh_nd *= invh;
  const T wnorm = invh_nd / max(own[kNdens], T(1e-300));
  const T w1norm = invh_nd * invh / max(own[kNdens], T(1e-300));
  const T sound = own[kSound];
  const T rad2 = (KF::range() * h) * (KF::range() * h);
  T Wi[kNvar];
#pragma unroll
  for (int v = 0; v < kNvar; ++v) Wi[v] = own[kW + v];
  T E[NDIM * NDIM], gt[kNvar * NDIM], gs[kNvar * NDIM], Wmax[kNvar],
      Wmin[kNvar];
#pragma unroll
  for (int k = 0; k < NDIM * NDIM; ++k) E[k] = T(0);
#pragma unroll
  for (int k = 0; k < kNvar * NDIM; ++k) gt[k] = gs[k] = T(0);
#pragma unroll
  for (int v = 0; v < kNvar; ++v) {
    Wmax[v] = T(-1e30);
    Wmin[v] = T(1e30);
  }
  T vsig_max = T(0), drmax2 = T(0);
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
        if (KF::kExactD2)
          d2 = kf::add(d2, kf::mul(dr[k], dr[k]));
        else
          d2 += dr[k] * dr[k];
      }
      if (!(d2 > T(0))) continue;
      const T drmag = sqrt(d2);
      const T ssqd = d2 * invhsqd, s1 = drmag * invh;
      if (d2 > rad2 && !kern.in_support(s1) && !kern.in_support_s2(ssqd))
        continue;  // W, W' and the kernel-range statistics are all 0
      const T* pq = pk + kCols * static_cast<long long>(q);
      T dW[kNvar];
#pragma unroll
      for (int v = 0; v < kNvar; ++v) dW[v] = pq[kW + v] - Wi[v];
      const T w = wnorm * kern.w0_s2(ssqd);
      const T w1 = w1norm * kern.w1(s1);
      T unit[NDIM];
#pragma unroll
      for (int k = 0; k < NDIM; ++k) unit[k] = dr[k] / drmag;
#pragma unroll
      for (int a = 0; a < NDIM; ++a)
#pragma unroll
        for (int b = 0; b < NDIM; ++b) E[NDIM * a + b] += w * dr[a] * dr[b];
#pragma unroll
      for (int v = 0; v < kNvar; ++v)
#pragma unroll
        for (int a = 0; a < NDIM; ++a) {
          gt[NDIM * v + a] += w * dW[v] * dr[a];
          gs[NDIM * v + a] -= w1 * dW[v] * unit[a];
        }
      if (d2 <= rad2) {
        T dvdr = (pq[kW] - Wi[0]) * dr[0];
#pragma unroll
        for (int k = 1; k < NDIM; ++k) dvdr += (pq[kW + k] - Wi[k]) * dr[k];
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
  T B[NDIM * NDIM];
  mfv::invert<T, NDIM>(E, B);
  T modE = T(0), modB = T(0);
#pragma unroll
  for (int k = 0; k < NDIM * NDIM; ++k) {
    modE += E[k] * E[k];
    modB += B[k] * B[k];
  }
  const bool bad = modE * modB / T(NDIM * NDIM) >= T(1e4);
  T grad[kNvar * NDIM];
#pragma unroll
  for (int v = 0; v < kNvar; ++v)
#pragma unroll
    for (int a = 0; a < NDIM; ++a) {
      T s = B[NDIM * a] * gt[NDIM * v];
#pragma unroll
      for (int b = 1; b < NDIM; ++b) s += B[NDIM * a + b] * gt[NDIM * v + b];
      grad[NDIM * v + a] = bad ? gs[NDIM * v + a] : s;
    }
  const T drmax = max(sqrt(drmax2), T(kDrmaxFloor) * h) * T(0.51);
  T* alpha = alpha_out + kNvar * static_cast<long long>(p);
#pragma unroll
  for (int v = 0; v < kNvar; ++v) {
    T g2 = grad[NDIM * v] * grad[NDIM * v];
#pragma unroll
    for (int a = 1; a < NDIM; ++a)
      g2 += grad[NDIM * v + a] * grad[NDIM * v + a];
    const T dWlim = drmax * sqrt(g2);
    const T dWmax = max(Wmax[v], Wi[v]) - Wi[v];
    const T dWmin = Wi[v] - min(Wmin[v], Wi[v]);
    const T lim = max(dWlim, T(1e-300));
    alpha[v] = dWlim != T(0)
                   ? min(max(min(dWmax / lim, dWmin / lim), T(0)), T(1))
                   : T(1);
    if (dWmax_out != nullptr) {
      dWmax_out[kNvar * static_cast<long long>(p) + v] = dWmax;
      dWmin_out[kNvar * static_cast<long long>(p) + v] =
          min(Wmin[v], Wi[v]) - Wi[v];
    }
  }
#pragma unroll
  for (int k = 0; k < NDIM * NDIM; ++k)
    B_out[NDIM * NDIM * static_cast<long long>(p) + k] = B[k];
#pragma unroll
  for (int k = 0; k < kNvar * NDIM; ++k)
    grad_out[kNvar * NDIM * static_cast<long long>(p) + k] = grad[k];
  vsig_out[p] = max(vsig_max, sound);
  bad_out[p] = bad ? 1 : 0;
}

template <typename T, int NDIM, class KF>
__global__ void __launch_bounds__(256) mfv_gradients_kernel(
    const int* __restrict__ ids, const T* __restrict__ r,
    const T* __restrict__ pk, Grid3 g, int n_cells, bool flat, KF kern,
    T* __restrict__ B, T* __restrict__ grad,
    T* __restrict__ alpha, T* __restrict__ vsig,
    unsigned char* __restrict__ bad, T* __restrict__ dWmax,
    T* __restrict__ dWmin) {
  if (flat) {
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
    if (t >= static_cast<long long>(n_cells) * g.K) return;
    gradient_slot<T, NDIM>(ids, r, pk, g, static_cast<int>(t / g.K),
                           static_cast<int>(t % g.K), kern, B, grad, alpha,
                           vsig, bad, dWmax, dWmin);
    return;
  }
  for (int i = threadIdx.x; i < g.K; i += blockDim.x)
    gradient_slot<T, NDIM>(ids, r, pk, g, blockIdx.x, i, kern, B, grad,
                           alpha, vsig, bad, dWmax, dWmin);
}

template <typename T, int NDIM, class KF>
void launch(const int* ids, const T* r, const T* pk, const Grid3& g,
            int n_cells, bool flat, const KF& kern, T* B, T* grad,
            T* alpha, T* vsig, unsigned char* bad, T* dWmax, T* dWmin,
            cudaStream_t stream) {
  const long long slots = static_cast<long long>(n_cells) * g.K;
  const int blocks = flat ? static_cast<int>((slots + kFlatThreads - 1)
                                             / kFlatThreads)
                          : n_cells;
  const int threads = flat ? kFlatThreads : slot_threads(g.K);
  mfv_gradients_kernel<T, NDIM, KF><<<blocks, threads, 0, stream>>>(
      ids, r, pk, g, n_cells, flat, kern, B, grad, alpha, vsig, bad, dWmax,
      dWmin);
}

template <typename T>
int run_gradients(const int* ids, const T* r, const T* pk, int ndim, int n0,
                  int n1, int n2, int k_cell, int per0, int per1, int per2,
                  double L0, double L1, double L2, double norm, int family,
                  int res, int mapping, T* B, T* grad, T* alpha,
                  T* vsig, unsigned char* bad, T* dWmax, T* dWmin,
                  int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ndim < 1 || ndim > 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Grid3 g = {{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell};
  const int n_cells = n0 * n1 * n2;
  const bool flat = slot_mapping_flat(mapping, ndim, k_cell);
  if (n_cells > 0 && k_cell > 0) {
    const bool known = kf::with_kernel<T>(
        family, res, norm, ndim, [&](const auto& kern) {
          if (ndim == 1)
            launch<T, 1>(ids, r, pk, g, n_cells, flat, kern, B, grad, alpha,
                         vsig, bad, dWmax, dWmin, stream);
          else if (ndim == 2)
            launch<T, 2>(ids, r, pk, g, n_cells, flat, kern, B, grad, alpha,
                         vsig, bad, dWmax, dWmin, stream);
          else
            launch<T, 3>(ids, r, pk, g, n_cells, flat, kern, B, grad, alpha,
                         vsig, bad, dWmax, dWmin, stream);
        });
    if (!known) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define MFV_GRADIENTS_ENTRY(NAME, T)                                        \
  int NAME(const int* ids, const T* r, const T* pk, int ndim, int n0,       \
           int n1, int n2, int k_cell, int per0, int per1, int per2,        \
           double L0, double L1, double L2, double norm, int family,        \
           int res, int mapping, T* B, T* grad, T* alpha, T* vsig,          \
           unsigned char* bad, T* dWmax, T* dWmin, int device,              \
           void* stream) {                                                  \
    return run_gradients<T>(ids, r, pk, ndim, n0, n1, n2, k_cell, per0,     \
                            per1, per2, L0, L1, L2, norm, family, res,      \
                            mapping, B, grad, alpha, vsig, bad, dWmax,      \
                            dWmin, device, stream);                         \
  }

MFV_GRADIENTS_ENTRY(mfv_gradients_f32, float)
MFV_GRADIENTS_ENTRY(mfv_gradients_f64, double)

}  // extern "C"
