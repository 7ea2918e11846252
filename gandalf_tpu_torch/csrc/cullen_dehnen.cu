// K21 cullen_dehnen: the Cullen & Dehnen (2010) viscosity switch over
// the 3^NDIM-cell stencil, in 1, 2 or 3 dims.
//
// Replaces gandalf_tpu/ops/forces.py:cullen_dehnen_dense (:267) and its
// finale _cd2010_finalize (:224) (GANDALF's
// Sph::ComputeCullenAndDehnenViscosity, src/Headers/Sph.h:360-456): three
// weighted outer-product sums accumulated over the shifted slices of
// ghost-layer copies, (N, ndim, ndim) each,
//   rr = sum w dr dr^T,  dvw = sum w dr dv^T,  daw = sum w dr da^T,
// w = m_j hfactor_i / (h_i rho_i) W'(|dr| / h_i), then per particle the
// guarded inverse T of rr (rr replaced by the identity where |det| <=
// 1e-30; "bad" there or where |rr|^2 |T|^2 / ndim^2 > 1e4), the velocity
// and acceleration gradients dvdx_ij = T_jk dvw_ki, the shock indicator
// ddivdt = tr(dadx) - dvdx : dvdx^T, the Balsara factor, the local
// target alpha_loc = min(10 h^2 / c^2 f (-ddivdt), alpha_visc) where
// ddivdt < 0 (alpha_visc where bad), alpha_new = max(alpha, alpha_loc)
// and dalpha/dt = 0.1 c (max(alpha_min, alpha_loc) - alpha_new) / h.
//
// Bound on the card: pair arithmetic and neighbour loads, as K3: about
// 4.6e8 pair candidates a pass at 262,144 particles in 3D, each loading
// its neighbour's position, velocity, acceleration and mass, and inside
// the support 3 ndim^2 multiply-adds.
//
// Design: one thread per slot of K1's slot map (particle id per slot, -1
// empty; the dead are binned out), mapped as K2 and K3 are (one block a
// cell in 3D with K >= 32, else flat over (cell, slot)), NDIM and the
// smoothing kernel (M4, quintic or gaussian, direct or tabulated:
// kernel_family.cuh) template parameters.  A thread keeps its 3 NDIM^2
// sums in registers and skips its own slot (identity) and coincident
// partners (d^2 = 0); a partner beyond the kernel's support (kernrange
// h_i) adds exactly zero and is skipped.  Any kernel but the direct M4
// sums d^2 in the plain version's rounded steps (kExactD2), so that s,
// and a table index, are the plain version's.  The finale runs inline:
// the closed-form inverse of csrc/mfv.cuh's kind (adjugate over the
// determinant), guarded as above.  Outputs are in particle order, each
// written once.  No shared-memory staging yet.
#include <cuda_runtime.h>

#include "grid27.cuh"
#include "kernel_family.cuh"

namespace {

// columns of the packed per-particle table: v (NDIM), a (NDIM), then
// these offsets past 2 NDIM (ops/forces.py:CD_COLS)
constexpr int kM = 0, kH = 1, kCoef = 2, kAlpha = 3, kSound = 4;

template <typename T, int N>
__device__ __forceinline__ T det_n(const T* a) {
  if (N == 1) return a[0];
  if (N == 2) return a[0] * a[3] - a[1] * a[2];
  return a[0] * (a[4] * a[8] - a[5] * a[7])
         - a[1] * (a[3] * a[8] - a[5] * a[6])
         + a[2] * (a[3] * a[7] - a[4] * a[6]);
}

// b = a^-1 by the adjugate over det (det != 0)
template <typename T, int N>
__device__ __forceinline__ void inverse_n(const T* a, T det, T* b) {
  if (N == 1) {
    b[0] = T(1) / det;
  } else if (N == 2) {
    b[0] = a[3] / det;
    b[1] = -a[1] / det;
    b[2] = -a[2] / det;
    b[3] = a[0] / det;
  } else {
    b[0] = (a[4] * a[8] - a[5] * a[7]) / det;
    b[1] = (a[2] * a[7] - a[1] * a[8]) / det;
    b[2] = (a[1] * a[5] - a[2] * a[4]) / det;
    b[3] = (a[5] * a[6] - a[3] * a[8]) / det;
    b[4] = (a[0] * a[8] - a[2] * a[6]) / det;
    b[5] = (a[2] * a[3] - a[0] * a[5]) / det;
    b[6] = (a[3] * a[7] - a[4] * a[6]) / det;
    b[7] = (a[1] * a[6] - a[0] * a[7]) / det;
    b[8] = (a[0] * a[4] - a[1] * a[3]) / det;
  }
}

template <typename T, int NDIM, class KF>
__device__ __forceinline__ void cd_slot(
    const int* __restrict__ ids, const T* __restrict__ r,
    const T* __restrict__ pk, const Grid3& g, int c, int i, const KF& kern,
    T alpha_visc, T alpha_min, T* __restrict__ alpha_out,
    T* __restrict__ dal_out, unsigned char* __restrict__ bad_out) {
  constexpr int kCols = 2 * NDIM + 5;
  constexpr int kNN = NDIM * NDIM;
  const int K = g.K;
  const int p = ids[static_cast<long long>(c) * K + i];
  if (p < 0) return;
  int cc[3];
  cell_coords(g, c, cc);
  const T* own = pk + kCols * static_cast<long long>(p);
  T xi[NDIM], vi[NDIM], ai[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    xi[k] = r[NDIM * static_cast<long long>(p) + k];
    vi[k] = own[k];
    ai[k] = own[NDIM + k];
  }
  const T* sc = own + 2 * NDIM;
  const T h = max(sc[kH], T(1e-30));
  const T invh = T(1) / h;
  const T wfac = invh * sc[kCoef];
  T rr[kNN], dvw[kNN], daw[kNN];
#pragma unroll
  for (int k = 0; k < kNN; ++k) rr[k] = dvw[k] = daw[k] = T(0);
  for (int d = 0; d < Stencil<NDIM>::kSize; ++d) {
    int nc;
    T sh[3];
    if (!neighbour_cell<T, NDIM>(g, cc, d, &nc, sh)) continue;
    const int* slots = ids + static_cast<long long>(nc) * K;
    for (int j = 0; j < K; ++j) {
      const int q = slots[j];
      if (q < 0 || q == p) continue;
      T dr[NDIM];
      T d2 = T(0);
#pragma unroll
      for (int k = 0; k < NDIM; ++k) {
        dr[k] = (r[NDIM * static_cast<long long>(q) + k] + sh[k]) - xi[k];
        if (KF::kExactD2)
          d2 = kf::add(d2, kf::mul(dr[k], dr[k]));
        else
          d2 += dr[k] * dr[k];
      }
      if (!(d2 > T(0))) continue;
      const T s = sqrt(d2) * invh;
      if (!kern.in_support(s)) continue;  // W' = 0 from the edge on
      const T* pq = pk + kCols * static_cast<long long>(q);
      const T w = pq[2 * NDIM + kM] * wfac * kern.w1(s);
      T dv[NDIM], da[NDIM];
#pragma unroll
      for (int k = 0; k < NDIM; ++k) {
        dv[k] = pq[k] - vi[k];
        da[k] = pq[NDIM + k] - ai[k];
      }
#pragma unroll
      for (int a = 0; a < NDIM; ++a) {
        const T wa = w * dr[a];
#pragma unroll
        for (int b = 0; b < NDIM; ++b) {
          rr[NDIM * a + b] += wa * dr[b];
          dvw[NDIM * a + b] += wa * dv[b];
          daw[NDIM * a + b] += wa * da[b];
        }
      }
    }
  }
  // the finale (_cd2010_finalize)
  const T det = det_n<T, NDIM>(rr);
  const bool det_ok = fabs(det) > T(1e-30);
  T safe[kNN], tinv[kNN];
#pragma unroll
  for (int a = 0; a < NDIM; ++a)
#pragma unroll
    for (int b = 0; b < NDIM; ++b)
      safe[NDIM * a + b] = det_ok ? rr[NDIM * a + b]
                                  : (a == b ? T(1) : T(0));
  inverse_n<T, NDIM>(safe, det_ok ? det : T(1), tinv);
  T modR = T(0), modT = T(0);
#pragma unroll
  for (int k = 0; k < kNN; ++k) {
    modR += rr[k] * rr[k];
    modT += tinv[k] * tinv[k];
  }
  const bool bad = !det_ok || modR * modT / T(kNN) > T(1e4);
  // dvdx[a][b] = sum_k T[b][k] dvw[k][a]
  T dvdx[kNN];
  T tr_dadx = T(0);
#pragma unroll
  for (int a = 0; a < NDIM; ++a) {
#pragma unroll
    for (int b = 0; b < NDIM; ++b) {
      T x = T(0);
#pragma unroll
      for (int k = 0; k < NDIM; ++k)
        x += tinv[NDIM * b + k] * dvw[NDIM * k + a];
      dvdx[NDIM * a + b] = x;
    }
    T y = T(0);
#pragma unroll
    for (int k = 0; k < NDIM; ++k) y += tinv[NDIM * a + k] * daw[NDIM * k + a];
    tr_dadx += y;
  }
  T divv = T(0), contr = T(0), curl2 = T(0);
#pragma unroll
  for (int a = 0; a < NDIM; ++a) {
    divv += dvdx[NDIM * a + a];
#pragma unroll
    for (int b = 0; b < NDIM; ++b) {
      contr += dvdx[NDIM * a + b] * dvdx[NDIM * b + a];
      const T cu = dvdx[NDIM * a + b] - dvdx[NDIM * b + a];
      curl2 += cu * cu;
    }
  }
  const T ddivdt = tr_dadx - contr;
  const T divv2 = divv * divv;
  const T curlv2 = T(0.5) * curl2;
  const T f_bal = curlv2 > T(0) ? divv2 / max(divv2 + curlv2, T(1e-30))
                                : T(1);
  const T sound = sc[kSound];
  const T c2 = max(sound * sound, T(1e-30));
  T alpha_loc = ddivdt < T(0)
                    ? min(T(10) * h * h / c2 * f_bal * (-ddivdt), alpha_visc)
                    : T(0);
  if (bad) alpha_loc = alpha_visc;
  const T alpha_new = max(sc[kAlpha], alpha_loc);
  alpha_out[p] = alpha_new;
  dal_out[p] = T(0.1) * sound * (max(alpha_min, alpha_loc) - alpha_new)
               * invh;
  bad_out[p] = bad ? 1 : 0;
}

template <typename T, int NDIM, bool kFlat, class KF>
__global__ void __launch_bounds__(256) cullen_dehnen_kernel(
    const int* __restrict__ ids, const T* __restrict__ r,
    const T* __restrict__ pk, Grid3 g, int n_cells, KF kern, T alpha_visc,
    T alpha_min, T* __restrict__ alpha_out, T* __restrict__ dal_out,
    unsigned char* __restrict__ bad_out) {
  if (kFlat) {
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
    if (t >= static_cast<long long>(n_cells) * g.K) return;
    cd_slot<T, NDIM>(ids, r, pk, g, static_cast<int>(t / g.K),
                     static_cast<int>(t % g.K), kern, alpha_visc, alpha_min,
                     alpha_out, dal_out, bad_out);
    return;
  }
  for (int i = threadIdx.x; i < g.K; i += blockDim.x)
    cd_slot<T, NDIM>(ids, r, pk, g, blockIdx.x, i, kern, alpha_visc,
                     alpha_min, alpha_out, dal_out, bad_out);
}

template <typename T, int NDIM, class KF>
void launch_cd(const int* ids, const T* r, const T* pk, const Grid3& g,
               int n_cells, const KF& kern, T alpha_visc, T alpha_min,
               T* alpha, T* dal, unsigned char* bad, bool flat,
               cudaStream_t stream) {
  if (flat) {
    const long long slots = static_cast<long long>(n_cells) * g.K;
    const int blocks =
        static_cast<int>((slots + kFlatThreads - 1) / kFlatThreads);
    cullen_dehnen_kernel<T, NDIM, true, KF><<<blocks, kFlatThreads, 0,
                                              stream>>>(
        ids, r, pk, g, n_cells, kern, alpha_visc, alpha_min, alpha, dal,
        bad);
  } else {
    cullen_dehnen_kernel<T, NDIM, false, KF><<<n_cells, slot_threads(g.K),
                                               0, stream>>>(
        ids, r, pk, g, n_cells, kern, alpha_visc, alpha_min, alpha, dal,
        bad);
  }
}

template <typename T>
int run_cd(const int* ids, const T* r, const T* pk, int ndim, int n0,
           int n1, int n2, int k_cell, int per0, int per1, int per2,
           double L0, double L1, double L2, double norm, int family,
           int res, double alpha_visc, double alpha_min, T* alpha, T* dal,
           unsigned char* bad, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ndim < 1 || ndim > 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Grid3 g = {{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell};
  const int n_cells = n0 * n1 * n2;
  const bool flat = slot_mapping_flat(0, ndim, k_cell);
  if (n_cells > 0 && k_cell > 0) {
    const T av = T(alpha_visc), amin = T(alpha_min);
    const bool known = kf::with_kernel<T>(
        family, res, norm, ndim, [&](const auto& kern) {
          if (ndim == 1)
            launch_cd<T, 1>(ids, r, pk, g, n_cells, kern, av, amin, alpha,
                            dal, bad, flat, stream);
          else if (ndim == 2)
            launch_cd<T, 2>(ids, r, pk, g, n_cells, kern, av, amin, alpha,
                            dal, bad, flat, stream);
          else
            launch_cd<T, 3>(ids, r, pk, g, n_cells, kern, av, amin, alpha,
                            dal, bad, flat, stream);
        });
    if (!known) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define CULLEN_DEHNEN_ENTRY(NAME, T)                                        \
  int NAME(const int* ids, const T* r, const T* pk, int ndim, int n0,       \
           int n1, int n2, int k_cell, int per0, int per1, int per2,        \
           double L0, double L1, double L2, double norm, int family,        \
           int res, double alpha_visc, double alpha_min, T* alpha, T* dal,  \
           unsigned char* bad, int device, void* stream) {                  \
    return run_cd<T>(ids, r, pk, ndim, n0, n1, n2, k_cell, per0, per1,      \
                     per2, L0, L1, L2, norm, family, res, alpha_visc,       \
                     alpha_min, alpha, dal, bad, device, stream);           \
  }

CULLEN_DEHNEN_ENTRY(cullen_dehnen_f32, float)
CULLEN_DEHNEN_ENTRY(cullen_dehnen_f64, double)

}  // extern "C"
