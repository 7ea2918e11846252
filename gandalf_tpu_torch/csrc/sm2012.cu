// K25 sm2012_density and K26 sm2012_forces: Saitoh & Makino (2012)
// density-independent SPH over the 3^NDIM-cell stencil, in 1, 2 or 3
// dims.
//
// Replaces gandalf_tpu/ops/sm2012.py:sm2012_hydro_pass_grid (:184-251),
// which gathers an (N, 3^ndim K) candidate block per particle
// (ops/active_grid.py:gather_active_candidates) and runs
// ops/density.py:compute_h (:68-135) and the q sum over it (K25, :198-
// 216), then sm2012_forces_view (:124-181) over the same block (K26,
// :228-246).  GANDALF's SM2012Sph::ComputeH and ComputeSphHydroForces.
//
// K25 runs each particle's h-rho iteration from its own h, unclamped,
// with the bracket [0, hmax] (fixed-point steps 0..29, bisection up to
// step 149, as K8; K2 clamps instead), sums rho = h^-ndim sum m_j W, then
// takes h = h_fac (m/rho)^(1/ndim) from the last rho (not the last
// iterated h) and sums q = h^-ndim sum m_j u_j W at that h, with hfactor
// = h^-(ndim+1) and the converged flag.  K26 sums, for each pair with
// d^2 > 0 (a particle's own slot and coincident particles drop out before
// any division), w_i = hfactor_i W'(r/h_i) and w_j from the neighbour's h
// and hfactor, the pressure-energy term (gamma-1)/2 u_i u_j (1/q_i +
// 1/q_j)(w_i + w_j), q floored at 1e-30, the compression term, div v and
// mon97 viscosity on approaching pairs (alpha fixed or the pair's mean).
// Pressure and sound speed are the adiabatic ones, computed in torch
// between the two launches.
//
// Bound on the card: the candidate loads and the pair arithmetic, as K2
// and K3.  Every particle sweeps the filled slots of its 3^NDIM cells
// (K1 fills a cell's slots from 0 up, so a cell's sweep ends at its first
// empty slot); K25 sweeps them once per iteration and once more for q.
// The operations the data needs are counted in check.FLOPS_PER.
//
// Design: one thread per slot of K1's slot map (particle id per slot, -1
// empty; the dead are binned out), flat over (cell, slot) as K23, NDIM and
// the smoothing kernel (M4, quintic or gaussian, direct or tabulated:
// kernel_family.cuh) template parameters, positions shifted by the box
// length on periodic dims (no ghost copies).  K25 takes W in its s^2 form
// at d^2 / h^2 (w0_s2, as compute_h and the q sum do), K26 W' in its s
// form on both sides, |dr| / h_i with the product by 1/h_i and |dr| / h_j
// with a division, as sm2012_forces_view rounds them; any kernel but the
// direct M4 sums d^2 in the plain version's rounded steps (kExactD2), so
// that a table index is the plain version's.  A thread keeps its sums in
// registers and writes each output once, in particle order, so no
// atomics; a particle without a slot keeps the wrapper's values.  No
// shared-memory staging yet: that is later work.
#include <cuda_runtime.h>

#include <type_traits>

#include "grid27.cuh"
#include "kernel_family.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kIterFixedPoint = 30;
constexpr int kIterMax = 150;
// columns of the packed scalars (ops/sm2012.py:SM_SCALARS)
constexpr int kM = 0, kU = 1, kH = 2, kRho = 3, kQ = 4, kHfac = 5,
              kSound = 6, kAlpha = 7, kCols = 8;
// artificial viscosity codes of ops/forces.py
constexpr int kAviscNone = 0, kAviscMon97mm97 = 2;

template <typename T, int NDIM>
__device__ __forceinline__ T ipow(T x) {
  return NDIM == 1 ? x : NDIM == 2 ? x * x : x * x * x;
}

struct GridArgs {
  Grid3 g;
  int n_cells;
};

GridArgs make_grid(int n0, int n1, int n2, int k_cell, int per0, int per1,
                   int per2, double L0, double L1, double L2) {
  GridArgs A;
  A.g = {{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell};
  A.n_cells = n0 * n1 * n2;
  return A;
}

// sum over the filled candidates of slot t's cell stencil of
// m_j [u_j] W at s^2 = d^2 invhsqd (times u_j when `with_u`)
template <typename T, int NDIM, bool kWithU, class KF>
__device__ __forceinline__ T w0_sum(const int* __restrict__ ids,
                                    const T* __restrict__ r,
                                    const T* __restrict__ m,
                                    const T* __restrict__ u, const Grid3& g,
                                    const int cc[3], const T xi[NDIM],
                                    T invhsqd, const KF& kern) {
  const int K = g.K;
  T sum = T(0);
  for (int d = 0; d < Stencil<NDIM>::kSize; ++d) {
    int nc;
    T sh[3];
    if (!neighbour_cell<T, NDIM>(g, cc, d, &nc, sh)) continue;
    const int* slots = ids + static_cast<long long>(nc) * K;
    for (int j = 0; j < K; ++j) {
      const int q = slots[j];
      if (q < 0) break;  // K1 fills a cell's slots from 0 up
      T d2 = T(0);
#pragma unroll
      for (int k = 0; k < NDIM; ++k) {
        const T dk = (r[NDIM * static_cast<long long>(q) + k] + sh[k])
                     - xi[k];
        if (KF::kExactD2)
          d2 = kf::add(d2, kf::mul(dk, dk));
        else
          d2 += dk * dk;
      }
      const T ssqd = d2 * invhsqd;
      if (!kern.in_support_s2(ssqd)) continue;  // W is zero there
      const T w = kern.w0_s2(ssqd);
      sum += kWithU ? (m[q] * u[q]) * w : m[q] * w;
    }
  }
  return sum;
}

template <typename T, int NDIM, class KF>
__global__ void __launch_bounds__(kThreads) sm2012_density_kernel(
    const int* __restrict__ ids, const T* __restrict__ r,
    const T* __restrict__ m, const T* __restrict__ u,
    const T* __restrict__ h, GridArgs A, KF kern, T h_fac, T h_converge,
    T hmax, T* __restrict__ h_out, T* __restrict__ rho_out,
    T* __restrict__ q_out, T* __restrict__ hfac_out,
    unsigned char* __restrict__ done_out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const Grid3& g = A.g;
  if (t >= static_cast<long long>(A.n_cells) * g.K) return;
  const int p = ids[t];
  if (p < 0) return;
  int cc[3];
  cell_coords(g, static_cast<int>(t / g.K), cc);
  T xi[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) xi[k] = r[NDIM * static_cast<long long>(p) + k];
  const T invndim = T(1.0 / NDIM);
  const T m_i = m[p];
  T hh = h[p];
  T lo = T(0), hi = hmax;
  T rho = T(0);
  bool conv = false;
  for (int it = 0; it < kIterMax; ++it) {
    const T invh = T(1) / hh;
    rho = ipow<T, NDIM>(invh)
          * w0_sum<T, NDIM, false>(ids, r, m, u, g, cc, xi, invh * invh,
                                   kern);
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
  // h from the last rho, and q at that h (not at the last iterated h)
  const T h_fin = max(h_fac * pow(m_i / max(rho, T(1e-300)), invndim), T(0));
  const T invh = T(1) / h_fin;
  const T hfac = ipow<T, NDIM>(invh);
  h_out[p] = h_fin;
  rho_out[p] = rho;
  q_out[p] = hfac * w0_sum<T, NDIM, true>(ids, r, m, u, g, cc, xi,
                                          invh * invh, kern);
  hfac_out[p] = hfac * invh;
  done_out[p] = conv ? 1 : 0;
}

struct ForceArgs {
  double gamma, alpha_visc, beta_visc;
  int avisc;
};

template <typename T, int NDIM, class KF>
__global__ void __launch_bounds__(kThreads) sm2012_forces_kernel(
    const int* __restrict__ ids, const T* __restrict__ r,
    const T* __restrict__ v, const T* __restrict__ pk, GridArgs A,
    KF kern, ForceArgs F, T* __restrict__ a_out, T* __restrict__ dudt_out,
    T* __restrict__ divv_out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const Grid3& g = A.g;
  const int K = g.K;
  if (t >= static_cast<long long>(A.n_cells) * K) return;
  const int p = ids[t];
  if (p < 0) return;
  int cc[3];
  cell_coords(g, static_cast<int>(t / K), cc);
  const T c_half = T(0.5 * (F.gamma - 1.0));
  const T alpha_visc = T(F.alpha_visc), beta = T(F.beta_visc);
  const T beta_alpha = T(F.beta_visc * F.alpha_visc);
  T xi[NDIM], vi[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    xi[k] = r[NDIM * static_cast<long long>(p) + k];
    vi[k] = v[NDIM * static_cast<long long>(p) + k];
  }
  const T* own = pk + kCols * static_cast<long long>(p);
  const T u_i = own[kU], rho_i = own[kRho], hfac_i = own[kHfac];
  const T sound_i = own[kSound], alpha_i = own[kAlpha];
  const T invh_i = T(1) / own[kH];
  const T invq_i = T(1) / max(own[kQ], T(1e-30));
  const T invrho_i = T(1) / max(rho_i, T(1e-30));
  T acc[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) acc[k] = T(0);
  T s_div = T(0), s_du = T(0), s_visc = T(0);
  for (int d = 0; d < Stencil<NDIM>::kSize; ++d) {
    int nc;
    T sh[3];
    if (!neighbour_cell<T, NDIM>(g, cc, d, &nc, sh)) continue;
    const int* slots = ids + static_cast<long long>(nc) * K;
    for (int j = 0; j < K; ++j) {
      const int q = slots[j];
      if (q < 0) break;  // K1 fills a cell's slots from 0 up
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
      if (!(d2 > T(0))) continue;  // itself, or coincident
      const T* nb = pk + kCols * static_cast<long long>(q);
      const T drmag = sqrt(d2);
      const T s_i = drmag * invh_i, s_j = drmag / nb[kH];
      // both W' are zero
      if (!kern.in_support(s_i) && !kern.in_support(s_j)) continue;
      const T wki = hfac_i * kern.w1(s_i);
      const T wkj = nb[kHfac] * kern.w1(s_j);
      const T wsum = wki + wkj;
      T unit[NDIM];
      T dvdr = T(0);
#pragma unroll
      for (int k = 0; k < NDIM; ++k) {
        unit[k] = dr[k] / drmag;
        dvdr += (v[NDIM * static_cast<long long>(q) + k] - vi[k]) * unit[k];
      }
      const T m_j = nb[kM], u_j = nb[kU];
      s_div += m_j * dvdr * wki;
      T paux = c_half * u_i * u_j * (invq_i + T(1) / max(nb[kQ], T(1e-30)))
               * wsum;
      s_du += m_j * u_j * dvdr * wsum;
      if (F.avisc != kAviscNone && dvdr < T(0)) {
        const T winvrho = T(0.25) * wsum
                          * (invrho_i + T(1) / max(nb[kRho], T(1e-30)));
        T alpha_eff, vsig;
        if (F.avisc == kAviscMon97mm97) {
          alpha_eff = T(0.5) * (alpha_i + nb[kAlpha]);
          vsig = sound_i + nb[kSound] - beta * alpha_eff * dvdr;
        } else {
          alpha_eff = alpha_visc;
          vsig = sound_i + nb[kSound] - beta_alpha * dvdr;
        }
        paux -= alpha_eff * vsig * dvdr * winvrho;
        s_visc += T(0.5) * m_j * alpha_eff * vsig * dvdr * dvdr * winvrho;
      }
#pragma unroll
      for (int k = 0; k < NDIM; ++k) acc[k] += m_j * paux * unit[k];
    }
  }
#pragma unroll
  for (int k = 0; k < NDIM; ++k) a_out[NDIM * static_cast<long long>(p) + k] = acc[k];
  dudt_out[p] = c_half * u_i * invq_i * s_du - s_visc;
  divv_out[p] = -s_div / max(rho_i, T(1e-30));
}

inline int blocks_for(const GridArgs& A) {
  const long long slots = static_cast<long long>(A.n_cells) * A.g.K;
  return static_cast<int>((slots + kThreads - 1) / kThreads);
}

template <typename T>
int run_density(const int* ids, const T* r, const T* m, const T* u,
                const T* h, int ndim, int n0, int n1, int n2, int k_cell,
                int per0, int per1, int per2, double L0, double L1,
                double L2, double norm, int family, int res, double h_fac,
                double h_converge, double hmax, T* h_out, T* rho, T* q,
                T* hfac, unsigned char* done, int device,
                void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ndim < 1 || ndim > 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const GridArgs A = make_grid(n0, n1, n2, k_cell, per0, per1, per2, L0,
                               L1, L2);
  if (A.n_cells > 0 && k_cell > 0) {
    const int blocks = blocks_for(A);
    const bool known = kf::with_kernel<T>(
        family, res, norm, ndim, [&](const auto& kern) {
          using KF = std::decay_t<decltype(kern)>;
#define SM_DENSITY(ND)                                                       \
  sm2012_density_kernel<T, ND, KF><<<blocks, kThreads, 0, stream>>>(         \
      ids, r, m, u, h, A, kern, T(h_fac), T(h_converge), T(hmax), h_out,    \
      rho, q, hfac, done)
          if (ndim == 1)
            SM_DENSITY(1);
          else if (ndim == 2)
            SM_DENSITY(2);
          else
            SM_DENSITY(3);
#undef SM_DENSITY
        });
    if (!known) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_forces(const int* ids, const T* r, const T* v, const T* pk,
               int ndim, int n0, int n1, int n2, int k_cell, int per0,
               int per1, int per2, double L0, double L1, double L2,
               double norm, int family, int res, double gamma, int avisc,
               double alpha_visc, double beta_visc, T* a, T* dudt, T* divv,
               int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ndim < 1 || ndim > 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const GridArgs A = make_grid(n0, n1, n2, k_cell, per0, per1, per2, L0,
                               L1, L2);
  const ForceArgs F = {gamma, alpha_visc, beta_visc, avisc};
  if (A.n_cells > 0 && k_cell > 0) {
    const int blocks = blocks_for(A);
    const bool known = kf::with_kernel<T>(
        family, res, norm, ndim, [&](const auto& kern) {
          using KF = std::decay_t<decltype(kern)>;
#define SM_FORCES(ND)                                                 \
  sm2012_forces_kernel<T, ND, KF><<<blocks, kThreads, 0, stream>>>(   \
      ids, r, v, pk, A, kern, F, a, dudt, divv)
          if (ndim == 1)
            SM_FORCES(1);
          else if (ndim == 2)
            SM_FORCES(2);
          else
            SM_FORCES(3);
#undef SM_FORCES
        });
    if (!known) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define SM2012_DENSITY_ENTRY(NAME, T)                                       \
  int NAME(const int* ids, const T* r, const T* m, const T* u, const T* h,  \
           int ndim, int n0, int n1, int n2, int k_cell, int per0,          \
           int per1, int per2, double L0, double L1, double L2,             \
           double norm, int family, int res, double h_fac,                  \
           double h_converge, double hmax, T* h_out, T* rho, T* q, T* hfac, \
           unsigned char* done, int device, void* stream) {                 \
    return run_density<T>(ids, r, m, u, h, ndim, n0, n1, n2, k_cell, per0,  \
                          per1, per2, L0, L1, L2, norm, family, res, h_fac, \
                          h_converge, hmax, h_out, rho, q, hfac, done,      \
                          device, stream);                                  \
  }

#define SM2012_FORCES_ENTRY(NAME, T)                                        \
  int NAME(const int* ids, const T* r, const T* v, const T* pk, int ndim,   \
           int n0, int n1, int n2, int k_cell, int per0, int per1,          \
           int per2, double L0, double L1, double L2, double norm,          \
           int family, int res, double gamma, int avisc, double alpha_visc, \
           double beta_visc, T* a, T* dudt, T* divv, int device,            \
           void* stream) {                                                  \
    return run_forces<T>(ids, r, v, pk, ndim, n0, n1, n2, k_cell, per0,     \
                         per1, per2, L0, L1, L2, norm, family, res, gamma,  \
                         avisc, alpha_visc, beta_visc, a, dudt, divv,       \
                         device, stream);                                   \
  }

SM2012_DENSITY_ENTRY(sm2012_density_f32, float)
SM2012_DENSITY_ENTRY(sm2012_density_f64, double)
SM2012_FORCES_ENTRY(sm2012_forces_f32, float)
SM2012_FORCES_ENTRY(sm2012_forces_f64, double)

}  // extern "C"
