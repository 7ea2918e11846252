// K9 active_forces: the SPH pair forces of a listed subset of particles
// (the active particles of a block-timestep tick) over the 3^NDIM-cell
// stencil, in 1, 2 or 3 dims, and the Saitoh-Makino neighbour-level
// scatter in both directions.
//
// Replaces gandalf_tpu/ops/active_grid.py:active_hydro_pass (:140-192),
// which evaluates ops/forces.py:compute_hydro_forces (:91-169) on an
// (n_cap, 3^nd K) candidate block gathered from ghost-layer copies and
// scatters levelneib with two scatter-max passes (:142-154), at any nd.
//
// Bound on the card: pair arithmetic and the dependent loads of each
// candidate (slot -> particle -> position, then its nine scalars inside
// the support), for the listed particles only.
//
// Design: one thread per listed particle, 128 to a block, NDIM a
// template parameter, sweeping the 3^NDIM neighbour cells of K1's dense
// slot map (particle id per slot, -1 empty) as K8 does.  A candidate
// within kernrange * max(h_i, h_j) of the particle (the particle itself
// included) raises the particle's neighbour level to the candidate's
// level and the candidate's to the particle's, the latter with atomicMax
// on int32; the particle's own maximum goes in with one atomicMax at the
// end, since other threads may raise it too.  max is order-free, so the
// result is deterministic.  d^2 sums the NDIM terms with round-to-nearest
// steps in the plain version's order, so both take the same "within"
// decisions.  With hydro forces on, a candidate that does not coincide
// with the particle (d^2 > 0) adds its pair terms (sph_pair.cuh's
// pair_add_n, K3's pair function), and the epilogue normalises div_v and
// adds -P div_v / (rho Omega) to du/dt, as compute_hydro_forces does.
// Outputs are per listed row, a (n, NDIM); levelneib is updated in place
// in a copy the wrapper makes.  The smoothing kernel (kernel_family.cuh)
// is a template parameter.
#include <cuda_runtime.h>

#include "grid27.cuh"
#include "sph_pair.cuh"
#include "tree.cuh"

namespace {

using sph::kNScalars;
using tree::add_rn;
using tree::mul_rn;

constexpr int kThreads = 128;

template <typename T, int NDIM, class KF>
__global__ void __launch_bounds__(kThreads) active_forces_kernel(
    const int* __restrict__ idx, int n, const int* __restrict__ cell_of,
    const int* __restrict__ ids_d, const T* __restrict__ r,
    const T* __restrict__ v, const T* __restrict__ pk,
    const int* __restrict__ level, Grid3 g, KF kern, T kernrange,
    int hydro, sph::Dissipation dis, T* __restrict__ a_out,
    T* __restrict__ dudt_out, T* __restrict__ divv_out,
    int* __restrict__ levelneib) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int i = idx[k];
  const int K = g.K;
  int cc[3];
  cell_coords(g, cell_of[i], cc);
  T xi[NDIM], vi[NDIM];
#pragma unroll
  for (int e = 0; e < NDIM; ++e) {
    xi[e] = r[NDIM * static_cast<long long>(i) + e];
    vi[e] = v[NDIM * static_cast<long long>(i) + e];
  }
  const T* si = pk + kNScalars * static_cast<long long>(i);
  const T h_i = si[sph::kH];
  const sph::Own<T> own(si);
  const int lvl_i = level[i];
  int lvl_nb = 0;
  // the acceleration, then du/dt and the unnormalised div v
  T acc[NDIM + 2];
#pragma unroll
  for (int e = 0; e < NDIM + 2; ++e) acc[e] = T(0);
  for (int d = 0; d < Stencil<NDIM>::kSize; ++d) {
    int nc;
    T sh[3];
    if (!neighbour_cell<T, NDIM>(g, cc, d, &nc, sh)) continue;
    const int* slots = ids_d + static_cast<long long>(nc) * K;
    for (int j = 0; j < K; ++j) {
      const int q = slots[j];
      if (q < 0) continue;
      T dr[NDIM];
      T d2 = T(0);
#pragma unroll
      for (int e = 0; e < NDIM; ++e) {
        dr[e] = (r[NDIM * static_cast<long long>(q) + e] + sh[e]) - xi[e];
        d2 = e == 0 ? mul_rn(dr[e], dr[e])
                    : add_rn(d2, mul_rn(dr[e], dr[e]));
      }
      const T* sj = pk + kNScalars * static_cast<long long>(q);
      const T rad = kernrange * max(h_i, sj[sph::kH]);
      if (d2 <= rad * rad) {
        const int lq = level[q];
        lvl_nb = lq > lvl_nb ? lq : lvl_nb;
        atomicMax(levelneib + q, lvl_i);
      }
      if (!hydro || !(d2 > T(0))) continue;
      T dv[NDIM];
#pragma unroll
      for (int e = 0; e < NDIM; ++e)
        dv[e] = v[NDIM * static_cast<long long>(q) + e] - vi[e];
      sph::pair_add_n<T, NDIM>(own, sj, dr, dv, sqrt(d2), kern, dis, acc);
    }
  }
  atomicMax(levelneib + i, lvl_nb);
  T div_v = T(0), dudt = T(0);
  if (hydro) {
    // the epilogue of compute_hydro_forces, with its unclamped 1/rho
    const T invrho = T(1) / si[sph::kRho];
    div_v = acc[NDIM + 1] * invrho;
    dudt = acc[NDIM] - si[sph::kPress] * div_v * invrho * si[sph::kInvom];
  }
#pragma unroll
  for (int e = 0; e < NDIM; ++e)
    a_out[NDIM * static_cast<long long>(k) + e] = hydro ? acc[e] : T(0);
  dudt_out[k] = dudt;
  divv_out[k] = div_v;
}

template <typename T, int NDIM, class KF>
void launch(const int* idx, int n, const int* cell_of, const int* ids_d,
            const T* r, const T* v, const T* pk, const int* level,
            const Grid3& g, const KF& kern, T kernrange, int hydro,
            const sph::Dissipation& dis, T* a, T* dudt, T* div_v,
            int* levelneib, cudaStream_t stream) {
  active_forces_kernel<T, NDIM, KF>
      <<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          idx, n, cell_of, ids_d, r, v, pk, level, g, kern, kernrange, hydro,
          dis, a, dudt, div_v, levelneib);
}

template <typename T>
int run_active_forces(const int* idx, int n, const int* cell_of,
                      const int* ids_d, const T* r, const T* v, const T* pk,
                      const int* level, int ndim, int n0, int n1, int n2,
                      int k_cell, int per0, int per1, int per2, double L0,
                      double L1, double L2, double norm, int family, int res,
                      double kernrange, int hydro, int avisc, int acond,
                      double alpha_visc, double beta_visc, T* a, T* dudt,
                      T* div_v, int* levelneib, int device,
                      void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ndim < 1 || ndim > 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Grid3 g = {{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell};
  if (n > 0) {
    const sph::Dissipation dis{avisc, acond, alpha_visc, beta_visc};
    const bool known = kf::with_kernel<T>(
        family, res, norm, ndim, [&](const auto& kern) {
          if (ndim == 1)
            launch<T, 1>(idx, n, cell_of, ids_d, r, v, pk, level, g, kern,
                         T(kernrange), hydro, dis, a, dudt, div_v, levelneib,
                         stream);
          else if (ndim == 2)
            launch<T, 2>(idx, n, cell_of, ids_d, r, v, pk, level, g, kern,
                         T(kernrange), hydro, dis, a, dudt, div_v, levelneib,
                         stream);
          else
            launch<T, 3>(idx, n, cell_of, ids_d, r, v, pk, level, g, kern,
                         T(kernrange), hydro, dis, a, dudt, div_v, levelneib,
                         stream);
        });
    if (!known) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define ACTIVE_FORCES_ENTRY(NAME, T)                                        \
  int NAME(const int* idx, int n, const int* cell_of, const int* ids_d,     \
           const T* r, const T* v, const T* pk, const int* level, int ndim, \
           int n0, int n1, int n2, int k_cell, int per0, int per1,          \
           int per2, double L0, double L1, double L2, double norm,          \
           int family, int res, double kernrange, int hydro, int avisc,     \
           int acond, double alpha_visc, double beta_visc, T* a, T* dudt,   \
           T* div_v, int* levelneib, int device, void* stream) {            \
    return run_active_forces<T>(idx, n, cell_of, ids_d, r, v, pk, level,    \
                                ndim, n0, n1, n2, k_cell, per0, per1, per2, \
                                L0, L1, L2, norm, family, res, kernrange,   \
                                hydro, avisc, acond, alpha_visc, beta_visc, \
                                a, dudt, div_v, levelneib, device, stream); \
  }

ACTIVE_FORCES_ENTRY(active_forces_f32, float)
ACTIVE_FORCES_ENTRY(active_forces_f64, double)

}  // extern "C"
