// K9 active_forces: the SPH pair forces of a listed subset of particles
// (the active particles of a block-timestep tick) over the 27-cell
// stencil, and the Saitoh-Makino neighbour-level scatter in both
// directions.
//
// Replaces gandalf_tpu/ops/active_grid.py:active_hydro_pass (:140-192),
// which evaluates ops/forces.py:compute_hydro_forces (:91-169) on an
// (n_cap, 27K) candidate block gathered from ghost-layer copies and
// scatters levelneib with two scatter-max passes (:142-154).
//
// Bound on the card: pair arithmetic and the dependent loads of each
// candidate (slot -> particle -> position, then its nine scalars inside
// the support), for the listed particles only.
//
// Design: one thread per listed particle, 128 to a block, sweeping the
// 27 neighbour cells of K1's dense slot map (particle id per slot, -1
// empty) as K8 does.  A candidate within kernrange * max(h_i, h_j) of
// the particle (the particle itself included) raises the particle's
// neighbour level to the candidate's level and the candidate's to the
// particle's, the latter with atomicMax on int32; the particle's own
// maximum goes in with one atomicMax at the end, since other threads
// may raise it too.  max is order-free, so the result is deterministic.
// d^2 is summed with round-to-nearest steps in the plain version's order,
// so both take the same "within" decisions.  With hydro forces on, a
// candidate that does not coincide with the particle (d^2 > 0) adds its
// pair terms (sph_pair.cuh, shared with K3), and the epilogue normalises
// div_v and adds -P div_v / (rho Omega) to du/dt, as compute_hydro_forces
// does.  Outputs are per listed row; levelneib is updated in place in a
// copy the wrapper makes.  The smoothing kernel (kernel_family.cuh) is
// a template parameter.
#include <cuda_runtime.h>

#include <type_traits>

#include "grid27.cuh"
#include "sph_pair.cuh"
#include "tree.cuh"

namespace {

using sph::kNScalars;
using tree::add_rn;
using tree::mul_rn;

constexpr int kThreads = 128;

template <typename T, class KF>
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
  const T xi = r[3 * i], yi = r[3 * i + 1], zi = r[3 * i + 2];
  const T vxi = v[3 * i], vyi = v[3 * i + 1], vzi = v[3 * i + 2];
  const T* si = pk + kNScalars * static_cast<long long>(i);
  const T h_i = si[sph::kH];
  const sph::Own<T> own(si);
  const int lvl_i = level[i];
  int lvl_nb = 0;
  T acc[5] = {T(0), T(0), T(0), T(0), T(0)};
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
      const T d2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)),
                          mul_rn(dz, dz));
      const T* sj = pk + kNScalars * static_cast<long long>(q);
      const T rad = kernrange * max(h_i, sj[sph::kH]);
      if (d2 <= rad * rad) {
        const int lq = level[q];
        lvl_nb = lq > lvl_nb ? lq : lvl_nb;
        atomicMax(levelneib + q, lvl_i);
      }
      if (!hydro || !(d2 > T(0))) continue;
      sph::pair_add<T>(own, sj, dx, dy, dz, v[3 * q] - vxi,
                       v[3 * q + 1] - vyi, v[3 * q + 2] - vzi, sqrt(d2),
                       kern, dis, acc);
    }
  }
  atomicMax(levelneib + i, lvl_nb);
  T div_v = T(0), dudt = T(0);
  if (hydro) {
    // the epilogue of compute_hydro_forces, with its unclamped 1/rho
    const T invrho = T(1) / si[sph::kRho];
    div_v = acc[4] * invrho;
    dudt = acc[3] - si[sph::kPress] * div_v * invrho * si[sph::kInvom];
  }
  a_out[3 * k] = hydro ? acc[0] : T(0);
  a_out[3 * k + 1] = hydro ? acc[1] : T(0);
  a_out[3 * k + 2] = hydro ? acc[2] : T(0);
  dudt_out[k] = dudt;
  divv_out[k] = div_v;
}

template <typename T>
int run_active_forces(const int* idx, int n, const int* cell_of,
                      const int* ids_d, const T* r, const T* v, const T* pk,
                      const int* level, int n0, int n1, int n2, int k_cell,
                      int per0, int per1, int per2, double L0, double L1,
                      double L2, double norm, int family, int res,
                      double kernrange, int hydro,
                      int avisc, int acond, double alpha_visc,
                      double beta_visc, T* a, T* dudt, T* div_v,
                      int* levelneib, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Grid3 g = {{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell};
  if (n > 0) {
    const bool known = kf::with_kernel<T>(
        family, res, norm, 3, [&](const auto& kern) {
          using KF = std::decay_t<decltype(kern)>;
          active_forces_kernel<T, KF><<<(n + kThreads - 1) / kThreads,
                                        kThreads, 0, stream>>>(
              idx, n, cell_of, ids_d, r, v, pk, level, g, kern,
              T(kernrange), hydro,
              sph::Dissipation{avisc, acond, alpha_visc, beta_visc}, a, dudt,
              div_v, levelneib);
        });
    if (!known) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define ACTIVE_FORCES_ENTRY(NAME, T)                                        \
  int NAME(const int* idx, int n, const int* cell_of, const int* ids_d,     \
           const T* r, const T* v, const T* pk, const int* level, int n0,   \
           int n1, int n2, int k_cell, int per0, int per1, int per2,        \
           double L0, double L1, double L2, double norm, int family,        \
           int res, double kernrange, int hydro, int avisc, int acond,      \
           double alpha_visc, double beta_visc, T* a, T* dudt, T* div_v,    \
           int* levelneib, int device, void* stream) {                      \
    return run_active_forces<T>(idx, n, cell_of, ids_d, r, v, pk, level,    \
                                n0, n1, n2, k_cell, per0, per1, per2, L0,   \
                                L1, L2, norm, family, res, kernrange,       \
                                hydro, avisc, acond, alpha_visc, beta_visc, \
                                a, dudt, div_v, levelneib, device, stream); \
  }

ACTIVE_FORCES_ENTRY(active_forces_f32, float)
ACTIVE_FORCES_ENTRY(active_forces_f64, double)

}  // extern "C"
