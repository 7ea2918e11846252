// K3 grid27_forces: grad-h SPH pair forces over the 3^NDIM-cell stencil,
// in 1, 2 or 3 dims.
//
// Replaces gandalf_tpu/ops/sph_grid27.py:forces_grid27 and _force_shifts
// (:528-734), which evaluate one (cells, K, 3^ndim K) pair block per slab
// of cells from ghost-layer copies, with pair distances and
// (v_j-v_i).(r_j-r_i) taken from a dot-product expansion that keeps the
// TPU's matrix unit busy.
//
// Bound on the card: pair arithmetic.  One pass is about 4.6e8 pair
// candidates at 262,144 particles in 3D, each loading 15 values of its
// neighbour (position, velocity, nine scalars) and, inside the support,
// costing two kernel derivatives, a square root and several divisions.
//
// Design: one thread per slot, mapped as in K2 (grid27.cuh), NDIM a
// template parameter.  A thread sums its particle's acceleration, du/dt
// and -sum m_j dvdr W'_i over the neighbour cells in registers.  Pair
// separations and dvdr are computed directly (no expansion, so no
// cancellation floor is needed, and none of the JAX package's 1D floor
// width): a pair counts when the neighbour slot is filled, is not the
// particle itself (same slot of the cell's own shift) and does not
// coincide with it (d^2 > 0).  The pair arithmetic (sph_pair.cuh, shared
// with K9): viscosity (mon97, or mm97 with per-particle alpha) acts on
// approaching pairs with the signal velocity; the Wadsley (2008) and
// Price (2008) conductivities are selected by integer arguments.  The
// epilogue (div_v normalisation, -P div_v term, MM97 dalpha/dt) stays
// elementwise torch.  No shared-memory staging yet: that is later work.
//
// The smoothing kernel (kernel_family.cuh) is a template parameter.  Any
// kernel but the direct M4 sums d^2 in the plain version's rounded steps
// (kExactD2), so its s, and a table index, are the plain version's.
//
// On a shard's ghosted slab (the distributed pass) the stencil is qz
// rows deep along dim 0 and the launch covers a run-time window of
// dim-0 rows, as in K2 (grid27.cuh); the halo rows, which hold the
// neighbours' density results, are neighbours only.
#include <cuda_runtime.h>

#include "grid27.cuh"
#include "sph_pair.cuh"

namespace {

using sph::kNScalars;

template <typename T, int NDIM, class KF>
__device__ __forceinline__ void forces_slot(
    const T* __restrict__ r, const T* __restrict__ v,
    const T* __restrict__ pk, const unsigned char* __restrict__ fill,
    const Grid3& g, int c, int i, const KF& kern,
    const sph::Dissipation& dis,
    T* __restrict__ a_out, T* __restrict__ dudt_out,
    T* __restrict__ divv_out) {
  const int K = g.K;
  const long long p = static_cast<long long>(c) * K + i;
  if (!fill[p]) {
#pragma unroll
    for (int k = 0; k < NDIM; ++k) a_out[NDIM * p + k] = T(0);
    dudt_out[p] = T(0);
    divv_out[p] = T(0);
    return;
  }
  int cc[3];
  cell_coords(g, c, cc);
  T xi[NDIM], vi[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    xi[k] = r[NDIM * p + k];
    vi[k] = v[NDIM * p + k];
  }
  const sph::Own<T> own(pk + kNScalars * p);
  T acc[NDIM + 2];
#pragma unroll
  for (int k = 0; k < NDIM + 2; ++k) acc[k] = T(0);
  const int n_sh = stencil_size<NDIM>(g);
  const int centre = (n_sh - 1) / 2;
  for (int d = 0; d < n_sh; ++d) {
    int nc;
    T sh[3];
    if (!neighbour_cell_q<T, NDIM>(g, cc, d, &nc, sh)) continue;
    const long long q0 = static_cast<long long>(nc) * K;
    for (int j = 0; j < K; ++j) {
      const long long q = q0 + j;
      if (!fill[q] || (d == centre && j == i)) continue;
      T dr[NDIM], dv[NDIM];
      T drsqd = T(0);
#pragma unroll
      for (int k = 0; k < NDIM; ++k) {
        dr[k] = (r[NDIM * q + k] + sh[k]) - xi[k];
        dv[k] = v[NDIM * q + k] - vi[k];
        if (KF::kExactD2)
          drsqd = kf::add(drsqd, kf::mul(dr[k], dr[k]));
        else
          drsqd += dr[k] * dr[k];
      }
      if (!(drsqd > T(0))) continue;
      sph::pair_add_n<T, NDIM>(own, pk + kNScalars * q, dr, dv, sqrt(drsqd),
                               kern, dis, acc);
    }
  }
#pragma unroll
  for (int k = 0; k < NDIM; ++k) a_out[NDIM * p + k] = acc[k];
  dudt_out[p] = acc[NDIM];
  divv_out[p] = acc[NDIM + 1];
}

template <typename T, int NDIM, bool kFlat, class KF>
__global__ void __launch_bounds__(256) grid27_forces_kernel(
    const T* __restrict__ r, const T* __restrict__ v,
    const T* __restrict__ pk, const unsigned char* __restrict__ fill,
    Grid3 g, int c0, int n_cells, KF kern, sph::Dissipation dis,
    T* __restrict__ a_out, T* __restrict__ dudt_out,
    T* __restrict__ divv_out) {
  // cells [c0, c0 + n_cells): the row window's
  if (kFlat) {
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
    if (t >= static_cast<long long>(n_cells) * g.K) return;
    forces_slot<T, NDIM>(r, v, pk, fill, g, c0 + static_cast<int>(t / g.K),
                         static_cast<int>(t % g.K), kern, dis, a_out,
                         dudt_out, divv_out);
    return;
  }
  for (int i = threadIdx.x; i < g.K; i += blockDim.x)
    forces_slot<T, NDIM>(r, v, pk, fill, g, c0 + blockIdx.x, i, kern, dis,
                         a_out, dudt_out, divv_out);
}

template <typename T, int NDIM, class KF>
void launch_forces(const T* r, const T* v, const T* pk,
                   const unsigned char* fill, const Grid3& g, int c0,
                   int n_cells, const KF& kern, const sph::Dissipation& dis,
                   T* a, T* dudt, T* div_v, bool flat, cudaStream_t stream) {
  if (flat) {
    const long long slots = static_cast<long long>(n_cells) * g.K;
    const int blocks =
        static_cast<int>((slots + kFlatThreads - 1) / kFlatThreads);
    grid27_forces_kernel<T, NDIM, true, KF><<<blocks, kFlatThreads, 0,
                                              stream>>>(
        r, v, pk, fill, g, c0, n_cells, kern, dis, a, dudt, div_v);
  } else {
    grid27_forces_kernel<T, NDIM, false, KF><<<n_cells, slot_threads(g.K),
                                               0, stream>>>(
        r, v, pk, fill, g, c0, n_cells, kern, dis, a, dudt, div_v);
  }
}

template <typename T>
int run_forces(const T* r, const T* v, const T* pk,
               const unsigned char* fill, int ndim, int n0, int n1, int n2,
               int k_cell, int per0, int per1, int per2, double L0,
               double L1, double L2, double norm, int family, int res,
               int avisc, int acond, double alpha_visc, double beta_visc,
               T* a, T* dudt, T* div_v, int qz, int row0, int nrows,
               int mapping, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ndim < 1 || ndim > 3 || qz < 1 || row0 < 0 || nrows < 0
      || row0 + nrows > n0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Grid3 g = {{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell, qz};
  const int c0 = row0 * n1 * n2;
  const int n_cells = nrows * n1 * n2;
  const sph::Dissipation dis{avisc, acond, alpha_visc, beta_visc};
  const bool flat = slot_mapping_flat(mapping, ndim, k_cell);
  if (n_cells > 0 && k_cell > 0) {
    const bool known = kf::with_kernel<T>(
        family, res, norm, ndim, [&](const auto& kern) {
          if (ndim == 1)
            launch_forces<T, 1>(r, v, pk, fill, g, c0, n_cells, kern,
                                dis, a,
                                dudt, div_v, flat, stream);
          else if (ndim == 2)
            launch_forces<T, 2>(r, v, pk, fill, g, c0, n_cells, kern,
                                dis, a,
                                dudt, div_v, flat, stream);
          else
            launch_forces<T, 3>(r, v, pk, fill, g, c0, n_cells, kern,
                                dis, a,
                                dudt, div_v, flat, stream);
        });
    if (!known) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define GRID27_FORCES_ENTRY(NAME, T)                                        \
  int NAME(const T* r, const T* v, const T* pk, const unsigned char* fill,  \
           int ndim, int n0, int n1, int n2, int k_cell, int per0,          \
           int per1, int per2, double L0, double L1, double L2,             \
           double norm, int family, int res, int avisc, int acond,          \
           double alpha_visc, double beta_visc, T* a, T* dudt, T* div_v,    \
           int qz, int row0, int nrows, int mapping, int device,            \
           void* stream) {                                                  \
    return run_forces<T>(r, v, pk, fill, ndim, n0, n1, n2, k_cell, per0,    \
                         per1, per2, L0, L1, L2, norm, family, res, avisc,  \
                         acond, alpha_visc, beta_visc, a, dudt, div_v, qz,  \
                         row0, nrows, mapping, device, stream);             \
  }

GRID27_FORCES_ENTRY(grid27_forces_f32, float)
GRID27_FORCES_ENTRY(grid27_forces_f64, double)

}  // extern "C"
