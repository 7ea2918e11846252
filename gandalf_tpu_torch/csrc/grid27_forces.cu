// K3 grid27_forces: grad-h SPH pair forces over the 27-cell stencil.
//
// Replaces gandalf_tpu/ops/sph_grid27.py:forces_grid27 and _force_shifts
// (:528-734), which evaluate one (cells, K, 27K) pair block per slab of
// cells from ghost-layer copies, with pair distances and (v_j-v_i).(r_j-r_i)
// taken from a dot-product expansion that keeps the TPU's matrix unit busy.
//
// Bound on the card: pair arithmetic.  One pass is about 4.6e8 pair
// candidates at 262,144 particles, each loading 15 values of its
// neighbour (position, velocity, nine scalars) and, inside the support,
// costing two kernel derivatives, a square root and several divisions.
//
// Design: one block per cell and one thread per slot, as in K2.  A thread
// sums its particle's acceleration, du/dt and -sum m_j dvdr W'_i over the
// 27 neighbour cells in registers.  Pair separations and dvdr are computed
// directly (no expansion, so no cancellation floor is needed): a pair
// counts when the neighbour slot is filled, is not the particle itself
// (same slot of the cell's own shift, d = 13) and does not coincide with
// it (d^2 > 0).  The pair arithmetic (sph_pair.cuh, shared with K9):
// viscosity (mon97, or mm97 with per-particle alpha) acts on approaching
// pairs with the signal velocity; the Wadsley (2008) and Price (2008)
// conductivities are selected by integer arguments.  The epilogue (div_v normalisation, -P div_v term, MM97 dalpha/dt) stays
// elementwise torch.  No shared-memory staging yet: that is later work.
#include <cuda_runtime.h>

#include "grid27.cuh"
#include "sph_pair.cuh"

namespace {

using sph::kNScalars;

template <typename T>
__global__ void __launch_bounds__(256) grid27_forces_kernel(
    const T* __restrict__ r, const T* __restrict__ v,
    const T* __restrict__ pk, const unsigned char* __restrict__ fill,
    Grid3 g, T norm, sph::Dissipation dis, T* __restrict__ a_out,
    T* __restrict__ dudt_out, T* __restrict__ divv_out) {
  const int c = blockIdx.x;
  const int K = g.K;
  int cc[3];
  cell_coords(g, c, cc);
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const long long p = static_cast<long long>(c) * K + i;
    if (!fill[p]) {
      a_out[3 * p] = a_out[3 * p + 1] = a_out[3 * p + 2] = T(0);
      dudt_out[p] = T(0);
      divv_out[p] = T(0);
      continue;
    }
    const T xi = r[3 * p], yi = r[3 * p + 1], zi = r[3 * p + 2];
    const T vxi = v[3 * p], vyi = v[3 * p + 1], vzi = v[3 * p + 2];
    const sph::Own<T> own(pk + kNScalars * p);
    T acc[5] = {T(0), T(0), T(0), T(0), T(0)};
    for (int d = 0; d < 27; ++d) {
      int nc;
      T sh[3];
      if (!neighbour_cell<T>(g, cc, d, &nc, sh)) continue;
      const long long q0 = static_cast<long long>(nc) * K;
      for (int j = 0; j < K; ++j) {
        const long long q = q0 + j;
        if (!fill[q] || (d == 13 && j == i)) continue;
        const T dx = (r[3 * q] + sh[0]) - xi;
        const T dy = (r[3 * q + 1] + sh[1]) - yi;
        const T dz = (r[3 * q + 2] + sh[2]) - zi;
        const T drsqd = dx * dx + dy * dy + dz * dz;
        if (!(drsqd > T(0))) continue;
        sph::pair_add<T>(own, pk + kNScalars * q, dx, dy, dz,
                         v[3 * q] - vxi, v[3 * q + 1] - vyi,
                         v[3 * q + 2] - vzi, sqrt(drsqd), norm, dis, acc);
      }
    }
    a_out[3 * p] = acc[0];
    a_out[3 * p + 1] = acc[1];
    a_out[3 * p + 2] = acc[2];
    dudt_out[p] = acc[3];
    divv_out[p] = acc[4];
  }
}

template <typename T>
int run_forces(const T* r, const T* v, const T* pk,
               const unsigned char* fill, int n0, int n1, int n2,
               int k_cell, int per0, int per1, int per2, double L0,
               double L1, double L2, double norm, int avisc, int acond,
               double alpha_visc, double beta_visc, T* a, T* dudt, T* div_v,
               int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Grid3 g = {{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell};
  const int n_cells = n0 * n1 * n2;
  if (n_cells > 0 && k_cell > 0)
    grid27_forces_kernel<T><<<n_cells, slot_threads(k_cell), 0, stream>>>(
        r, v, pk, fill, g, T(norm),
        sph::Dissipation{avisc, acond, alpha_visc, beta_visc}, a, dudt,
        div_v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define GRID27_FORCES_ENTRY(NAME, T)                                        \
  int NAME(const T* r, const T* v, const T* pk, const unsigned char* fill,  \
           int n0, int n1, int n2, int k_cell, int per0, int per1,          \
           int per2, double L0, double L1, double L2, double norm,          \
           int avisc, int acond, double alpha_visc, double beta_visc,       \
           T* a, T* dudt, T* div_v, int device, void* stream) {             \
    return run_forces<T>(r, v, pk, fill, n0, n1, n2, k_cell, per0, per1,    \
                         per2, L0, L1, L2, norm, avisc, acond, alpha_visc,  \
                         beta_visc, a, dudt, div_v, device, stream);        \
  }

GRID27_FORCES_ENTRY(grid27_forces_f32, float)
GRID27_FORCES_ENTRY(grid27_forces_f64, double)

}  // extern "C"
