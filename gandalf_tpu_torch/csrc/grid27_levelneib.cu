// K22 levelneib: each alive particle's largest neighbour timestep level
// within kernrange * max(h_i, h_j), the Saitoh-Makino input of a dense
// block tick (with sinks or dust, and of block MFV), in 1, 2 or 3 dims.
//
// Replaces gandalf_tpu/sim/simulation.py:_levelneib_pass (:1682-1702)
// and gandalf_tpu/sim/mfv_sim.py:_levelneib_pass (:345-363), the same
// pass, over gandalf_tpu/ops/active_grid.py:gather_active_candidates
// (:59),
// which gathers an (N, 27K) candidate block of every particle from
// ghost-layer copies of the grid (dead particles binned out) and takes
// the masked maximum of the candidates' levels.  Unlike K9's two-sided
// scatter-max, the pass overwrites levelneib: each particle takes the
// maximum over its own candidates only, itself included.
//
// Bound on the card: the dependent loads of each candidate (slot ->
// particle -> position, h and level), about 1.4e8 candidates at 262,144
// particles with K = 20; there is no arithmetic to speak of.
//
// Design: one thread per slot of K1's slot map (particle id per slot, -1
// empty; the dead are binned out), flat over (cell, slot), sweeping the
// 3^NDIM neighbour cells as K8 and K9 do (NDIM a template parameter); the maximum stays in a register and
// each output is written once, so no atomics.  d^2 is summed with
// round-to-nearest steps in the plain version's order and the radius
// squared as there, so both take the same "within" decisions.  Outputs
// are in particle order; a particle without a slot is left as the
// wrapper set it (0).
#include <cuda_runtime.h>

#include "grid27.cuh"
#include "tree.cuh"

namespace {

using tree::add_rn;
using tree::mul_rn;

constexpr int kThreads = 128;

template <typename T, int NDIM>
__global__ void __launch_bounds__(kThreads) levelneib_kernel(
    const int* __restrict__ ids, const T* __restrict__ r,
    const T* __restrict__ h, const int* __restrict__ level, Grid3 g,
    int n_cells, T kernrange, int* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const int K = g.K;
  if (t >= static_cast<long long>(n_cells) * K) return;
  const int p = ids[t];
  if (p < 0) return;
  int cc[3];
  cell_coords(g, static_cast<int>(t / K), cc);
  T xi[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) xi[k] = r[NDIM * static_cast<long long>(p)
                                         + k];
  const T h_i = h[p];
  int lvl = 0;
  for (int d = 0; d < Stencil<NDIM>::kSize; ++d) {
    int nc;
    T sh[3];
    if (!neighbour_cell<T, NDIM>(g, cc, d, &nc, sh)) continue;
    const int* slots = ids + static_cast<long long>(nc) * K;
    for (int j = 0; j < K; ++j) {
      const int q = slots[j];
      if (q < 0) continue;
      T d2 = T(0);
#pragma unroll
      for (int k = 0; k < NDIM; ++k) {
        const T dk = (r[NDIM * static_cast<long long>(q) + k] + sh[k])
                     - xi[k];
        d2 = k == 0 ? mul_rn(dk, dk) : add_rn(d2, mul_rn(dk, dk));
      }
      const T rad = mul_rn(kernrange, max(h_i, h[q]));
      if (d2 <= mul_rn(rad, rad)) {
        const int lq = level[q];
        lvl = lq > lvl ? lq : lvl;
      }
    }
  }
  out[p] = lvl;
}

template <typename T, int NDIM>
void launch(const int* ids, const T* r, const T* h, const int* level,
            const Grid3& g, int n_cells, T kernrange, int* out,
            cudaStream_t stream) {
  const long long slots = static_cast<long long>(n_cells) * g.K;
  levelneib_kernel<T, NDIM>
      <<<static_cast<int>((slots + kThreads - 1) / kThreads), kThreads, 0,
         stream>>>(ids, r, h, level, g, n_cells, kernrange, out);
}

template <typename T>
int run_levelneib(const int* ids, const T* r, const T* h, const int* level,
                  int* out, int ndim, int n0, int n1, int n2, int k_cell,
                  int per0, int per1, int per2, double L0, double L1,
                  double L2, double kernrange, int device,
                  void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ndim < 1 || ndim > 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Grid3 g = {{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell};
  const int n_cells = n0 * n1 * n2;
  if (static_cast<long long>(n_cells) * k_cell > 0) {
    if (ndim == 3)
      launch<T, 3>(ids, r, h, level, g, n_cells, T(kernrange), out, stream);
    else if (ndim == 2)
      launch<T, 2>(ids, r, h, level, g, n_cells, T(kernrange), out, stream);
    else
      launch<T, 1>(ids, r, h, level, g, n_cells, T(kernrange), out, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define LEVELNEIB_ENTRY(NAME, T)                                            \
  int NAME(const int* ids, const T* r, const T* h, const int* level,        \
           int* out, int ndim, int n0, int n1, int n2, int k_cell,          \
           int per0, int per1, int per2, double L0, double L1, double L2,   \
           double kernrange, int device, void* stream) {                    \
    return run_levelneib<T>(ids, r, h, level, out, ndim, n0, n1, n2,        \
                            k_cell, per0, per1, per2, L0, L1, L2,           \
                            kernrange, device, stream);                     \
  }

LEVELNEIB_ENTRY(levelneib_f32, float)
LEVELNEIB_ENTRY(levelneib_f64, double)

}  // extern "C"
