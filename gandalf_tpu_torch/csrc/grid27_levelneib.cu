// K22 levelneib: each alive particle's largest neighbour timestep level
// within kernrange * max(h_i, h_j), the Saitoh-Makino input of a block
// tick with sinks.
//
// Replaces gandalf_tpu/sim/simulation.py:_levelneib_pass (:1682-1702)
// over gandalf_tpu/ops/active_grid.py:gather_active_candidates (:59),
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
// empty; the dead are binned out), flat over (cell, slot), sweeping the 27
// neighbour cells as K8 and K9 do; the maximum stays in a register and
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

template <typename T>
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
  const T xi = r[3LL * p], yi = r[3LL * p + 1], zi = r[3LL * p + 2];
  const T h_i = h[p];
  int lvl = 0;
  for (int d = 0; d < 27; ++d) {
    int nc;
    T sh[3];
    if (!neighbour_cell<T>(g, cc, d, &nc, sh)) continue;
    const int* slots = ids + static_cast<long long>(nc) * K;
    for (int j = 0; j < K; ++j) {
      const int q = slots[j];
      if (q < 0) continue;
      const T dx = (r[3LL * q] + sh[0]) - xi;
      const T dy = (r[3LL * q + 1] + sh[1]) - yi;
      const T dz = (r[3LL * q + 2] + sh[2]) - zi;
      const T d2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)),
                          mul_rn(dz, dz));
      const T rad = mul_rn(kernrange, max(h_i, h[q]));
      if (d2 <= mul_rn(rad, rad)) {
        const int lq = level[q];
        lvl = lq > lvl ? lq : lvl;
      }
    }
  }
  out[p] = lvl;
}

template <typename T>
int run_levelneib(const int* ids, const T* r, const T* h, const int* level,
                  int* out, int n0, int n1, int n2, int k_cell, int per0,
                  int per1, int per2, double L0, double L1, double L2,
                  double kernrange, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Grid3 g = {{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell};
  const int n_cells = n0 * n1 * n2;
  const long long slots = static_cast<long long>(n_cells) * k_cell;
  if (slots > 0)
    levelneib_kernel<T><<<static_cast<int>((slots + kThreads - 1)
                                           / kThreads),
                          kThreads, 0, stream>>>(ids, r, h, level, g,
                                                 n_cells, T(kernrange), out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define LEVELNEIB_ENTRY(NAME, T)                                            \
  int NAME(const int* ids, const T* r, const T* h, const int* level,        \
           int* out, int n0, int n1, int n2, int k_cell, int per0,          \
           int per1, int per2, double L0, double L1, double L2,             \
           double kernrange, int device, void* stream) {                    \
    return run_levelneib<T>(ids, r, h, level, out, n0, n1, n2, k_cell,      \
                            per0, per1, per2, L0, L1, L2, kernrange,        \
                            device, stream);                                \
  }

LEVELNEIB_ENTRY(levelneib_f32, float)
LEVELNEIB_ENTRY(levelneib_f64, double)

}  // extern "C"
