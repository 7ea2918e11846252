// Grid geometry shared by the grid kernels (K1-K3, K8-K12).
//
// Cells are stored dense as (n0, n1, n2, K) with dim 0 slowest, the
// layout of gandalf_tpu's Grid27Spec.  A grid of NDIM < 3 dims keeps
// n = 1 in its trailing dims, so its flat cell id is the JAX package's.
// Instead of copying ghost layers, a kernel asks for neighbour d
// (0..3^NDIM-1) of its cell: the index wraps along a periodic dim, and
// the neighbour's positions are shifted by -L or +L there; along an open
// dim an out-of-range neighbour is skipped.  A dim with fewer than 3
// cells visits the same cell under several images, exactly as the
// ghosted slices of the JAX package do.
//
// K2 and K3 also take the distributed plan's z-slab stencil: qz cells
// each side along dim 0 (neighbour_cell_q, 2 qz + 1 rows), and a shard's
// ghosted slab, whose dim 0 is open because its halo rows already hold
// the ring neighbours' cells shifted across a periodic seam.  A launch
// covers a run-time window of dim-0 rows (the shard's own), not a
// template branch.
#pragma once

#include <cuda_runtime.h>

struct Grid3 {
  int n[3];
  int periodic[3];
  double L[3];
  int K;
  // dim-0 stencil half-width, read by neighbour_cell_q only
  int qz = 1;
};

// 3^NDIM neighbour cells; the cell itself is the centre one
template <int NDIM>
struct Stencil {
  static constexpr int kSize = NDIM == 1 ? 3 : NDIM == 2 ? 9 : 27;
  static constexpr int kCentre = (kSize - 1) / 2;
};

__host__ __device__ __forceinline__ void cell_coords(const Grid3& g, int c,
                                                     int cc[3]) {
  cc[2] = c % g.n[2];
  cc[1] = (c / g.n[2]) % g.n[1];
  cc[0] = c / (g.n[1] * g.n[2]);
}

// neighbour d of cell cc: its flat id and the shift of its positions;
// false where an open dim runs out of range.  The offset of dim k is
// digit k of d in base 3 (dim 0 most significant), over the first NDIM
// dims, as gandalf_tpu/ops/sph_grid27.py:_shifts orders them.
template <typename T, int NDIM = 3>
__device__ __forceinline__ bool neighbour_cell(const Grid3& g,
                                               const int cc[3], int d,
                                               int* nc, T sh[3]) {
  int dd[3] = {0, 0, 0};
  if (NDIM == 3) {
    dd[0] = d / 9 - 1;
    dd[1] = (d / 3) % 3 - 1;
    dd[2] = d % 3 - 1;
  } else if (NDIM == 2) {
    dd[0] = d / 3 - 1;
    dd[1] = d % 3 - 1;
  } else {
    dd[0] = d - 1;
  }
  int x[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    x[k] = cc[k] + dd[k];
    sh[k] = T(0);
    if (k >= NDIM) continue;
    if (x[k] < 0) {
      if (!g.periodic[k]) return false;
      x[k] += g.n[k];
      sh[k] = T(-g.L[k]);
    } else if (x[k] >= g.n[k]) {
      if (!g.periodic[k]) return false;
      x[k] -= g.n[k];
      sh[k] = T(g.L[k]);
    }
  }
  *nc = (x[0] * g.n[1] + x[1]) * g.n[2] + x[2];
  return true;
}

// the cells of a dim-0 row in NDIM dims' stencil: 3^(NDIM-1)
template <int NDIM>
__host__ __device__ constexpr int stencil_inner() {
  return NDIM == 1 ? 1 : NDIM == 2 ? 3 : 9;
}

// (2 qz + 1) 3^(NDIM-1) neighbour cells of neighbour_cell_q; the cell
// itself is the centre one, (size - 1) / 2
template <int NDIM>
__device__ __forceinline__ int stencil_size(const Grid3& g) {
  return (2 * g.qz + 1) * stencil_inner<NDIM>();
}

// neighbour_cell over the z-slab stencil: digit 0 of d runs over the
// 2 qz + 1 offsets -qz..qz of dim 0, the others over -1..1 as in
// gandalf_tpu/ops/sph_grid27.py:_shifts(ndim, qz); with qz = 1 it is
// neighbour_cell.  A periodic dim wraps once (qz <= n[0] there).
template <typename T, int NDIM = 3>
__device__ __forceinline__ bool neighbour_cell_q(const Grid3& g,
                                                 const int cc[3], int d,
                                                 int* nc, T sh[3]) {
  constexpr int inner = stencil_inner<NDIM>();
  int dd[3] = {0, 0, 0};
  dd[0] = d / inner - g.qz;
  const int rest = d % inner;
  if (NDIM == 3) {
    dd[1] = rest / 3 - 1;
    dd[2] = rest % 3 - 1;
  } else if (NDIM == 2) {
    dd[1] = rest - 1;
  }
  int x[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    x[k] = cc[k] + dd[k];
    sh[k] = T(0);
    if (k >= NDIM) continue;
    if (x[k] < 0) {
      if (!g.periodic[k]) return false;
      x[k] += g.n[k];
      sh[k] = T(-g.L[k]);
    } else if (x[k] >= g.n[k]) {
      if (!g.periodic[k]) return false;
      x[k] -= g.n[k];
      sh[k] = T(g.L[k]);
    }
  }
  *nc = (x[0] * g.n[1] + x[1]) * g.n[2] + x[2];
  return true;
}

inline int slot_threads(int K) {
  const int t = ((K + 31) / 32) * 32;
  return t < 256 ? t : 256;
}

// K2 and K3 run one thread per slot.  In 3D with K >= 32 a block takes
// one cell and its threads loop over the slots (a warp reads the same
// neighbour at the same time); otherwise threads map over the flattened
// (cell, slot) index and a warp spans several cells.  Measured on the
// H100 (PERF.md §6): per cell is 17-25% faster on the 3D boxes (K =
// 65, 66, 276), flat 36-42% faster on the 2D KHI (K = 35, where a block
// per cell idles 29 of its 64 lanes).  `mapping` 0 chooses so, 1 takes
// the per-cell mapping, 2 the flat one (for timing the two).
constexpr int kFlatThreads = 128;

inline bool slot_mapping_flat(int mapping, int ndim, int K) {
  return mapping == 2 || (mapping == 0 && (ndim < 3 || K < 32));
}
