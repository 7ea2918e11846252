// Grid geometry shared by the density (K2) and force (K3) kernels.
//
// Cells are stored dense as (n0, n1, n2, K) with dim 0 slowest, the
// layout of gandalf_tpu's Grid27Spec.  Instead of copying ghost layers,
// a kernel asks for neighbour d (0..26) of its cell: the index wraps
// along a periodic dim, and the neighbour's positions are shifted by -L
// or +L there; along an open dim an out-of-range neighbour is skipped.
// A dim with fewer than 3 cells visits the same cell under several
// images, exactly as the ghosted slices of the JAX package do.
#pragma once

#include <cuda_runtime.h>

struct Grid3 {
  int n[3];
  int periodic[3];
  double L[3];
  int K;
};

// d = 13 is the cell itself
__host__ __device__ __forceinline__ void cell_coords(const Grid3& g, int c,
                                                     int cc[3]) {
  cc[2] = c % g.n[2];
  cc[1] = (c / g.n[2]) % g.n[1];
  cc[0] = c / (g.n[1] * g.n[2]);
}

template <typename T>
__device__ __forceinline__ bool neighbour_cell(const Grid3& g,
                                               const int cc[3], int d,
                                               int* nc, T sh[3]) {
  const int dd[3] = {d / 9 - 1, (d / 3) % 3 - 1, d % 3 - 1};
  int x[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    x[k] = cc[k] + dd[k];
    sh[k] = T(0);
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
