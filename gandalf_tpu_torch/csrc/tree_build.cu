// K5 tree_build: mass, centre of mass, bounding box and quadrupole of
// every tree cell, leaves to root, in 1-3 dims (NDIM a template
// parameter; one entry per NDIM and type).
//
// Replaces gandalf_tpu/ops/tree.py:build_tree (:153-228), which reduces
// reshaped (leaves, L) arrays and merges child pairs level by level.
//
// Bound on the card: launches and latency.  The work is O(N) (about 60
// flops per particle at the leaves, a few hundred per cell above), but
// the tree has depth + 1 levels that depend on each other, and the upper
// levels hold few cells: at 262,144 particles 13 launches of at most
// 4,096 threads after the leaf pass.
//
// The quadrupole is the JAX package's 3 sum m dr dr^T - tr I_NDIM
// (:185-188): traceless in 3D only; below 3D it is the planar block of
// that formula, copied as it is.
//
// Design: one warp per leaf, lane = slot, reduces with butterfly
// shuffles (a fixed order, so the result is deterministic).  Dead slots
// are masked out before the outer product; an empty leaf gets m = 0 and
// COM and box at the far sentinel; the COM is divided only where m > 0,
// then held inside the cell's box (fault F30: the JAX package's does not
// clamp, and one live particle's COM can round an ulp off its zero-width
// box, which the walk then takes as a far cell).
// Then one launch per level, one thread per cell: the two children
// merge, only occupied children (m > 0) enter the box (their lo and hi
// are kept exactly in a scratch table beside the cell table), an empty
// parent gets the sentinel, and an empty child's displacement is masked
// before the parallel-axis term.  Each level is written as rows of the
// level-concatenated cell table.  Simple and launch-bound; a single
// persistent kernel over all levels is later work.
#include <cuda_runtime.h>

#include "tree.cuh"

namespace {

using namespace tree;

template <typename T, int NDIM>
__device__ __forceinline__ void write_cell(T* row, T m, const T com[NDIM],
                                           const T lo[NDIM],
                                           const T hi[NDIM],
                                           const T q[Layout<NDIM>::kNQ]) {
  using Lay = Layout<NDIM>;
  row[Lay::kCM] = m;
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    row[Lay::kCCom + k] = com[k];
    row[Lay::kCHalf + k] = T(0.5) * (hi[k] - lo[k]);
    row[Lay::kCCen + k] = T(0.5) * (lo[k] + hi[k]);
  }
#pragma unroll
  for (int k = 0; k < Lay::kNQ; ++k) row[Lay::kCQ + k] = q[k];
}

// lo and hi of each cell, kept exact beside the table (which holds the
// centre and half-width) for the merge of the next level up
template <typename T, int NDIM>
__device__ __forceinline__ void write_box(T* box, const T lo[NDIM],
                                          const T hi[NDIM]) {
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    box[k] = lo[k];
    box[NDIM + k] = hi[k];
  }
}

// 3 q - tr I over the upper triangle q (the sums of m d_i d_j)
template <typename T, int NDIM>
__device__ __forceinline__ void make_quad(T q[Layout<NDIM>::kNQ]) {
  T tr = q[tri<NDIM>(0, 0)];
#pragma unroll
  for (int k = 1; k < NDIM; ++k) tr += q[tri<NDIM>(k, k)];
#pragma unroll
  for (int k = 0; k < Layout<NDIM>::kNQ; ++k) q[k] = T(3) * q[k];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) q[tri<NDIM>(k, k)] -= tr;
}

template <typename T, int NDIM>
__global__ void tree_leaf_kernel(const T* __restrict__ ptab,
                                 const unsigned char* __restrict__ alive,
                                 int n_leaves, int quadrupole,
                                 T* __restrict__ leaf_rows,
                                 T* __restrict__ leaf_box) {
  using Lay = Layout<NDIM>;
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) / kLeaf;
  const int lane = threadIdx.x % kLeaf;
  if (g >= n_leaves) return;
  const long long slot = static_cast<long long>(g) * kLeaf + lane;
  const bool live = alive[slot] != 0;
  const T* p = ptab + Lay::kPCols * slot;
  T x[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) x[k] = p[Lay::kPX + k];
  const T m = live ? p[Lay::kPM] : T(0);
  const T m_tot = warp_sum(m);
  T com[NDIM], lo[NDIM], hi[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    const T s = warp_sum(m * x[k]);
    com[k] = m_tot > T(0) ? s / max(m_tot, T(1e-30)) : T(kFar);
    lo[k] = warp_min(live ? x[k] : T(kBig));
    hi[k] = warp_max(live ? x[k] : T(-kBig));
    if (!(m_tot > T(0))) lo[k] = hi[k] = T(kFar);
    // the COM held inside the box (fault F30): one live particle's
    // sum(m x) / m can round an ulp off x, outside its zero-width box
    com[k] = min(max(com[k], lo[k]), hi[k]);
  }
  T q[Lay::kNQ];
#pragma unroll
  for (int k = 0; k < Lay::kNQ; ++k) q[k] = T(0);
  if (quadrupole) {
    T d[NDIM];
#pragma unroll
    for (int k = 0; k < NDIM; ++k) d[k] = live ? x[k] - com[k] : T(0);
#pragma unroll
    for (int i = 0; i < NDIM; ++i) {
#pragma unroll
      for (int j = i; j < NDIM; ++j)
        q[tri<NDIM>(i, j)] = warp_sum(m * d[i] * d[j]);
    }
    make_quad<T, NDIM>(q);
  }
  if (lane == 0) {
    write_cell<T, NDIM>(leaf_rows + Lay::kCCols * static_cast<long long>(g),
                        m_tot, com, lo, hi, q);
    write_box<T, NDIM>(leaf_box + 2LL * NDIM * g, lo, hi);
  }
}

template <typename T, int NDIM>
__global__ void tree_merge_kernel(T* __restrict__ ctab, T* __restrict__ box,
                                  int level, int quadrupole) {
  using Lay = Layout<NDIM>;
  constexpr int kBox = 2 * NDIM;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= (1 << level)) return;
  const long long first_kid = (2LL << level) - 1 + 2LL * c;
  const T* kid = ctab + Lay::kCCols * first_kid;
  const T* kids[2] = {kid, kid + Lay::kCCols};
  const T* kid_box[2] = {box + kBox * first_kid, box + kBox * first_kid + kBox};
  const T m0 = kids[0][Lay::kCM], m1 = kids[1][Lay::kCM];
  const T mm = m0 + m1;
  T com[NDIM], lo[NDIM], hi[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    const T s = m0 * kids[0][Lay::kCCom + k] + m1 * kids[1][Lay::kCCom + k];
    com[k] = mm > T(0) ? s / max(mm, T(1e-30)) : T(kFar);
    T l = T(kBig), h = T(-kBig);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (kids[j][Lay::kCM] > T(0)) {
        l = min(l, kid_box[j][k]);
        h = max(h, kid_box[j][NDIM + k]);
      }
    }
    lo[k] = mm > T(0) ? l : T(kFar);
    hi[k] = mm > T(0) ? h : T(kFar);
    com[k] = min(max(com[k], lo[k]), hi[k]);  // inside the box (F30)
  }
  T q[Lay::kNQ];
#pragma unroll
  for (int k = 0; k < Lay::kNQ; ++k) q[k] = T(0);
  if (quadrupole) {
    T dq[Lay::kNQ];
#pragma unroll
    for (int k = 0; k < Lay::kNQ; ++k) dq[k] = T(0);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const T mj = kids[j][Lay::kCM];
      T d[NDIM];
#pragma unroll
      for (int k = 0; k < NDIM; ++k)
        d[k] = mj > T(0) ? kids[j][Lay::kCCom + k] - com[k] : T(0);
#pragma unroll
      for (int a = 0; a < NDIM; ++a) {
#pragma unroll
        for (int b = a; b < NDIM; ++b) dq[tri<NDIM>(a, b)] += mj * d[a] * d[b];
      }
    }
    T tr = dq[tri<NDIM>(0, 0)];
#pragma unroll
    for (int k = 1; k < NDIM; ++k) tr += dq[tri<NDIM>(k, k)];
#pragma unroll
    for (int k = 0; k < Lay::kNQ; ++k)
      q[k] = kids[0][Lay::kCQ + k] + kids[1][Lay::kCQ + k] + T(3) * dq[k];
#pragma unroll
    for (int k = 0; k < NDIM; ++k) q[tri<NDIM>(k, k)] -= tr;
  }
  const long long row = (1LL << level) - 1 + c;
  write_cell<T, NDIM>(ctab + Lay::kCCols * row, mm, com, lo, hi, q);
  write_box<T, NDIM>(box + kBox * row, lo, hi);
}

template <typename T, int NDIM>
int run_build(const T* ptab, const unsigned char* alive, int depth,
              int quadrupole, T* ctab, T* box, int device,
              void* stream_ptr) {
  using Lay = Layout<NDIM>;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  constexpr int kThreads = 256;
  const int n_leaves = 1 << depth;
  const long long leaf_threads = static_cast<long long>(n_leaves) * kLeaf;
  tree_leaf_kernel<T, NDIM><<<static_cast<int>((leaf_threads + kThreads - 1)
                                               / kThreads), kThreads, 0,
                              stream>>>(
      ptab, alive, n_leaves, quadrupole,
      ctab + Lay::kCCols * static_cast<long long>(n_leaves - 1),
      box + 2LL * NDIM * (n_leaves - 1));
  err = cudaGetLastError();
  for (int level = depth - 1; level >= 0 && err == cudaSuccess; --level) {
    const int cells = 1 << level;
    tree_merge_kernel<T, NDIM><<<(cells + kThreads - 1) / kThreads, kThreads,
                                 0, stream>>>(ctab, box, level, quadrupole);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

#define TREE_BUILD_ENTRY(NAME, T, NDIM)                                     \
  int NAME(const T* ptab, const unsigned char* alive, int depth,            \
           int quadrupole, T* ctab, T* box, int device, void* stream) {     \
    return run_build<T, NDIM>(ptab, alive, depth, quadrupole, ctab, box,    \
                              device, stream);                              \
  }

TREE_BUILD_ENTRY(tree_build_3d_f32, float, 3)
TREE_BUILD_ENTRY(tree_build_3d_f64, double, 3)
TREE_BUILD_ENTRY(tree_build_2d_f32, float, 2)
TREE_BUILD_ENTRY(tree_build_2d_f64, double, 2)
TREE_BUILD_ENTRY(tree_build_1d_f32, float, 1)
TREE_BUILD_ENTRY(tree_build_1d_f64, double, 1)

}  // extern "C"
