// K5 tree_build: mass, centre of mass, bounding box and traceless
// quadrupole of every tree cell, leaves to root.
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
// Design: one warp per leaf, lane = slot, reduces with butterfly
// shuffles (a fixed order, so the result is deterministic).  Dead slots
// are masked out before the outer product; an empty leaf gets m = 0 and
// COM and box at the far sentinel; the COM is divided only where m > 0.
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

template <typename T>
__device__ __forceinline__ void write_cell(T* row, T m, const T com[3],
                                           const T lo[3], const T hi[3],
                                           const T q[6]) {
  row[kCM] = m;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    row[kCCom + k] = com[k];
    row[kCHalf + k] = T(0.5) * (hi[k] - lo[k]);
    row[kCCen + k] = T(0.5) * (lo[k] + hi[k]);
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) row[kCQ + k] = q[k];
}

// lo and hi of each cell, kept exact beside the table (which holds the
// centre and half-width) for the merge of the next level up
template <typename T>
__device__ __forceinline__ void write_box(T* box, const T lo[3],
                                          const T hi[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    box[k] = lo[k];
    box[3 + k] = hi[k];
  }
}

template <typename T>
__global__ void tree_leaf_kernel(const T* __restrict__ ptab,
                                 const unsigned char* __restrict__ alive,
                                 int n_leaves, int quadrupole,
                                 T* __restrict__ leaf_rows,
                                 T* __restrict__ leaf_box) {
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) / kLeaf;
  const int lane = threadIdx.x % kLeaf;
  if (g >= n_leaves) return;
  const long long slot = static_cast<long long>(g) * kLeaf + lane;
  const bool live = alive[slot] != 0;
  const T* p = ptab + kPCols * slot;
  const T x[3] = {p[0], p[1], p[2]};
  const T m = live ? p[kPM] : T(0);
  const T m_tot = warp_sum(m);
  T com[3], lo[3], hi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T s = warp_sum(m * x[k]);
    com[k] = m_tot > T(0) ? s / max(m_tot, T(1e-30)) : T(kFar);
    lo[k] = warp_min(live ? x[k] : T(kBig));
    hi[k] = warp_max(live ? x[k] : T(-kBig));
    if (!(m_tot > T(0))) lo[k] = hi[k] = T(kFar);
  }
  T q[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  if (quadrupole) {
    T d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = live ? x[k] - com[k] : T(0);
    q[0] = warp_sum(m * d[0] * d[0]);
    q[1] = warp_sum(m * d[0] * d[1]);
    q[2] = warp_sum(m * d[0] * d[2]);
    q[3] = warp_sum(m * d[1] * d[1]);
    q[4] = warp_sum(m * d[1] * d[2]);
    q[5] = warp_sum(m * d[2] * d[2]);
    const T tr = q[0] + q[3] + q[5];
#pragma unroll
    for (int k = 0; k < 6; ++k) q[k] = T(3) * q[k];
    q[0] -= tr;
    q[3] -= tr;
    q[5] -= tr;
  }
  if (lane == 0) {
    write_cell(leaf_rows + kCCols * static_cast<long long>(g), m_tot, com,
               lo, hi, q);
    write_box(leaf_box + 6LL * g, lo, hi);
  }
}

template <typename T>
__global__ void tree_merge_kernel(T* __restrict__ ctab, T* __restrict__ box,
                                  int level, int quadrupole) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= (1 << level)) return;
  const long long first_kid = (2LL << level) - 1 + 2LL * c;
  const T* kid = ctab + kCCols * first_kid;
  const T* kids[2] = {kid, kid + kCCols};
  const T* kid_box[2] = {box + 6 * first_kid, box + 6 * first_kid + 6};
  const T m0 = kids[0][kCM], m1 = kids[1][kCM];
  const T mm = m0 + m1;
  T com[3], lo[3], hi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T s = m0 * kids[0][kCCom + k] + m1 * kids[1][kCCom + k];
    com[k] = mm > T(0) ? s / max(mm, T(1e-30)) : T(kFar);
    T l = T(kBig), h = T(-kBig);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (kids[j][kCM] > T(0)) {
        l = min(l, kid_box[j][k]);
        h = max(h, kid_box[j][3 + k]);
      }
    }
    lo[k] = mm > T(0) ? l : T(kFar);
    hi[k] = mm > T(0) ? h : T(kFar);
  }
  T q[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  if (quadrupole) {
    T dq[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const T mj = kids[j][kCM];
      T d[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        d[k] = mj > T(0) ? kids[j][kCCom + k] - com[k] : T(0);
      dq[0] += mj * d[0] * d[0];
      dq[1] += mj * d[0] * d[1];
      dq[2] += mj * d[0] * d[2];
      dq[3] += mj * d[1] * d[1];
      dq[4] += mj * d[1] * d[2];
      dq[5] += mj * d[2] * d[2];
    }
    const T tr = dq[0] + dq[3] + dq[5];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      q[k] = kids[0][kCQ + k] + kids[1][kCQ + k] + T(3) * dq[k];
    q[0] -= tr;
    q[3] -= tr;
    q[5] -= tr;
  }
  const long long row = (1LL << level) - 1 + c;
  write_cell(ctab + kCCols * row, mm, com, lo, hi, q);
  write_box(box + 6 * row, lo, hi);
}

template <typename T>
int run_build(const T* ptab, const unsigned char* alive, int depth,
              int quadrupole, T* ctab, T* box, int device,
              void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  constexpr int kThreads = 256;
  const int n_leaves = 1 << depth;
  const long long leaf_threads = static_cast<long long>(n_leaves) * kLeaf;
  tree_leaf_kernel<T><<<static_cast<int>((leaf_threads + kThreads - 1)
                                         / kThreads), kThreads, 0, stream>>>(
      ptab, alive, n_leaves, quadrupole,
      ctab + kCCols * static_cast<long long>(n_leaves - 1),
      box + 6LL * (n_leaves - 1));
  err = cudaGetLastError();
  for (int level = depth - 1; level >= 0 && err == cudaSuccess; --level) {
    const int cells = 1 << level;
    tree_merge_kernel<T><<<(cells + kThreads - 1) / kThreads, kThreads, 0,
                           stream>>>(ctab, box, level, quadrupole);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

#define TREE_BUILD_ENTRY(NAME, T)                                           \
  int NAME(const T* ptab, const unsigned char* alive, int depth,            \
           int quadrupole, T* ctab, T* box, int device, void* stream) {     \
    return run_build<T>(ptab, alive, depth, quadrupole, ctab, box, device,  \
                        stream);                                            \
  }

TREE_BUILD_ENTRY(tree_build_f32, float)
TREE_BUILD_ENTRY(tree_build_f64, double)

}  // extern "C"
