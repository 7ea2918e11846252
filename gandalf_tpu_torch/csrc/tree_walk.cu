// K6 tree_walk: per-group frontier walk of the tree with the geometric
// MAC, the far field of accepted cells, and the near list of opened
// leaves.
//
// Replaces gandalf_tpu/ops/tree.py:tree_gravity -> walk_group (:390-592)
// with _compact (:268-279), in its non-fast, non-Ewald, geometric-MAC
// form.  There each group gathers a padded frontier of W cells per level
// and evaluates the far field as (L, W) matrix products, with distances
// from a dot-product expansion.
//
// Bound on the card: latency of dependent gathers.  Each level's
// frontier depends on the last, the cell rows are scattered through a
// table of 2^(D+1) rows, and per accepted cell every lane does ~60 flops
// of quadrupole far field; at 262,144 particles 8,192 groups walk 14
// levels each.
//
// Design: one warp per group, lane = target slot.  The frontier is
// double-buffered in shared memory.  Per level the warp takes the
// frontier 32 cells at a time, lane c loading cell c: the MAC (per-axis
// gap = max(|com - gc| - gh, 0), accept if dsqd * theta^2 > sum half^2,
// neither accepted nor opened if m = 0) is the same test for every lane,
// so two ballots give the accepted and opened cells.  Each accepted cell
// is shuffled to all lanes, which add its far field at dr = com - r_i,
// computed directly.  The children of opened cells go to the next
// frontier at a prefix sum of the ballot (stable, so in the order of
// gandalf_tpu's _compact); at the leaf level the opened leaves form the
// near list (-1 padded).  Overflow iff the opened children exceed the
// next level's cap min(frontier, 2^(l+1), frontier_levels[l+1]), or the
// opened leaves exceed the near cap.  An empty group walks nothing.
//
// With a group list (the active groups of a block-timestep tick,
// gandalf_tpu/ops/tree.py:tree_gravity_active :1429 with group_ids),
// warp k walks group group_ids[k], and only the listed groups' rows are
// written; the wrapper zeroes the rest.  Without one, warp k walks group
// k of all 2^depth.
#include <cuda_runtime.h>

#include "tree.cuh"

namespace {

using namespace tree;

struct LevelCaps {
  int w[kMaxLevels + 1];
};

template <typename T>
__device__ __forceinline__ T safe_invr(T d2);

template <>
__device__ __forceinline__ float safe_invr<float>(float d2) {
  return d2 > 1e-24f ? rsqrtf(d2) : 0.0f;
}

template <>
__device__ __forceinline__ double safe_invr<double>(double d2) {
  return d2 > 1e-60 ? rsqrt(d2) : 0.0;
}

template <typename T>
__global__ void tree_walk_kernel(const T* __restrict__ ctab,
                                 const T* __restrict__ ptab,
                                 const unsigned char* __restrict__ alive,
                                 const int* __restrict__ group_ids,
                                 int n_groups, int depth, int near_cap,
                                 int wmax, T theta_sqd, int quadrupole,
                                 LevelCaps caps,
                                 T* __restrict__ a_far,
                                 T* __restrict__ pot_far,
                                 int* __restrict__ near,
                                 unsigned char* __restrict__ overflow) {
  extern __shared__ int frontier[];
  const int wib = threadIdx.x / kLeaf;
  const int lane = threadIdx.x % kLeaf;
  const int gk = blockIdx.x * (blockDim.x / kLeaf) + wib;
  if (gk >= n_groups) return;  // whole warps leave together
  const int g = group_ids != nullptr ? group_ids[gk] : gk;
  const long long slot = static_cast<long long>(g) * kLeaf + lane;
  const bool live = alive[slot] != 0;
  int* near_g = near + static_cast<long long>(g) * near_cap;
  if (!__ballot_sync(kFull, live)) {
    for (int w = lane; w < near_cap; w += kLeaf) near_g[w] = -1;
    a_far[3 * slot] = a_far[3 * slot + 1] = a_far[3 * slot + 2] = T(0);
    pot_far[slot] = T(0);
    return;
  }
  const T* p = ptab + kPCols * slot;
  const T rx = p[0], ry = p[1], rz = p[2];
  const T* leaf = ctab + kCCols * ((1LL << depth) - 1 + g);
  const T gc[3] = {leaf[kCCen], leaf[kCCen + 1], leaf[kCCen + 2]};
  const T gh[3] = {leaf[kCHalf], leaf[kCHalf + 1], leaf[kCHalf + 2]};
  int* cur = frontier + 2 * wmax * wib;
  int* nxt = cur + wmax;
  if (lane == 0) cur[0] = 0;
  __syncwarp();
  int ncur = 1;
  bool ovf = false;
  T ax = T(0), ay = T(0), az = T(0), pot = T(0);
  for (int ell = 0; ell <= depth; ++ell) {
    const bool at_leaves = ell == depth;
    const int cap = at_leaves ? near_cap : caps.w[ell + 1];
    const T* rows = ctab + kCCols * ((1LL << ell) - 1);
    int nnext = 0;
    for (int base = 0; base < ncur; base += kLeaf) {
      const int k = base + lane;
      int cell = -1;
      T m = T(0), com[3] = {T(0), T(0), T(0)};
      T q[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      bool acc = false, opn = false;
      if (k < ncur) {
        cell = cur[k];
        const T* row = rows + kCCols * static_cast<long long>(cell);
        m = row[kCM];
        // the MAC with round-to-nearest steps in the plain version's
        // order, so both take the same decisions bit for bit
        T dsqd = T(0), rmax_sqd = T(0);
#pragma unroll
        for (int kk = 0; kk < 3; ++kk) {
          com[kk] = row[kCCom + kk];
          const T gap = max(fabs(com[kk] - gc[kk]) - gh[kk], T(0));
          const T hk = row[kCHalf + kk];
          const T g2 = mul_rn(gap, gap), h2 = mul_rn(hk, hk);
          dsqd = kk == 0 ? g2 : add_rn(dsqd, g2);
          rmax_sqd = kk == 0 ? h2 : add_rn(rmax_sqd, h2);
        }
        acc = m > T(0) && mul_rn(dsqd, theta_sqd) > rmax_sqd;
        opn = m > T(0) && !acc;
        if (acc && quadrupole) {
#pragma unroll
          for (int kk = 0; kk < 6; ++kk) q[kk] = row[kCQ + kk];
        }
      }
      const unsigned amask = __ballot_sync(kFull, acc);
      const unsigned omask = __ballot_sync(kFull, opn);
      for (unsigned bits = amask; bits; bits &= bits - 1) {
        const int src = __ffs(bits) - 1;
        const T cm = __shfl_sync(kFull, m, src);
        const T dx = __shfl_sync(kFull, com[0], src) - rx;
        const T dy = __shfl_sync(kFull, com[1], src) - ry;
        const T dz = __shfl_sync(kFull, com[2], src) - rz;
        const T inv_r = safe_invr(dx * dx + dy * dy + dz * dz);
        const T inv_r3 = inv_r * inv_r * inv_r;
        ax += cm * inv_r3 * dx;
        ay += cm * inv_r3 * dy;
        az += cm * inv_r3 * dz;
        pot += cm * inv_r;
        if (quadrupole) {
          T qs[6];
#pragma unroll
          for (int kk = 0; kk < 6; ++kk)
            qs[kk] = __shfl_sync(kFull, q[kk], src);
          const T qx = qs[0] * dx + qs[1] * dy + qs[2] * dz;
          const T qy = qs[1] * dx + qs[3] * dy + qs[4] * dz;
          const T qz = qs[2] * dx + qs[4] * dy + qs[5] * dz;
          const T drqdr = qx * dx + qy * dy + qz * dz;
          const T inv_r5 = inv_r3 * inv_r * inv_r;
          const T s7 = T(2.5) * drqdr * inv_r5 * inv_r * inv_r;
          ax += s7 * dx - inv_r5 * qx;
          ay += s7 * dy - inv_r5 * qy;
          az += s7 * dz - inv_r5 * qz;
          pot += T(0.5) * drqdr * inv_r5;
        }
      }
      const int rank = __popc(omask & ((1u << lane) - 1u));
      if (!at_leaves) {
        const int pos = nnext + 2 * rank;
        if (opn && pos < cap) nxt[pos] = 2 * cell;
        if (opn && pos + 1 < cap) nxt[pos + 1] = 2 * cell + 1;
        nnext += 2 * __popc(omask);
      } else {
        const int pos = nnext + rank;
        if (opn && pos < cap) near_g[pos] = cell;
        nnext += __popc(omask);
      }
    }
    ovf = ovf || nnext > cap;
    ncur = nnext < cap ? nnext : cap;
    __syncwarp();
    int* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int w = ncur + lane; w < near_cap; w += kLeaf) near_g[w] = -1;
  a_far[3 * slot] = live ? ax : T(0);
  a_far[3 * slot + 1] = live ? ay : T(0);
  a_far[3 * slot + 2] = live ? az : T(0);
  pot_far[slot] = live ? pot : T(0);
  if (ovf && lane == 0) *overflow = 1;
}

template <typename T>
int run_walk(const T* ctab, const T* ptab, const unsigned char* alive,
             const int* group_ids, int n_groups, int depth, int near_cap,
             const int* level_caps, double theta_sqd, int quadrupole,
             T* a_far, T* pot_far, int* near, unsigned char* overflow,
             int device, void* stream_ptr) {
  if (depth < 0 || depth > kMaxLevels || near_cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  LevelCaps caps = {};
  int wmax = 1;
  for (int ell = 1; ell <= depth; ++ell) {
    caps.w[ell] = level_caps[ell];
    wmax = level_caps[ell] > wmax ? level_caps[ell] : wmax;
  }
  // two frontier buffers per warp; fewer warps per block when they are
  // wide, and more than the default 48 KB only when one warp needs it
  const size_t per_warp = 2 * sizeof(int) * static_cast<size_t>(wmax);
  int warps = 4;
  while (warps > 1 && warps * per_warp > 48 * 1024) warps /= 2;
  const size_t smem = warps * per_warp;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(tree_walk_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int groups = group_ids != nullptr ? n_groups : 1 << depth;
  if (groups > 0)
    tree_walk_kernel<T><<<(groups + warps - 1) / warps, warps * kLeaf, smem,
                          stream>>>(ctab, ptab, alive, group_ids, groups,
                                    depth, near_cap, wmax, T(theta_sqd),
                                    quadrupole, caps, a_far, pot_far, near,
                                    overflow);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define TREE_WALK_ENTRY(NAME, T)                                            \
  int NAME(const T* ctab, const T* ptab, const unsigned char* alive,        \
           const int* group_ids, int n_groups, int depth, int near_cap,     \
           const int* level_caps, double theta_sqd, int quadrupole,         \
           T* a_far, T* pot_far, int* near, unsigned char* overflow,        \
           int device, void* stream) {                                      \
    return run_walk<T>(ctab, ptab, alive, group_ids, n_groups, depth,       \
                       near_cap, level_caps, theta_sqd, quadrupole, a_far,  \
                       pot_far, near, overflow, device, stream);            \
  }

TREE_WALK_ENTRY(tree_walk_f32, float)
TREE_WALK_ENTRY(tree_walk_f64, double)

}  // extern "C"
