// K38 let_far_walk: the far field of the far shards' published cell
// tables at the targets of each local leaf group, in 1-3 dims, for the
// ring LET gravity of the distributed controller.
//
// Replaces gandalf_tpu/parallel/let.py:let_gravity -> far_group
// (:330-413) with _mp_eval (:212-233), without its Ewald branches (the
// port refuses Ewald over shards).  There each group walks each far
// shard's table level by level: a frontier of min(2^l, Wr) entries, an
// unopened cell's children -1 entries below the cap and compacted away
// (stable) above it, every entry evaluated as an (L, W) block with the
// mass of an entry that is not accepted set to zero.  That block also
// adds the quadrupole of every entry it does not accept (fault F35);
// this kernel adds the accepted cells' moments only, which leaves the
// same frontier: the first Wr children of the opened cells, in order.
// A group with no live target is not walked, and a dead target gets
// zero (the JAX package walks them too, and discards them).
//
// Bound on the card: operations.  Per group with a live target and far
// table a frontier of up to Wr cells a level is tested, and each
// accepted cell adds ~60 flops of quadrupole far field at each live
// target; the tables (a few hundred KB a shard) stay in L2.
//
// Design: one warp per group, lane = target slot; the far tables in
// turn.  The frontier is double-buffered in shared memory.  Per level
// the warp takes it 32 entries at a time, lane c loading entry c: the
// MAC (per-axis gap from the group's box, gap^2 theta^2 > sum half^2,
// the sums in the plain version's order without FMA contraction, so
// that both decide alike) is one ballot; each accepted cell is shuffled
// to all lanes, which add its field at dr = com - r_i.  Opened cells'
// children go to the next buffer at a prefix sum of the ballot, the
// first Wr of them.  The flag: an occupied leaf that fails the MAC, or
// more children than Wr.
#include <cuda_runtime.h>

#include "tree_walk.cuh"

namespace {

using namespace tree;

// MAC sums in round-to-nearest steps, term by term (ops/tree.py:_sum_sq)
template <typename T, int NDIM>
__device__ __forceinline__ T sum_sq_rn(const T d[NDIM]) {
  T s = mul_rn(d[0], d[0]);
#pragma unroll
  for (int k = 1; k < NDIM; ++k) s = add_rn(s, mul_rn(d[k], d[k]));
  return s;
}

template <typename T, int NDIM>
__global__ void let_far_kernel(const T* __restrict__ tabs, int n_far,
                               int rows, int depth, int quadrupole,
                               const T* __restrict__ leaf_cen,
                               const T* __restrict__ leaf_half,
                               const T* __restrict__ rt,
                               const unsigned char* __restrict__ alive,
                               int n_groups,
                               int wr, T theta_sqd, T* __restrict__ a_out,
                               T* __restrict__ pot_out,
                               unsigned char* __restrict__ flag_out) {
  using Lay = Layout<NDIM>;
  constexpr int C = Lay::kCCols;
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.x * (blockDim.x >> 5) + warp;
  if (g >= n_groups) return;
  const long long slot = static_cast<long long>(g) * kLeaf + lane;
  const bool live = alive[slot] != 0;
  // a group with no live target: zeros, no flag, no walk
  const bool walk = __any_sync(kFull, live);
  int* buf[2] = {smem + 2 * warp * wr, smem + (2 * warp + 1) * wr};
  T gc[NDIM], gh[NDIM], r[NDIM], acc[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    gc[k] = leaf_cen[NDIM * g + k];
    gh[k] = leaf_half[NDIM * g + k];
    r[k] = rt[slot * NDIM + k];
    acc[k] = T(0);
  }
  T pot = T(0);
  bool flag = false;
  for (int t = 0; walk && t < n_far; ++t) {
    const T* tab = tabs + static_cast<long long>(t) * rows * C;
    int cur = 0;
    if (lane == 0) buf[0][0] = 0;
    __syncwarp();
    int nv = 1;  // the frontier's entries
    for (int ell = 0; ell <= depth; ++ell) {
      const T* lvl = tab + static_cast<long long>((1 << ell) - 1) * C;
      const bool leaf = ell == depth;
      int n_kids = 0;
      for (int base = 0; base < nv; base += 32) {
        const int j = base + lane;
        int idx = 0;
        bool acc_c = false, open_c = false;
        if (j < nv) {
          idx = buf[cur][j];
          const T* cell = lvl + static_cast<long long>(idx) * C;
          if (cell[Lay::kCM] > T(0)) {
            T gap[NDIM], hf[NDIM];
#pragma unroll
            for (int k = 0; k < NDIM; ++k) {
              const T dc = fabs(sub_rn(cell[Lay::kCCom + k], gc[k]));
              gap[k] = max(sub_rn(dc, gh[k]), T(0));
              hf[k] = cell[Lay::kCHalf + k];
            }
            const bool passed = mul_rn(sum_sq_rn<T, NDIM>(gap), theta_sqd)
                                > sum_sq_rn<T, NDIM>(hf);
            acc_c = leaf || passed;
            open_c = !leaf && !passed;
            flag = flag || (leaf && !passed);
          }
        }
        unsigned acc_m = __ballot_sync(kFull, acc_c);
        const unsigned open_m = __ballot_sync(kFull, open_c);
        while (acc_m) {
          const int c = __ffs(acc_m) - 1;
          acc_m &= acc_m - 1;
          const int ic = __shfl_sync(kFull, idx, c);
          const T* cell = lvl + static_cast<long long>(ic) * C;
          T d[NDIM], q[Lay::kNQ];
#pragma unroll
          for (int k = 0; k < NDIM; ++k) d[k] = cell[Lay::kCCom + k] - r[k];
#pragma unroll
          for (int k = 0; k < Lay::kNQ; ++k)
            q[k] = quadrupole ? cell[Lay::kCQ + k] : T(0);
          if (live)
            multipole<T, NDIM>(d, cell[Lay::kCM], q, quadrupole != 0, acc,
                               pot);
        }
        if (open_c) {
          const int pos = n_kids
                          + 2 * __popc(open_m & ((1u << lane) - 1u));
          if (pos < wr) buf[cur ^ 1][pos] = 2 * idx;
          if (pos + 1 < wr) buf[cur ^ 1][pos + 1] = 2 * idx + 1;
        }
        n_kids += 2 * __popc(open_m);
      }
      __syncwarp();
      flag = flag || n_kids > wr;
      nv = min(n_kids, wr);
      cur ^= 1;
    }
  }
#pragma unroll
  for (int k = 0; k < NDIM; ++k) a_out[NDIM * slot + k] = acc[k];
  pot_out[slot] = pot;
  const bool any = __any_sync(kFull, flag);
  if (lane == 0) flag_out[g] = any ? 1 : 0;
}

template <typename T, int NDIM>
int run_let_far(const T* tabs, int n_far, int rows, int ccols, int depth,
                int quadrupole, const T* leaf_cen, const T* leaf_half,
                const T* rt, const unsigned char* alive, int n_groups,
                int leaf_size, int wr,
                double theta_sqd, T* a, T* pot, unsigned char* flag,
                int device, void* stream_ptr) {
  if (ccols != Layout<NDIM>::kCCols || leaf_size != kLeaf || wr < 1
      || depth < 0 || depth > kMaxLevels || rows != (2 << depth) - 1
      || n_far < 0 || n_groups < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // two frontier buffers of wr entries per warp
  const size_t per_warp = 2 * sizeof(int) * static_cast<size_t>(wr);
  int warps = 4;
  while (warps > 1 && warps * per_warp > 48 * 1024) warps /= 2;
  const size_t smem = warps * per_warp;
  auto kernel = let_far_kernel<T, NDIM>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_groups > 0)
    kernel<<<(n_groups + warps - 1) / warps, warps * kLeaf, smem, stream>>>(
        tabs, n_far, rows, depth, quadrupole, leaf_cen, leaf_half, rt,
        alive, n_groups, wr, T(theta_sqd), a, pot, flag);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define LET_FAR_ENTRY(NAME, T, NDIM)                                        \
  extern "C" int NAME(const T* tabs, int n_far, int rows, int ccols,        \
                      int depth, int quadrupole, const T* leaf_cen,         \
                      const T* leaf_half, const T* rt,                      \
                      const unsigned char* alive, int n_groups,             \
                      int leaf_size, int wr, double theta_sqd, T* a,        \
                      T* pot, unsigned char* flag, int device,              \
                      void* stream) {                                       \
    return run_let_far<T, NDIM>(tabs, n_far, rows, ccols, depth,           \
                                quadrupole, leaf_cen, leaf_half, rt, alive, \
                                n_groups, leaf_size, wr, theta_sqd, a, pot, \
                                flag, device, stream);                      \
  }

LET_FAR_ENTRY(let_far_walk_1d_f32, float, 1)
LET_FAR_ENTRY(let_far_walk_1d_f64, double, 1)
LET_FAR_ENTRY(let_far_walk_2d_f32, float, 2)
LET_FAR_ENTRY(let_far_walk_2d_f64, double, 2)
LET_FAR_ENTRY(let_far_walk_3d_f32, float, 3)
LET_FAR_ENTRY(let_far_walk_3d_f64, double, 3)
