// K4 tree_gather: particle fields into bucket order, with each bucket
// unwrapped about its first real slot along the periodic dims, in 1-3
// dims (NDIM a template parameter; one entry per NDIM and type).
//
// Replaces the gather of gandalf_tpu/ops/tree.py:tree_gravity_grouped
// (:1365-1382) and unwrap_to_buckets (:1140-1164).  The scatter back to
// particle order is K7's epilogue.
//
// Bound on the card: memory.  It reads NDIM + 3 values per particle
// through the gather map and writes as many per slot, about 100 bytes
// per particle in 3D; at
// 262,144 particles a few microseconds, a small share of a step.
//
// Design: one warp per bucket, lane = slot.  A ballot over the live
// slots finds the anchor (the first real slot) and a shuffle hands its
// position to the warp.  The unwrap is delta - ext * rint(delta / ext)
// written with round-to-nearest intrinsics, so that nvcc cannot contract
// it into an FMA and the result equals the plain version's exactly.
// Empty slots get position 0, m = 0, h = 1, zh = 0 and alive = 0; the
// later kernels skip them by the flag, with no sentinel arithmetic.  With
// a per-particle alive byte (the sink slices' dead, accreted gas) a slot's
// flag is also its particle's: a dead particle keeps its row (position,
// m = 0, h) and anchors the unwrap as before, but no later kernel counts
// it, as alive_s = in_map & alive[gmap] does at gandalf_tpu/ops/tree.py
// :1373.
#include <cuda_runtime.h>

#include "tree.cuh"

namespace {

using namespace tree;

template <typename T, int NDIM>
__global__ void tree_gather_kernel(const int* __restrict__ gmap, int n_buckets,
                                   const T* __restrict__ r,
                                   const T* __restrict__ m,
                                   const T* __restrict__ h,
                                   const T* __restrict__ zh,
                                   const unsigned char* __restrict__ alive_in,
                                   int unwrap,
                                   T ext0, T ext1, T ext2,
                                   T* __restrict__ ptab,
                                   unsigned char* __restrict__ alive) {
  using Lay = Layout<NDIM>;
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) / kLeaf;
  const int lane = threadIdx.x % kLeaf;
  if (g >= n_buckets) return;  // whole warps leave together
  const long long slot = static_cast<long long>(g) * kLeaf + lane;
  const int pid = gmap[slot];
  const bool live = pid >= 0;
  const unsigned live_mask = __ballot_sync(kFull, live);
  const T ext[3] = {ext0, ext1, ext2};
  T x[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k)
    x[k] = live ? r[static_cast<long long>(NDIM) * pid + k] : T(0);
  if (unwrap && live_mask) {
    const int first = __ffs(live_mask) - 1;
#pragma unroll
    for (int k = 0; k < NDIM; ++k) {
      const T anchor = __shfl_sync(kFull, x[k], first);
      T d = sub_rn(x[k], anchor);
      if (ext[k] > T(0)) d = sub_rn(d, mul_rn(ext[k], rint(div_rn(d, ext[k]))));
      if (live) x[k] = add_rn(anchor, d);
    }
  }
  T* row = ptab + Lay::kPCols * slot;
#pragma unroll
  for (int k = 0; k < NDIM; ++k) row[Lay::kPX + k] = x[k];
  row[Lay::kPM] = live ? m[pid] : T(0);
  row[Lay::kPH] = live ? (h ? h[pid] : T(1)) : T(1);
  row[Lay::kPZH] = live && zh ? zh[pid] : T(0);
  alive[slot] = live && (alive_in == nullptr || alive_in[pid]) ? 1 : 0;
}

template <typename T, int NDIM>
int run_gather(const int* gmap, int n_buckets, const T* r, const T* m,
               const T* h, const T* zh, const unsigned char* alive_in,
               int unwrap, double ext0, double ext1, double ext2, T* ptab,
               unsigned char* alive, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  constexpr int kThreads = 256;
  const long long threads = static_cast<long long>(n_buckets) * kLeaf;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  if (blocks > 0)
    tree_gather_kernel<T, NDIM><<<blocks, kThreads, 0, stream>>>(
        gmap, n_buckets, r, m, h, zh, alive_in, unwrap, T(ext0), T(ext1),
        T(ext2), ptab, alive);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define TREE_GATHER_ENTRY(NAME, T, NDIM)                                    \
  int NAME(const int* gmap, int n_buckets, const T* r, const T* m,          \
           const T* h, const T* zh, const unsigned char* alive_in,          \
           int unwrap, double ext0, double ext1, double ext2, T* ptab,      \
           unsigned char* alive, int device, void* stream) {                \
    return run_gather<T, NDIM>(gmap, n_buckets, r, m, h, zh, alive_in,      \
                               unwrap, ext0, ext1, ext2, ptab, alive,       \
                               device, stream);                             \
  }

TREE_GATHER_ENTRY(tree_gather_3d_f32, float, 3)
TREE_GATHER_ENTRY(tree_gather_3d_f64, double, 3)
TREE_GATHER_ENTRY(tree_gather_2d_f32, float, 2)
TREE_GATHER_ENTRY(tree_gather_2d_f64, double, 2)
TREE_GATHER_ENTRY(tree_gather_1d_f32, float, 1)
TREE_GATHER_ENTRY(tree_gather_1d_f64, double, 1)

}  // extern "C"
