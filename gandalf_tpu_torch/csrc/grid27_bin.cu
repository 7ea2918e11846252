// K1 grid27_bin: cell id and stable slot rank of every particle, in 1, 2
// or 3 dims, with an optional discard mask and a clamp of the dim-0 cell
// index (zrow_max: a shard's last real row of the distributed slab
// layout, gandalf_tpu/ops/sph_grid27.py:193-194, whose pad rows double
// as the halo's receive window and stay empty).
//
// Replaces gandalf_tpu/ops/sph_grid27.py:bin_particles (:193-231), which
// ranks particles within their cell by a stable argsort plus a segmented
// max-scan.  A discarded particle (a mirror image beyond its layer) goes
// to the virtual cell C = n_cells, takes no slot and raises no overflow;
// its slot_of is 0 (JAX ranks the discarded among themselves, which no
// caller reads).
//
// Bound on the card: it moves about 40 bytes per particle and does almost
// no arithmetic, so it is bound by memory latency and by four launches;
// at 262,144 particles it is a small share of a step.
//
// Design:
//   1. one thread per particle: cell id with the JAX floor and clip, and a
//      provisional slot from an atomicAdd histogram;
//   2. one block: exclusive scan of the cell counts, and the overflow flag
//      (some cell holds more than K particles);
//   3. one thread per particle: write its index into its cell's segment at
//      the provisional slot;
//   4. one block per cell: the stable rank of each member is the number of
//      members with a smaller particle index.  This restores the JAX rank
//      exactly and makes the result independent of the atomics' order.
// slot_of is clamped to K-1 like the JAX version.  No sort from a library
// does the ranking.
#include <cuda_runtime.h>

#include "grid27.cuh"

namespace {

template <typename T>
__global__ void bin_count_kernel(const T* __restrict__ r, int n_part,
                                 int ndim, Grid3 g, T lo0, T lo1, T lo2,
                                 T e0, T e1, T e2, int zrow_max,
                                 const unsigned char* __restrict__ discard,
                                 int* __restrict__ count,
                                 int* __restrict__ rank_tmp,
                                 int* __restrict__ cell_of,
                                 int* __restrict__ slot_of) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_part) return;
  if (discard != nullptr && discard[i]) {
    cell_of[i] = g.n[0] * g.n[1] * g.n[2];
    slot_of[i] = 0;
    return;
  }
  const T lo[3] = {lo0, lo1, lo2};
  const T ext[3] = {e0, e1, e2};
  int cid = 0;
  for (int k = 0; k < ndim; ++k) {
    // floor((x - lo) / extent * n), clipped to [0, n-1] (clipping the
    // float first keeps the int conversion defined for far particles)
    T f = floor((r[static_cast<long long>(ndim) * i + k] - lo[k]) / ext[k]
                * T(g.n[k]));
    const int top = k == 0 ? min(zrow_max, g.n[0] - 1) : g.n[k] - 1;
    f = f < T(0) ? T(0) : f;
    f = f > T(top) ? T(top) : f;
    cid = cid * g.n[k] + static_cast<int>(f);
  }
  cell_of[i] = cid;
  rank_tmp[i] = atomicAdd(&count[cid], 1);
}

constexpr int kScanThreads = 1024;

__global__ void bin_scan_kernel(const int* __restrict__ count, int n_cells,
                                int k_cell, int* __restrict__ offset,
                                unsigned char* __restrict__ overflow) {
  __shared__ int part[kScanThreads];
  __shared__ int any_over;
  const int t = threadIdx.x;
  if (t == 0) any_over = 0;
  __syncthreads();
  const int per = (n_cells + kScanThreads - 1) / kScanThreads;
  const int b = t * per;
  const int e = min(b + per, n_cells);
  int sum = 0;
  bool over = false;
  for (int c = b; c < e; ++c) {
    sum += count[c];
    over |= count[c] > k_cell;
  }
  if (over) any_over = 1;
  part[t] = sum;
  __syncthreads();
  for (int step = 1; step < kScanThreads; step <<= 1) {
    const int v = t >= step ? part[t - step] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int run = part[t] - sum;
  for (int c = b; c < e; ++c) {
    offset[c] = run;
    run += count[c];
  }
  if (t == kScanThreads - 1) offset[n_cells] = part[t];
  if (t == 0) *overflow = static_cast<unsigned char>(any_over);
}

__global__ void bin_scatter_kernel(int n_part, int n_cells,
                                   const int* __restrict__ cell_of,
                                   const int* __restrict__ rank_tmp,
                                   const int* __restrict__ offset,
                                   int* __restrict__ members) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_part || cell_of[i] >= n_cells) return;
  members[offset[cell_of[i]] + rank_tmp[i]] = i;
}

__global__ void bin_rank_kernel(const int* __restrict__ offset,
                                const int* __restrict__ members,
                                int k_cell, int* __restrict__ slot_of) {
  const int c = blockIdx.x;
  const int b = offset[c];
  const int cnt = offset[c + 1] - b;
  for (int p = threadIdx.x; p < cnt; p += blockDim.x) {
    const int me = members[b + p];
    int rank = 0;
    for (int q = 0; q < cnt; ++q) rank += members[b + q] < me;
    slot_of[me] = rank < k_cell ? rank : k_cell - 1;
  }
}

template <typename T>
int run_bin(const T* r, const unsigned char* discard, int n_part, int ndim,
            int n0, int n1, int n2, double lo0, double lo1, double lo2,
            double e0, double e1, double e2, int k_cell, int zrow_max,
            int* count, int* offset, int* rank_tmp, int* members,
            int* cell_of, int* slot_of, unsigned char* overflow, int device,
            void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ndim < 1 || ndim > 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Grid3 g = {{n0, n1, n2}, {0, 0, 0}, {0.0, 0.0, 0.0}, k_cell};
  const int n_cells = n0 * n1 * n2;
  err = cudaMemsetAsync(count, 0, sizeof(int) * n_cells, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const int blocks = (n_part + threads - 1) / threads;
  if (n_part > 0)
    bin_count_kernel<T><<<blocks, threads, 0, stream>>>(
        r, n_part, ndim, g, T(lo0), T(lo1), T(lo2), T(e0), T(e1), T(e2),
        zrow_max, discard, count, rank_tmp, cell_of, slot_of);
  bin_scan_kernel<<<1, kScanThreads, 0, stream>>>(count, n_cells, k_cell,
                                                  offset, overflow);
  if (n_part > 0)
    bin_scatter_kernel<<<blocks, threads, 0, stream>>>(
        n_part, n_cells, cell_of, rank_tmp, offset, members);
  bin_rank_kernel<<<n_cells, 64, 0, stream>>>(offset, members, k_cell,
                                              slot_of);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* grid27_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#define GRID27_BIN_ENTRY(NAME, T)                                           \
  int NAME(const T* r, const unsigned char* discard, int n_part, int ndim,  \
           int n0, int n1, int n2, double lo0, double lo1, double lo2,      \
           double e0, double e1, double e2, int k_cell, int zrow_max,       \
           int* count, int* offset, int* rank_tmp, int* members,            \
           int* cell_of, int* slot_of, unsigned char* overflow, int device, \
           void* stream) {                                                  \
    return run_bin<T>(r, discard, n_part, ndim, n0, n1, n2, lo0, lo1, lo2,  \
                      e0, e1, e2, k_cell, zrow_max, count, offset,          \
                      rank_tmp, members, cell_of, slot_of, overflow,        \
                      device, stream);                                      \
  }

GRID27_BIN_ENTRY(grid27_bin_f32, float)
GRID27_BIN_ENTRY(grid27_bin_f64, double)

}  // extern "C"
