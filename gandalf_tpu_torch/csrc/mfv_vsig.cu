// K32 mfv_vsig_near and K33 mfv_vsig_far: the two halves of the
// conservative timestep limiter's distant signal-velocity bound
// (time_step_limiter = conservative), in 1, 2 or 3 dims.
//
// K32 replaces gandalf_tpu/ops/mfv_grid27.py:vsig_near_grid27 (:485-531):
// for each particle, the largest (c_i + c_j - dv.dr/|dr|) h_i /
// max(|dr|, h_i) over every particle of the 3^ndim cells around its own
// (no support cut: the leaf branch of the reference's walk,
// Tree.cpp:993-1023), 0 where there is none.  There each shifted slice
// of a ghosted (cells, K) table is broadcast to a (cells*K, K) block.
// Bound on the card: the candidate loop of K2 (every slot of the
// stencil, each reading r, v and c: 2 NDIM + 1 values) with some 10 + 6
// NDIM operations a candidate; there is no support test to skip any.
// Design: K22's layout, one thread per slot of K1's slot map, flat over
// (cell, slot); the thread keeps its particle's row and the running
// maximum in registers and ends each cell's sweep at its first empty
// slot; each output is written once.
//
// K33 replaces vsig_cell_aggregates (:534-551) and vsig_far_from_agg
// (:566-609): per cell the largest sound speed (0 if none), occupancy
// and the per-dim velocity extrema; then for each target cell A = max
// 1/r_min and Bc = max (c_max - dvdr)/r_min over the occupied cells
// outside its stencil, r_min the gap between the two cells' boxes and
// dvdr the approach bound between their facing edges (Tree.cpp:944-975),
// or A = 0, Bc = -1e30 where there are none.  There the cell pairs are
// materialised as (C, C, ndim) arrays.  Bound on the card: operations,
// about C x C_occupied pairs of some 10 + 12 NDIM operations (2.9e9
// pairs at C = 54,000 for the 2D KHI at 524,288 particles); the
// aggregates are read from shared memory.  Design: three launches.  The
// first takes one thread per cell over its slots and writes a (C, 2 + 3
// NDIM) table: the cell's centre (computed in double and rounded to T,
// as the JAX package casts its numpy centres), c_max, occupancy, v_max,
// v_min.  The second takes one thread per target cell and one of S equal
// slices of the source cells (blockIdx.y; S chosen by the wrapper so that
// 16 blocks of 128 per SM fill the card: one thread per target alone
// left 421 blocks at the KHI, a fifth of the threads an SM holds, and
// took 23.5 ms where the slices take 13.4, PERF.md); its
// block stages tiles of 128 source rows of that table in shared memory
// (as K14 stages stars) and every thread sweeps each tile from
// registers, writing its slice's maxima to an (S, C) scratch.  The third
// takes each target's maxima over the S slices: a max in any order, so
// the result does not depend on S.  Nothing of (C, C) size is stored.
// The periodic wrap rounds half to even (rint), as jnp.round does: with
// an even cell count, cells half a box apart are a tie, which decides
// the sign of dr as there, and that sign picks the edge velocities and
// the sign of the gap.  The wrap and the gaps are formed with rounded
// products (no contraction into an FMA) so that the near test and the
// tie take the plain version's decisions; a pair inside the stencil or
// with an empty source is skipped before anything is divided.
#include <cuda_runtime.h>

#include "grid27.cuh"
#include "tree.cuh"

namespace {

using tree::add_rn;
using tree::mul_rn;
using tree::sub_rn;

constexpr int kThreads = 128;
constexpr int kTile = 128;

template <typename T, int NDIM>
__global__ void __launch_bounds__(kThreads) vsig_near_kernel(
    const int* __restrict__ ids, const T* __restrict__ r,
    const T* __restrict__ v, const T* __restrict__ sound,
    const T* __restrict__ h, Grid3 g, int n_cells, T* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const int K = g.K;
  if (t >= static_cast<long long>(n_cells) * K) return;
  const int p = ids[t];
  if (p < 0) return;
  int cc[3];
  cell_coords(g, static_cast<int>(t / K), cc);
  T xi[NDIM], vi[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    xi[k] = r[NDIM * static_cast<long long>(p) + k];
    vi[k] = v[NDIM * static_cast<long long>(p) + k];
  }
  const T c_i = sound[p], h_i = h[p];
  T best = T(0);
  for (int d = 0; d < Stencil<NDIM>::kSize; ++d) {
    int nc;
    T sh[3];
    if (!neighbour_cell<T, NDIM>(g, cc, d, &nc, sh)) continue;
    const int* slots = ids + static_cast<long long>(nc) * K;
    for (int j = 0; j < K; ++j) {
      const int q = slots[j];
      if (q < 0) break;
      T dr[NDIM];
      T d2 = T(0);
#pragma unroll
      for (int k = 0; k < NDIM; ++k) {
        dr[k] = (r[NDIM * static_cast<long long>(q) + k] + sh[k]) - xi[k];
        d2 += dr[k] * dr[k];
      }
      if (!(d2 > T(0))) continue;
      const T drmag = sqrt(d2);
      T dvdr = T(0);
#pragma unroll
      for (int k = 0; k < NDIM; ++k)
        dvdr += (vi[k] - v[NDIM * static_cast<long long>(q) + k]) * dr[k];
      dvdr = dvdr / drmag;
      const T vs = c_i + sound[q] - dvdr;
      const T c = vs * (h_i / max(drmag, h_i));
      best = c > best ? c : best;
    }
  }
  out[p] = best;
}

// the aggregate table's columns: centre, c_max, occupancy, v_max, v_min
template <int NDIM>
struct Agg {
  static constexpr int kCen = 0, kC = NDIM, kOcc = NDIM + 1;
  static constexpr int kVmax = NDIM + 2, kVmin = 2 * NDIM + 2;
  static constexpr int kCount = 3 * NDIM + 2;
};

struct FarGeom {
  double lo[3], csize[3], reach[3], ext[3];
};

template <typename T, int NDIM>
__global__ void __launch_bounds__(kThreads) vsig_agg_kernel(
    const int* __restrict__ ids, const T* __restrict__ v,
    const T* __restrict__ sound, Grid3 g, FarGeom geo, int n_cells,
    T* __restrict__ agg) {
  using A = Agg<NDIM>;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_cells) return;
  int cc[3];
  cell_coords(g, c, cc);
  T cmax = T(-1e30), vmax[NDIM], vmin[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    vmax[k] = T(-1e30);
    vmin[k] = T(1e30);
  }
  bool occ = false;
  const int* slots = ids + static_cast<long long>(c) * g.K;
  for (int j = 0; j < g.K; ++j) {
    const int q = slots[j];
    if (q < 0) break;
    occ = true;
    cmax = max(cmax, sound[q]);
#pragma unroll
    for (int k = 0; k < NDIM; ++k) {
      const T vk = v[NDIM * static_cast<long long>(q) + k];
      vmax[k] = max(vmax[k], vk);
      vmin[k] = min(vmin[k], vk);
    }
  }
  T* row = agg + static_cast<long long>(A::kCount) * c;
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    row[A::kCen + k] =
        T(add_rn(geo.lo[k], mul_rn(cc[k] + 0.5, geo.csize[k])));
    row[A::kVmax + k] = vmax[k];
    row[A::kVmin + k] = vmin[k];
  }
  row[A::kC] = max(cmax, T(0));
  row[A::kOcc] = occ ? T(1) : T(0);
}

template <typename T, int NDIM>
__global__ void __launch_bounds__(kThreads) vsig_far_kernel(
    const T* __restrict__ agg, Grid3 g, FarGeom geo, int n_cells,
    int per_slice, T* __restrict__ A_part, T* __restrict__ B_part) {
  using A = Agg<NDIM>;
  __shared__ T tile[kTile * A::kCount];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = c < n_cells;
  const int lo = blockIdx.y * per_slice;
  const int hi = min(n_cells, lo + per_slice);
  T ci[NDIM], vmax_i[NDIM], vmin_i[NDIM], csize[NDIM], reach[NDIM],
      ext[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    const T* row = agg + static_cast<long long>(A::kCount) * (live ? c : 0);
    ci[k] = row[A::kCen + k];
    vmax_i[k] = row[A::kVmax + k];
    vmin_i[k] = row[A::kVmin + k];
    csize[k] = T(geo.csize[k]);
    reach[k] = T(geo.reach[k]);
    ext[k] = T(geo.ext[k]);
  }
  T a_best = T(0), b_best = T(-1e30);
  for (int base = lo; base < hi; base += kTile) {
    const int n_tile = min(kTile, hi - base);
    __syncthreads();
    for (int e = threadIdx.x; e < n_tile * A::kCount; e += blockDim.x)
      tile[e] = agg[static_cast<long long>(A::kCount) * base + e];
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n_tile; ++j) {
      const T* src = tile + A::kCount * j;
      if (!(src[A::kOcc] > T(0.5))) continue;
      T dr[NDIM], gap[NDIM];
      bool near = true;
#pragma unroll
      for (int k = 0; k < NDIM; ++k) {
        T x = src[A::kCen + k] - ci[k];
        if (g.periodic[k]) x = sub_rn(x, mul_rn(ext[k], rint(x / ext[k])));
        dr[k] = x;
        const T ax = fabs(x);
        gap[k] = max(sub_rn(ax, csize[k]), T(0));
        near = near && ax <= reach[k];
      }
      if (near) continue;
      T g2 = mul_rn(gap[0], gap[0]);
#pragma unroll
      for (int k = 1; k < NDIM; ++k) g2 = g2 + mul_rn(gap[k], gap[k]);
      const T rmin = sqrt(g2);
      T dvdr = T(0);
#pragma unroll
      for (int k = 0; k < NDIM; ++k) {
        const bool pos = dr[k] > T(0);
        const T edge = pos ? src[A::kVmin + k] - vmax_i[k]
                           : src[A::kVmax + k] - vmin_i[k];
        dvdr += (pos ? gap[k] : -gap[k]) * edge;
      }
      dvdr = dvdr / rmin;
      a_best = max(a_best, T(1) / rmin);
      b_best = max(b_best, (src[A::kC] - dvdr) / rmin);
    }
  }
  if (live) {
    const long long o = static_cast<long long>(blockIdx.y) * n_cells + c;
    A_part[o] = a_best;
    B_part[o] = b_best;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) vsig_far_reduce(
    const T* __restrict__ A_part, const T* __restrict__ B_part, int n_cells,
    int slices, T* __restrict__ A_out, T* __restrict__ B_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_cells) return;
  T a = A_part[c], b = B_part[c];
  for (int k = 1; k < slices; ++k) {
    const long long o = static_cast<long long>(k) * n_cells + c;
    a = max(a, A_part[o]);
    b = max(b, B_part[o]);
  }
  A_out[c] = a;
  B_out[c] = b;
}

template <typename T, int NDIM>
void launch_near(const int* ids, const T* r, const T* v, const T* sound,
                 const T* h, const Grid3& g, int n_cells, T* out,
                 cudaStream_t stream) {
  const long long slots = static_cast<long long>(n_cells) * g.K;
  vsig_near_kernel<T, NDIM>
      <<<static_cast<int>((slots + kThreads - 1) / kThreads), kThreads, 0,
         stream>>>(ids, r, v, sound, h, g, n_cells, out);
}

template <typename T, int NDIM>
void launch_far(const int* ids, const T* v, const T* sound, const Grid3& g,
                const FarGeom& geo, int n_cells, int slices, T* agg,
                T* part, T* A, T* B, cudaStream_t stream) {
  const int blocks = (n_cells + kThreads - 1) / kThreads;
  const int per_slice = (n_cells + slices - 1) / slices;
  T* A_part = part;
  T* B_part = part + static_cast<long long>(slices) * n_cells;
  vsig_agg_kernel<T, NDIM><<<blocks, kThreads, 0, stream>>>(
      ids, v, sound, g, geo, n_cells, agg);
  vsig_far_kernel<T, NDIM><<<dim3(blocks, slices), kThreads, 0, stream>>>(
      agg, g, geo, n_cells, per_slice, A_part, B_part);
  vsig_far_reduce<T><<<blocks, kThreads, 0, stream>>>(
      A_part, B_part, n_cells, slices, A, B);
}

Grid3 make_grid(int n0, int n1, int n2, int k_cell, int per0, int per1,
                int per2, double L0, double L1, double L2) {
  return Grid3{{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell};
}

template <typename T>
int run_near(const int* ids, const T* r, const T* v, const T* sound,
             const T* h, int ndim, int n0, int n1, int n2, int k_cell,
             int per0, int per1, int per2, double L0, double L1, double L2,
             T* out, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ndim < 1 || ndim > 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Grid3 g = make_grid(n0, n1, n2, k_cell, per0, per1, per2, L0, L1,
                            L2);
  const int n_cells = n0 * n1 * n2;
  if (n_cells > 0 && k_cell > 0) {
    if (ndim == 3)
      launch_near<T, 3>(ids, r, v, sound, h, g, n_cells, out, stream);
    else if (ndim == 2)
      launch_near<T, 2>(ids, r, v, sound, h, g, n_cells, out, stream);
    else
      launch_near<T, 1>(ids, r, v, sound, h, g, n_cells, out, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_far(const int* ids, const T* v, const T* sound, int ndim, int n0,
            int n1, int n2, int k_cell, int per0, int per1, int per2,
            double L0, double L1, double L2, const double* lo,
            const double* csize, const double* reach, int slices, T* agg,
            T* part, T* A, T* B, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ndim < 1 || ndim > 3 || slices < 1 || slices > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Grid3 g = make_grid(n0, n1, n2, k_cell, per0, per1, per2, L0, L1,
                            L2);
  FarGeom geo;
  for (int k = 0; k < 3; ++k) {
    geo.lo[k] = k < ndim ? lo[k] : 0.0;
    geo.csize[k] = k < ndim ? csize[k] : 0.0;
    geo.reach[k] = k < ndim ? reach[k] : 0.0;
    geo.ext[k] = g.L[k];
  }
  const int n_cells = n0 * n1 * n2;
  if (n_cells > 0 && k_cell > 0) {
    if (ndim == 3)
      launch_far<T, 3>(ids, v, sound, g, geo, n_cells, slices, agg, part, A,
                       B, stream);
    else if (ndim == 2)
      launch_far<T, 2>(ids, v, sound, g, geo, n_cells, slices, agg, part, A,
                       B, stream);
    else
      launch_far<T, 1>(ids, v, sound, g, geo, n_cells, slices, agg, part, A,
                       B, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define VSIG_NEAR_ENTRY(NAME, T)                                              \
  int NAME(const int* ids, const T* r, const T* v, const T* sound,            \
           const T* h, int ndim, int n0, int n1, int n2, int k_cell,          \
           int per0, int per1, int per2, double L0, double L1, double L2,     \
           T* out, int device, void* stream) {                                \
    return run_near<T>(ids, r, v, sound, h, ndim, n0, n1, n2, k_cell, per0,   \
                       per1, per2, L0, L1, L2, out, device, stream);          \
  }

#define VSIG_FAR_ENTRY(NAME, T)                                               \
  int NAME(const int* ids, const T* v, const T* sound, int ndim, int n0,      \
           int n1, int n2, int k_cell, int per0, int per1, int per2,          \
           double L0, double L1, double L2, double lo0, double lo1,           \
           double lo2, double cs0, double cs1, double cs2, double re0,        \
           double re1, double re2, int slices, T* agg, T* part, T* A,         \
           T* B, int device, void* stream) {                                  \
    const double lo[3] = {lo0, lo1, lo2}, cs[3] = {cs0, cs1, cs2},            \
                 re[3] = {re0, re1, re2};                                     \
    return run_far<T>(ids, v, sound, ndim, n0, n1, n2, k_cell, per0, per1,    \
                      per2, L0, L1, L2, lo, cs, re, slices, agg, part, A, B,  \
                      device, stream);                                        \
  }

VSIG_NEAR_ENTRY(mfv_vsig_near_f32, float)
VSIG_NEAR_ENTRY(mfv_vsig_near_f64, double)
VSIG_FAR_ENTRY(mfv_vsig_far_f32, float)
VSIG_FAR_ENTRY(mfv_vsig_far_f64, double)

}  // extern "C"
