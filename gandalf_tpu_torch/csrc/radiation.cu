// K34 cell_field, K35 ray_march, K36 packet_march and K37
// stromgren_prefix: the radiation schemes' hot loops, in 1-3 dims (K34
// works on flat cells; K35, K36 and K37's distance kernel are templates
// on NDIM: with the grid's dims a run-time loop bound K35 and K36 ran
// slower in 3D and 2D, python -m gandalf_tpu_torch.time_radiation_nd).
//
// K34 replaces gandalf_tpu/ops/treeray.py:cell_field (:104): per cell
//   rho_c = sum_slots w_p rho_p / V_cell,
//   nh2_c = sum_slots w_p (rho_p / mu_bar)^2 / V_cell,  w = m / max(rho,
//   1e-30),
// over the cell's slots of K1's binning.  Bound: bytes (the slot map and
// two values a particle read, two values a cell written).  Design: two
// stages in one wrapper.  One thread a particle writes its index into
// its (cell, slot) of a slot map the wrapper fills with -1 (the
// discarded, cell C, write nothing); then one thread a cell sums its
// slots in slot order and stops at the first empty one (K1 fills a
// cell's slots from 0 up), so each cell's sum runs in the order of the
// JAX function's dense sum over the slot axis.
//
// K35 replaces gandalf_tpu/ops/treeray.py:_march (:123): the midpoint
// integral of a per-cell field along N x S rays, n_steps samples each,
//   out = (sum_k field[cell(r0 + (L t_k) dir)]) L / n_steps,
//   t_k = (k + 0.5) / n_steps,
// a sample outside the domain on an open dim reading 0, a periodic dim
// wrapped as lo + mod(x - lo, extent) (the remainder takes the extent's
// sign).  Bound: bytes at the path's shapes (the ray's inputs, the field
// through L2), operations for long rays.  Design: one thread a ray, its
// samples in registers.  Each sample position is formed as the JAX
// function forms it, in round-to-nearest steps the compiler may not
// contract (__fmul_rn, __fadd_rn): the Spitzer sphere is an exact lattice
// about its source, so samples fall on cell faces, and another
// association order would move them into the next cell.
//
// K36 replaces gandalf_tpu/ops/mcrt.py:propagate_packets (:83): the
// lockstep packet march.  Each step, at the midpoint pos + (ds/2) dir,
// tau = kappa rho ds, absorb = w (1 - exp(-tau)), the Lucy path w ds (or
// absorb / kappa rho where tau > 1e-12) and the absorbed weight scatter
// into the step's cell, and w loses absorb; a packet outside the domain
// gives its weight to the escaped sum and carries none after.  Bound:
// the steps' gathers and scatters (operations: one exp a step).
// Design: one thread a packet with its 256 steps in registers.  Its path
// and absorbed sums stay in registers while it stays in one cell and go
// out with one atomicAdd each when it leaves (ds is half a cell, so at
// least half the scatters go); a packet stops at its first step outside
// an open dim (it adds 0 to every later sum).  The escaped weight is
// summed per warp, one atomic a warp.  The per-cell and escaped sums
// accumulate in float64 whatever the type, then one pass casts them: all
// 2.1M packets of the Spitzer run start in the source's cell, and a
// float32 running sum of 2.1M atomics would drift by ~1e-4 of it.
// Atomics add in another order than the plain version, run to run.  The
// 1e-300 floors round to 0 in float32 as in the JAX package.
//
// K37 replaces gandalf_tpu/ops/ionisation.py:multi_source_ionisation
// (:67) and its first solve ionisation_fractions (:43): per source the
// particles in stable order of distance d (ties by index), the prefix
// whose cumulative weighted recombination sum stays <= Ndot is ionised;
// 1 + n_iter rounds, the weights w_ps = F_ps / sum_s F_ps with F_ps =
// Ndot_s / max(d^2, 1e-30) over the sources that reached p in the last
// round (1 where none did; 1 in the first round).  Bound: bytes (each
// round reads d and w rec a pass).  Design: a weighted radix select, no
// sort.  The order is that of the key (bits(d), p), as d >= 0; since
// w rec >= 0 the cumulative sum never falls along it, so the ionised set
// is every key below the first key whose cumulative sum passes Ndot.
// That key is found digit by digit, 8 bits a pass (4 or 8 passes over
// d's bits, then over the index's): a pass builds each block's 256-bin
// histogram of w rec over the keys that match the digits found so far
// (shared-memory atomics), and one block a source adds the blocks' bins
// in block order and walks the bins in order from the sum below the
// prefix until it passes Ndot.  Where rounding leaves no bin past Ndot
// (the sums run in another order than the sequential cumulative sum),
// every key of the prefix is ionised.  d is sqrt((dx^2 + dy^2) + dz^2)
// (dx^2 + dy^2 in 2D, dx^2 in 1D: the distance kernel is a template on
// NDIM, the rest reads only d) without fused multiply-adds, so the
// lattice's shells of equal d tie as in the JAX function.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kBins = 256;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ unsigned long long key_bits(float d) {
  return static_cast<unsigned long long>(__float_as_uint(d));
}
__device__ __forceinline__ unsigned long long key_bits(double d) {
  return static_cast<unsigned long long>(__double_as_longlong(d));
}

// the grid of a radiation field: cells per dim, lo, ncells / extent,
// extent and the periodic flags, padded to three dims
template <typename T>
struct Grid {
  int n[3];
  T lo[3], inv[3], ext[3];
  int periodic[3];
};

// the flat cell of position x (NDIM values), or -1 outside an open dim
template <typename T, int NDIM>
__device__ __forceinline__ long long cell_of(const Grid<T>& g, const T* x) {
  long long flat = 0;
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    T v = x[k];
    if (g.periodic[k]) {
      // lo + mod(v - lo, ext), the remainder with the extent's sign
      T rem = fmod(sub_rn(v, g.lo[k]), g.ext[k]);
      if (rem != T(0) && ((rem < T(0)) != (g.ext[k] < T(0))))
        rem = add_rn(rem, g.ext[k]);
      v = add_rn(g.lo[k], rem);
    }
    const int ix = static_cast<int>(floor(mul_rn(sub_rn(v, g.lo[k]),
                                                 g.inv[k])));
    if (ix < 0 || ix >= g.n[k]) return -1;
    flat = flat * g.n[k] + ix;
  }
  return flat;
}

// --- K34 ------------------------------------------------------------------

__global__ void slot_map_kernel(const int* __restrict__ cell,
                                const int* __restrict__ slot, int n,
                                int n_cells, int k_cell,
                                int* __restrict__ ids) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = cell[i];
  if (c < 0 || c >= n_cells) return;
  ids[static_cast<long long>(c) * k_cell + slot[i]] = i;
}

template <typename T>
__global__ void cell_sum_kernel(const int* __restrict__ ids, int n_cells,
                                int k_cell, const T* __restrict__ m,
                                const T* __restrict__ rho, T mu_bar,
                                T vol, T* __restrict__ rho_c,
                                T* __restrict__ nh2_c) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_cells) return;
  const int* row = ids + static_cast<long long>(c) * k_cell;
  T srho = T(0), snh2 = T(0);
  for (int s = 0; s < k_cell; ++s) {
    const int p = row[s];
    if (p < 0) break;
    const T r = rho[p];
    const T w = m[p] / fmax(r, T(1e-30));
    const T nh = r / mu_bar;
    srho = add_rn(srho, mul_rn(w, r));
    snh2 = add_rn(snh2, mul_rn(w, mul_rn(nh, nh)));
  }
  rho_c[c] = srho / vol;
  nh2_c[c] = snh2 / vol;
}

// --- K35 ------------------------------------------------------------------

template <typename T, int NDIM>
__global__ void ray_march_kernel(Grid<T> g, const T* __restrict__ field,
                                 const T* __restrict__ r0,
                                 const T* __restrict__ dirs,
                                 int dirs_shared,
                                 const T* __restrict__ len, int n, int s,
                                 int n_steps, T* __restrict__ out) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (q >= static_cast<long long>(n) * s) return;
  const long long i = q / s;
  constexpr int nd = NDIM;
  const T* dir = dirs + (dirs_shared ? (q % s) * nd : q * nd);
  T x0[3], dv[3];
  for (int k = 0; k < nd; ++k) {
    x0[k] = r0[i * nd + k];
    dv[k] = dir[k];
  }
  const T L = len[q];
  const T fn = static_cast<T>(n_steps);
  T acc = T(0);
  for (int k = 0; k < n_steps; ++k) {
    const T t = add_rn(static_cast<T>(k), T(0.5)) / fn;
    const T lt = mul_rn(L, t);
    T x[3];
    for (int d = 0; d < nd; ++d) x[d] = add_rn(x0[d], mul_rn(lt, dv[d]));
    const long long c = cell_of<T, NDIM>(g, x);
    if (c >= 0) acc = add_rn(acc, field[c]);
  }
  out[q] = mul_rn(acc, L) / fn;
}

// --- K36 ------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void flush(double* path, double* absorbed,
                                      long long c, T p, T a) {
  if (c >= 0) {
    atomicAdd(path + c, static_cast<double>(p));
    atomicAdd(absorbed + c, static_cast<double>(a));
  }
}

template <typename T, int NDIM>
__global__ void packet_march_kernel(Grid<T> g, const T* __restrict__ op,
                                    const T* __restrict__ r0,
                                    const T* __restrict__ dirs, int n,
                                    int n_steps, T ds, T half_ds,
                                    double* __restrict__ path,
                                    double* __restrict__ absorbed,
                                    double* __restrict__ escaped) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  T esc = T(0);
  if (i < n) {
    constexpr int nd = NDIM;
    T pos[3], dv[3];
    for (int k = 0; k < nd; ++k) {
      pos[k] = r0[static_cast<long long>(i) * nd + k];
      dv[k] = dirs[static_cast<long long>(i) * nd + k];
    }
    T w = T(1);
    long long cur = -1;
    T pacc = T(0), aacc = T(0);
    for (int step = 0; step < n_steps; ++step) {
      T mid[3];
      for (int k = 0; k < nd; ++k)
        mid[k] = add_rn(pos[k], mul_rn(half_ds, dv[k]));
      const long long c = cell_of<T, NDIM>(g, mid);
      if (c < 0) break;  // w goes to the escaped sum
      if (c != cur) {
        flush(path, absorbed, cur, pacc, aacc);
        cur = c;
        pacc = T(0);
        aacc = T(0);
      }
      const T kap = op[c];
      const T tau = mul_rn(kap, ds);
      const T ab = mul_rn(w, T(1) - exp(-tau));
      const T wp = tau > T(1e-12) ? ab / fmax(kap, T(1e-300))
                                  : mul_rn(w, ds);
      pacc = add_rn(pacc, wp);
      aacc = add_rn(aacc, ab);
      w = sub_rn(w, ab);
      for (int k = 0; k < nd; ++k)
        pos[k] = add_rn(pos[k], mul_rn(ds, dv[k]));
    }
    flush(path, absorbed, cur, pacc, aacc);
    esc = w;
  }
  double e = static_cast<double>(esc);
  for (int off = 16; off > 0; off >>= 1)
    e += __shfl_down_sync(0xffffffffu, e, off);
  if ((threadIdx.x & 31) == 0 && e != 0.0) atomicAdd(escaped, e);
}

// the float64 sums into the outputs' type: n cells of path and absorbed,
// then the escaped weight
template <typename T>
__global__ void packet_cast_kernel(const double* __restrict__ acc, int n,
                                   T* __restrict__ path,
                                   T* __restrict__ absorbed,
                                   T* __restrict__ escaped) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < n) {
    path[c] = static_cast<T>(acc[c]);
    absorbed[c] = static_cast<T>(acc[n + c]);
  }
  if (c == 0) escaped[0] = static_cast<T>(acc[2 * n]);
}

// --- K37 ------------------------------------------------------------------

// a source's search: the digits found so far (mask, prefix) over the key
// (hi = bits(d), lo = index), the sum below the prefix, and once done the
// threshold: reached = masked key < prefix, or <= with incl
struct SrcState {
  unsigned long long mhi, phi;
  unsigned int mlo, plo;
  double base;
  int done, incl;
};
static_assert(sizeof(SrcState) == 40, "SrcState is five int64 words");

__device__ __forceinline__ bool reached(const SrcState& st,
                                        unsigned long long hi,
                                        unsigned int lo) {
  const unsigned long long a = hi & st.mhi;
  const unsigned int b = lo & st.mlo;
  if (a != st.phi) return a < st.phi;
  if (b != st.plo) return b < st.plo;
  return st.incl != 0;
}

template <typename T, int NDIM>
__global__ void src_dist_kernel(const T* __restrict__ r, int n,
                                const T* __restrict__ rs, int ns,
                                T* __restrict__ d) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  T x[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) x[k] = r[static_cast<long long>(NDIM) * p + k];
  for (int s = 0; s < ns; ++s) {
    // the squares summed in axis order
    const T d0 = sub_rn(x[0], rs[NDIM * s]);
    T d2 = mul_rn(d0, d0);
#pragma unroll
    for (int k = 1; k < NDIM; ++k) {
      const T dk = sub_rn(x[k], rs[NDIM * s + k]);
      d2 = add_rn(d2, mul_rn(dk, dk));
    }
    d[static_cast<long long>(s) * n + p] = sqrt(d2);
  }
}

// w rec per (source, particle): the flux weights of the last round's
// reach sets (1 in the first round)
template <typename T>
__global__ void weights_kernel(const T* __restrict__ d,
                               const T* __restrict__ rec, int n, int ns,
                               const T* __restrict__ ndot,
                               const SrcState* __restrict__ st, int first,
                               T* __restrict__ wrec) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const T rp = rec[p];
  if (first) {
    for (int s = 0; s < ns; ++s) wrec[static_cast<long long>(s) * n + p] = rp;
    return;
  }
  T tot = T(0);
  for (int s = 0; s < ns; ++s) {
    const T ds = d[static_cast<long long>(s) * n + p];
    if (reached(st[s], key_bits(ds), static_cast<unsigned int>(p)))
      tot = add_rn(tot, ndot[s] / fmax(mul_rn(ds, ds), T(1e-30)));
  }
  for (int s = 0; s < ns; ++s) {
    const T ds = d[static_cast<long long>(s) * n + p];
    T w = T(1);
    if (tot > T(0)) {
      const T f = reached(st[s], key_bits(ds), static_cast<unsigned int>(p))
                      ? ndot[s] / fmax(mul_rn(ds, ds), T(1e-30))
                      : T(0);
      w = f / fmax(tot, T(1e-300));
    }
    wrec[static_cast<long long>(s) * n + p] = mul_rn(w, rp);
  }
}

__device__ __forceinline__ int digit_of(unsigned long long hi,
                                        unsigned int lo, int t, int nhi,
                                        int nlo) {
  if (t < nhi) return static_cast<int>((hi >> (8 * (nhi - 1 - t))) & 255);
  return static_cast<int>((lo >> (8 * (nlo - 1 - (t - nhi)))) & 255);
}

// pass t: each block's histogram of w rec over the keys matching the
// prefix of its source (blockIdx.y)
template <typename T>
__global__ void __launch_bounds__(kBlock) hist_kernel(
    const T* __restrict__ d, const T* __restrict__ wrec, int n, int chunk,
    const unsigned char* __restrict__ on, const SrcState* __restrict__ st,
    int t, int nhi, int nlo, T* __restrict__ partial) {
  __shared__ T h[kBins];
  const int s = blockIdx.y;
  h[threadIdx.x] = T(0);
  __syncthreads();
  const SrcState cur = st[s];
  const bool live = on[s] && (t == 0 || !cur.done);
  if (live) {
    const int a = blockIdx.x * chunk;
    const int b = min(n, a + chunk);
    const long long row = static_cast<long long>(s) * n;
    for (int p = a + threadIdx.x; p < b; p += kBlock) {
      const unsigned long long hi = key_bits(d[row + p]);
      const unsigned int lo = static_cast<unsigned int>(p);
      if (t > 0 && ((hi & cur.mhi) != cur.phi || (lo & cur.mlo) != cur.plo))
        continue;
      atomicAdd(&h[digit_of(hi, lo, t, nhi, nlo)], wrec[row + p]);
    }
  }
  __syncthreads();
  partial[(static_cast<long long>(s) * gridDim.x + blockIdx.x) * kBins
          + threadIdx.x] = h[threadIdx.x];
}

// pass t: one block a source adds the blocks' bins in block order, then
// one thread walks the bins from the sum below the prefix
template <typename T>
__global__ void __launch_bounds__(kBins) select_kernel(
    const T* __restrict__ partial, int n_blocks,
    const unsigned char* __restrict__ on, const T* __restrict__ ndot,
    SrcState* __restrict__ st, int t, int nhi, int nlo) {
  __shared__ T h[kBins];
  const int s = blockIdx.x;
  SrcState& me = st[s];
  if (!on[s]) {
    if (threadIdx.x == 0) {
      me.mhi = me.phi = 0;
      me.mlo = me.plo = 0;
      me.base = 0.0;
      me.done = 1;
      me.incl = 0;
    }
    return;
  }
  if (t > 0 && me.done) return;
  T acc = T(0);
  const T* col = partial + static_cast<long long>(s) * n_blocks * kBins
                 + threadIdx.x;
  for (int b = 0; b < n_blocks; ++b) acc = add_rn(acc, col[b * kBins]);
  h[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x != 0) return;
  if (t == 0) {
    me.mhi = me.phi = 0;
    me.mlo = me.plo = 0;
    me.base = 0.0;
    me.done = 0;
    me.incl = 0;
  }
  const T limit = ndot[s];
  T e = static_cast<T>(me.base);
  int sel = -1;
  for (int b = 0; b < kBins; ++b) {
    const T next = add_rn(e, h[b]);
    if (next > limit) {
      sel = b;
      break;
    }
    e = next;
  }
  if (sel < 0) {
    // no bin passes Ndot: every key of the prefix (every key at t = 0)
    // is ionised
    me.done = 1;
    me.incl = 1;
    return;
  }
  me.base = static_cast<double>(e);
  if (t < nhi) {
    const int sh = 8 * (nhi - 1 - t);
    me.phi |= static_cast<unsigned long long>(sel) << sh;
    me.mhi |= 255ULL << sh;
  } else {
    const int sh = 8 * (nlo - 1 - (t - nhi));
    me.plo |= static_cast<unsigned int>(sel) << sh;
    me.mlo |= 255u << sh;
  }
  if (t == nhi + nlo - 1) {
    // the first key past Ndot: the ionised keys are those below it
    me.done = 1;
    me.incl = 0;
  }
}

template <typename T>
__global__ void any_reach_kernel(const T* __restrict__ d, int n, int ns,
                                 const SrcState* __restrict__ st,
                                 unsigned char* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  unsigned char hit = 0;
  for (int s = 0; s < ns; ++s)
    hit |= reached(st[s], key_bits(d[static_cast<long long>(s) * n + p]),
                   static_cast<unsigned int>(p))
               ? 1
               : 0;
  out[p] = hit;
}

template <typename T>
Grid<T> make_grid(int nd, const int* n, const double* lo, const double* ext,
                  const int* periodic) {
  Grid<T> g;
  for (int k = 0; k < 3; ++k) {
    g.n[k] = n[k];
    g.lo[k] = static_cast<T>(lo[k]);
    g.ext[k] = static_cast<T>(ext[k]);
    g.inv[k] = static_cast<T>(k < nd ? n[k] / ext[k] : 0.0);
    g.periodic[k] = periodic[k];
  }
  return g;
}

int blocks_for(long long n) {
  return static_cast<int>((n + kBlock - 1) / kBlock);
}

// K35 and K36 with NDIM the grid's dims (1-3)
template <typename T, int NDIM>
void ray_march_launch(const Grid<T>& g, const T* field, const T* r0,
                      const T* dirs, int dirs_shared, const T* len, int n,
                      int s, int n_steps, T* out, cudaStream_t st) {
  ray_march_kernel<T, NDIM><<<blocks_for(static_cast<long long>(n) * s),
                              kBlock, 0, st>>>(g, field, r0, dirs,
                                               dirs_shared, len, n, s,
                                               n_steps, out);
}

template <typename T, int NDIM>
void packet_march_launch(const Grid<T>& g, const T* op, const T* r0,
                         const T* dirs, int n, int n_steps, T ds,
                         T half_ds, double* acc, int cells,
                         cudaStream_t st) {
  packet_march_kernel<T, NDIM><<<blocks_for(n), kBlock, 0, st>>>(
      g, op, r0, dirs, n, n_steps, ds, half_ds, acc, acc + cells,
      acc + 2 * cells);
}

template <typename T>
void ray_march_nd(int nd, const Grid<T>& g, const T* field, const T* r0,
                  const T* dirs, int dirs_shared, const T* len, int n, int s,
                  int n_steps, T* out, cudaStream_t st) {
  if (nd == 3)
    ray_march_launch<T, 3>(g, field, r0, dirs, dirs_shared, len, n, s,
                           n_steps, out, st);
  else if (nd == 2)
    ray_march_launch<T, 2>(g, field, r0, dirs, dirs_shared, len, n, s,
                           n_steps, out, st);
  else
    ray_march_launch<T, 1>(g, field, r0, dirs, dirs_shared, len, n, s,
                           n_steps, out, st);
}

template <typename T>
void packet_march_nd(int nd, const Grid<T>& g, const T* op, const T* r0,
                     const T* dirs, int n, int n_steps, T ds, T half_ds,
                     double* acc, int cells, cudaStream_t st) {
  if (nd == 3)
    packet_march_launch<T, 3>(g, op, r0, dirs, n, n_steps, ds, half_ds, acc,
                              cells, st);
  else if (nd == 2)
    packet_march_launch<T, 2>(g, op, r0, dirs, n, n_steps, ds, half_ds, acc,
                              cells, st);
  else
    packet_march_launch<T, 1>(g, op, r0, dirs, n, n_steps, ds, half_ds, acc,
                              cells, st);
}

}  // namespace

extern "C" {

#define RADIATION_ENTRIES(SFX, T)                                            \
  int cell_field_##SFX(const int* cell, const int* slot, int n, int n_cells, \
                       int k_cell, int* ids, const T* m, const T* rho,       \
                       double mu_bar, double vol, T* rho_c, T* nh2_c,        \
                       int device, void* stream) {                           \
    cudaError_t err = cudaSetDevice(device);                                 \
    if (err != cudaSuccess) return static_cast<int>(err);                    \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                     \
    if (n > 0)                                                               \
      slot_map_kernel<<<blocks_for(n), kBlock, 0, st>>>(cell, slot, n,       \
                                                        n_cells, k_cell,    \
                                                        ids);               \
    err = cudaGetLastError();                                                \
    if (err != cudaSuccess) return static_cast<int>(err);                    \
    if (n_cells > 0)                                                         \
      cell_sum_kernel<T><<<blocks_for(n_cells), kBlock, 0, st>>>(            \
          ids, n_cells, k_cell, m, rho, static_cast<T>(mu_bar),             \
          static_cast<T>(vol), rho_c, nh2_c);                               \
    return static_cast<int>(cudaGetLastError());                             \
  }                                                                          \
  int ray_march_##SFX(int nd, int n0, int n1, int n2, double lo0,            \
                      double lo1, double lo2, double e0, double e1,          \
                      double e2, int p0, int p1, int p2, const T* field,     \
                      const T* r0, const T* dirs, int dirs_shared,           \
                      const T* len, int n, int s, int n_steps, T* out,       \
                      int device, void* stream) {                            \
    cudaError_t err = cudaSetDevice(device);                                 \
    if (err != cudaSuccess) return static_cast<int>(err);                    \
    if (nd < 1 || nd > 3) return static_cast<int>(cudaErrorInvalidValue);    \
    const int nc[3] = {n0, n1, n2}, per[3] = {p0, p1, p2};                   \
    const double lo[3] = {lo0, lo1, lo2}, ext[3] = {e0, e1, e2};             \
    const long long rays = static_cast<long long>(n) * s;                    \
    if (rays > 0)                                                            \
      ray_march_nd<T>(nd, make_grid<T>(nd, nc, lo, ext, per), field, r0,     \
                      dirs, dirs_shared, len, n, s, n_steps, out,            \
                      static_cast<cudaStream_t>(stream));                    \
    return static_cast<int>(cudaGetLastError());                             \
  }                                                                          \
  int packet_march_##SFX(int nd, int n0, int n1, int n2, double lo0,         \
                         double lo1, double lo2, double e0, double e1,       \
                         double e2, int p0, int p1, int p2, const T* op,     \
                         const T* r0, const T* dirs, int n, int n_steps,     \
                         double ds, double* acc, T* path, T* absorbed,       \
                         T* escaped, int device, void* stream) {             \
    cudaError_t err = cudaSetDevice(device);                                 \
    if (err != cudaSuccess) return static_cast<int>(err);                    \
    if (nd < 1 || nd > 3) return static_cast<int>(cudaErrorInvalidValue);    \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                     \
    const int nc[3] = {n0, n1, n2}, per[3] = {p0, p1, p2};                   \
    const double lo[3] = {lo0, lo1, lo2}, ext[3] = {e0, e1, e2};             \
    const int cells = n0 * n1 * n2;                                          \
    if (n > 0)                                                               \
      packet_march_nd<T>(nd, make_grid<T>(nd, nc, lo, ext, per), op, r0,     \
                         dirs, n, n_steps, static_cast<T>(ds),               \
                         static_cast<T>(0.5 * ds), acc, cells, st);          \
    err = cudaGetLastError();                                                \
    if (err != cudaSuccess) return static_cast<int>(err);                    \
    packet_cast_kernel<T><<<blocks_for(cells > 0 ? cells : 1), kBlock, 0,    \
                            st>>>(acc, cells, path, absorbed, escaped);      \
    return static_cast<int>(cudaGetLastError());                             \
  }                                                                          \
  int stromgren_prefix_##SFX(const T* r, const T* rec, int n, int nd,       \
                             const T* rs, const T* ndot,                     \
                             const unsigned char* on, int ns,                \
                             int n_iter, int nlo, int chunk, int n_blocks,   \
                             T* d, T* wrec, T* partial, void* state,         \
                             unsigned char* out, int device, void* stream) { \
    cudaError_t err = cudaSetDevice(device);                                 \
    if (err != cudaSuccess) return static_cast<int>(err);                    \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                     \
    SrcState* ss = static_cast<SrcState*>(state);                            \
    const int nhi = static_cast<int>(sizeof(T));                             \
    if (nd < 1 || nd > 3) return static_cast<int>(cudaErrorInvalidValue);    \
    if (n <= 0 || ns <= 0) return 0;                                         \
    if (nd == 3)                                                             \
      src_dist_kernel<T, 3><<<blocks_for(n), kBlock, 0, st>>>(r, n, rs, ns, d); \
    else if (nd == 2)                                                        \
      src_dist_kernel<T, 2><<<blocks_for(n), kBlock, 0, st>>>(r, n, rs, ns, d); \
    else                                                                     \
      src_dist_kernel<T, 1><<<blocks_for(n), kBlock, 0, st>>>(r, n, rs, ns, d); \
    for (int round = 0; round <= n_iter; ++round) {                          \
      weights_kernel<T><<<blocks_for(n), kBlock, 0, st>>>(                   \
          d, rec, n, ns, ndot, ss, round == 0, wrec);                        \
      for (int t = 0; t < nhi + nlo; ++t) {                                  \
        hist_kernel<T><<<dim3(n_blocks, ns), kBlock, 0, st>>>(               \
            d, wrec, n, chunk, on, ss, t, nhi, nlo, partial);                \
        select_kernel<T><<<ns, kBins, 0, st>>>(partial, n_blocks, on, ndot,  \
                                               ss, t, nhi, nlo);             \
      }                                                                      \
      err = cudaGetLastError();                                              \
      if (err != cudaSuccess) return static_cast<int>(err);                  \
    }                                                                        \
    any_reach_kernel<T><<<blocks_for(n), kBlock, 0, st>>>(d, n, ns, ss,      \
                                                          out);              \
    return static_cast<int>(cudaGetLastError());                             \
  }

RADIATION_ENTRIES(f32, float)
RADIATION_ENTRIES(f64, double)

}  // extern "C"
