// K17 sink_candidate and K18 accretion_sums: the sink searches of one
// step.
//
// K17 replaces gandalf_tpu/ops/sinks.py:sink_candidate (:94): the argmax
// of score = (alive & rho > rho_sink) ? rho : -inf over the gas, the
// first index on ties as jnp.argmax takes it, and the packed candidate
// row [r, v, m, h, score] of that particle.  With no eligible particle
// the index is 0 and the score -inf.
//
// K18 replaces gandalf_tpu/ops/sinks.py:accretion_sums (:134): for each
// gas particle the nearest active sink with dist < sink_radius h_s (the
// first slot on ties, as jnp.argmin), eaten = alive & (some sink holds
// it), and for each slot the sums dm, dmom (3) and dmr (3) of the gas it
// eats: w = m, w v and w r.
//
// Bound on the card: K17 reads 2 values a particle (memory); K18 does
// N x Ns distance tests and reads 5 values a particle and a slot.  At the
// Boss-Bodenheimer path's 262,144 gas particles and 16 slots both take
// microseconds, launch latency included.
//
// Design.  K17: a two-stage (score, index) reduction: each block reduces
// a fixed share of the particles through shared memory, then one block
// reduces the blocks' pairs and writes the row.  (score, index) with the
// larger score, or the lower index of equal scores, is associative and
// commutative, so the result does not depend on the order.  K18: one
// thread per gas particle tests the slots, staged in shared memory kTile
// at a time, in slot order with a strict "<", and writes its slot (or -1
// when not eaten); then one warp per (32-slot tile, gas chunk) sums, lane
// per slot, the eaten gas of the chunk in particle order, and a second
// pass, one block a slot, adds each slot's partials: no atomics, a fixed
// order, each output written once.  The distance is
// sqrt((dx^2 + dy^2) + dz^2) with dx = r - r_s, in round-to-nearest steps
// the compiler may not contract, so that the masks equal the plain
// version's bit for bit, and is compared as dist < racc as there.
#include <cuda_runtime.h>

#include <cmath>

#include "tree.cuh"

namespace {

using tree::add_rn;
using tree::mul_rn;
using tree::sub_rn;

constexpr int kReduce = 256;  // K17 threads a block
constexpr int kMaxBlocks = 1024;
constexpr int kTile = 128;    // K18 threads a block, slots a tile
constexpr int kWarp = 32;
constexpr int kChunk = 256;   // K18 gas particles a partial sum
constexpr int kFinish = 128;  // K18 threads a slot's final sum

// (s, i) beats (t, k): the larger score, or the lower index of a tie
template <typename T>
__device__ __forceinline__ bool better(T s, int i, T t, int k) {
  return s > t || (s == t && i < k);
}

template <typename T>
__device__ void block_argmax(T* ss, int* si, T s, int i) {
  ss[threadIdx.x] = s;
  si[threadIdx.x] = i;
  __syncthreads();
  for (int o = kReduce / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) {
      const T t = ss[threadIdx.x + o];
      const int k = si[threadIdx.x + o];
      if (better(t, k, ss[threadIdx.x], si[threadIdx.x])) {
        ss[threadIdx.x] = t;
        si[threadIdx.x] = k;
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kReduce) candidate_partial(
    const T* __restrict__ rho, const unsigned char* __restrict__ alive,
    int n, T rho_sink, T* __restrict__ part_s, int* __restrict__ part_i) {
  __shared__ T ss[kReduce];
  __shared__ int si[kReduce];
  T best = -INFINITY;
  int bi = 0x7fffffff;
  for (int i = blockIdx.x * kReduce + threadIdx.x; i < n;
       i += gridDim.x * kReduce) {
    const T s = (alive[i] && rho[i] > rho_sink) ? rho[i] : T(-INFINITY);
    if (better(s, i, best, bi)) {
      best = s;
      bi = i;
    }
  }
  block_argmax(ss, si, best, bi);
  if (threadIdx.x == 0) {
    part_s[blockIdx.x] = ss[0];
    part_i[blockIdx.x] = si[0];
  }
}

template <typename T>
__global__ void __launch_bounds__(kReduce) candidate_finish(
    const T* __restrict__ part_s, const int* __restrict__ part_i,
    int n_parts, const T* __restrict__ r, const T* __restrict__ v,
    const T* __restrict__ m, const T* __restrict__ h, int n,
    T* __restrict__ cand, long long* __restrict__ gi_out) {
  __shared__ T ss[kReduce];
  __shared__ int si[kReduce];
  T best = -INFINITY;
  int bi = 0x7fffffff;
  for (int b = threadIdx.x; b < n_parts; b += kReduce)
    if (better(part_s[b], part_i[b], best, bi)) {
      best = part_s[b];
      bi = part_i[b];
    }
  block_argmax(ss, si, best, bi);
  if (threadIdx.x != 0) return;
  // every score -inf: jnp.argmax's first index, 0
  const int gi = (ss[0] == T(-INFINITY) || si[0] >= n) ? 0 : si[0];
  for (int k = 0; k < 3; ++k) {
    cand[k] = r[3LL * gi + k];
    cand[3 + k] = v[3LL * gi + k];
  }
  cand[6] = m[gi];
  cand[7] = h[gi];
  cand[8] = ss[0];
  *gi_out = gi;
}

// K18 stage 1: the eating slot of each gas particle, -1 when not eaten
template <typename T>
__global__ void __launch_bounds__(kTile) accretion_nearest(
    const T* __restrict__ r, const unsigned char* __restrict__ alive, int n,
    const T* __restrict__ rs, const T* __restrict__ hs,
    const unsigned char* __restrict__ act, int ns, T sink_radius,
    int* __restrict__ slot_of, unsigned char* __restrict__ eaten) {
  __shared__ T sx[kTile], sy[kTile], sz[kTile], sr[kTile];
  __shared__ unsigned char sa[kTile];
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool live = i < n;
  const T xi = live ? r[3LL * i] : T(0);
  const T yi = live ? r[3LL * i + 1] : T(0);
  const T zi = live ? r[3LL * i + 2] : T(0);
  T best = T(INFINITY);
  int near = -1;
  for (int j0 = 0; j0 < ns; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    if (j < ns) {
      sx[threadIdx.x] = rs[3 * j];
      sy[threadIdx.x] = rs[3 * j + 1];
      sz[threadIdx.x] = rs[3 * j + 2];
      sr[threadIdx.x] = mul_rn(sink_radius, hs[j]);
      sa[threadIdx.x] = act[j];
    }
    __syncthreads();
    const int nt = min(kTile, ns - j0);
    if (live) {
      for (int t = 0; t < nt; ++t) {
        const T dx = sub_rn(xi, sx[t]), dy = sub_rn(yi, sy[t]),
                dz = sub_rn(zi, sz[t]);
        const T dist = sqrt(add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)),
                                   mul_rn(dz, dz)));
        if (sa[t] && dist < sr[t] && dist < best) {
          best = dist;
          near = j0 + t;
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;
  const bool ate = alive[i] && near >= 0;
  slot_of[i] = ate ? near : -1;
  eaten[i] = ate ? 1 : 0;
}

// K18 stage 2: partial sums of slot tile blockIdx.x over gas chunk
// blockIdx.y: part[(chunk * ns + slot) * 7 + (dm, dmom 3, dmr 3)]
template <typename T>
__global__ void __launch_bounds__(kWarp) accretion_partial(
    const int* __restrict__ slot_of, const T* __restrict__ r,
    const T* __restrict__ v, const T* __restrict__ m, int n, int ns,
    T* __restrict__ part) {
  __shared__ int key[kWarp];
  const int j = blockIdx.x * kWarp + threadIdx.x;
  T acc[7] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  const long long c0 = static_cast<long long>(blockIdx.y) * kChunk;
  const long long c1 = min(static_cast<long long>(n), c0 + kChunk);
  for (long long g0 = c0; g0 < c1; g0 += kWarp) {
    const long long g = g0 + threadIdx.x;
    key[threadIdx.x] = g < c1 ? slot_of[g] : -1;
    __syncwarp();
    const int nt = static_cast<int>(min(static_cast<long long>(kWarp),
                                        c1 - g0));
    for (int t = 0; t < nt; ++t) {
      if (key[t] != j) continue;
      const long long p = g0 + t;
      const T w = m[p];
      acc[0] += w;
      for (int k = 0; k < 3; ++k) {
        acc[1 + k] += w * v[3 * p + k];
        acc[4 + k] += w * r[3 * p + k];
      }
    }
    __syncwarp();
  }
  if (j >= ns) return;
  T* out = part + (static_cast<long long>(blockIdx.y) * ns + j) * 7;
  for (int k = 0; k < 7; ++k) out[k] = acc[k];
}

// each slot's sums over the chunks: block j, thread t adds chunks t,
// t + kFinish, ... in order, then a tree over the threads (a fixed order)
template <typename T>
__global__ void __launch_bounds__(kFinish) accretion_finish(
    const T* __restrict__ part, int ns, int n_chunks, T* __restrict__ dm,
    T* __restrict__ dmom, T* __restrict__ dmr) {
  __shared__ T red[7][kFinish];
  const int j = blockIdx.x;
  T acc[7] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  for (int c = threadIdx.x; c < n_chunks; c += kFinish) {
    const T* p = part + (static_cast<long long>(c) * ns + j) * 7;
    for (int k = 0; k < 7; ++k) acc[k] += p[k];
  }
  for (int k = 0; k < 7; ++k) red[k][threadIdx.x] = acc[k];
  __syncthreads();
  for (int o = kFinish / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o)
      for (int k = 0; k < 7; ++k)
        red[k][threadIdx.x] += red[k][threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  dm[j] = red[0][0];
  for (int k = 0; k < 3; ++k) {
    dmom[3 * j + k] = red[1 + k][0];
    dmr[3 * j + k] = red[4 + k][0];
  }
}

int candidate_blocks(int n) {
  return max(1, min(kMaxBlocks, (n + kReduce - 1) / kReduce));
}

template <typename T>
int run_candidate(const T* rho, const unsigned char* alive, int n,
                  double rho_sink, const T* r, const T* v, const T* m,
                  const T* h, T* part_s, int* part_i, T* cand,
                  long long* gi, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nb = candidate_blocks(n);
  candidate_partial<T><<<nb, kReduce, 0, stream>>>(rho, alive, n,
                                                   T(rho_sink), part_s,
                                                   part_i);
  candidate_finish<T><<<1, kReduce, 0, stream>>>(part_s, part_i, nb, r, v,
                                                 m, h, n, cand, gi);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_accretion(const T* r, const T* v, const T* m,
                  const unsigned char* alive, int n, const T* rs,
                  const T* hs, const unsigned char* act, int ns,
                  double sink_radius, int* slot_of, T* part, T* dm, T* dmom,
                  T* dmr, unsigned char* eaten, int device,
                  void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n > 0)
    accretion_nearest<T><<<(n + kTile - 1) / kTile, kTile, 0, stream>>>(
        r, alive, n, rs, hs, act, ns, T(sink_radius), slot_of, eaten);
  if (ns > 0) {
    const int n_chunks = (n + kChunk - 1) / kChunk;
    if (n_chunks > 0) {
      const dim3 grid((ns + kWarp - 1) / kWarp, n_chunks);
      accretion_partial<T><<<grid, kWarp, 0, stream>>>(slot_of, r, v, m, n,
                                                       ns, part);
    }
    accretion_finish<T><<<ns, kFinish, 0, stream>>>(part, ns, n_chunks, dm,
                                                   dmom, dmr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sink_candidate_blocks(int n) { return candidate_blocks(n); }

#define SINK_ENTRIES(SFX, T)                                                \
  int sink_candidate_##SFX(const T* rho, const unsigned char* alive, int n, \
                           double rho_sink, const T* r, const T* v,         \
                           const T* m, const T* h, T* part_s, int* part_i,  \
                           T* cand, long long* gi, int device,              \
                           void* stream) {                                  \
    return run_candidate<T>(rho, alive, n, rho_sink, r, v, m, h, part_s,    \
                            part_i, cand, gi, device, stream);              \
  }                                                                         \
  int accretion_sums_##SFX(const T* r, const T* v, const T* m,              \
                           const unsigned char* alive, int n, const T* rs,  \
                           const T* hs, const unsigned char* act, int ns,   \
                           double sink_radius, int* slot_of, T* part,       \
                           T* dm, T* dmom, T* dmr, unsigned char* eaten,    \
                           int device, void* stream) {                      \
    return run_accretion<T>(r, v, m, alive, n, rs, hs, act, ns,             \
                            sink_radius, slot_of, part, dm, dmom, dmr,      \
                            eaten, device, stream);                         \
  }

SINK_ENTRIES(f32, float)
SINK_ENTRIES(f64, double)

}  // extern "C"
