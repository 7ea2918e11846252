// K17 sink_candidate, K18 accretion_sums and K20 smooth_accretion: the
// sink searches and accretion of one step, in 1-3 dims (NDIM a template
// parameter of every stage that reads a position or a velocity; the
// slot tables are NDIM wide, the spin ledger 3 wide at every ndim).
//
// K17 replaces gandalf_tpu/ops/sinks.py:sink_candidate (:94): the argmax
// of score = (alive & rho > rho_sink) ? rho : -inf over the gas, the
// first index on ties as jnp.argmax takes it, and the packed candidate
// row [r, v, m, h, score] (2 NDIM + 3 values) of that particle.  With no
// eligible particle the index is 0 and the score -inf.
//
// K18 replaces gandalf_tpu/ops/sinks.py:accretion_sums (:134): for each
// gas particle the nearest active sink with dist < sink_radius h_s (the
// first slot on ties, as jnp.argmin), eaten = alive & (some sink holds
// it), and for each slot the sums dm, dmom (NDIM) and dmr (NDIM) of the
// gas it eats: w = m, w v and w r.
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
// sqrt((dx^2 + dy^2) + dz^2) with dx = r - r_s (its first NDIM terms
// below 3D), in round-to-nearest steps the compiler may not contract, so
// that the masks equal the plain version's bit for bit, and is compared
// as dist < racc as there.
//
// K20 replaces gandalf_tpu/ops/sinks.py:smooth_accretion_sums (:182) and
// the per-sink sums of apply_smooth_accretion (:271), the smooth
// accretion of GANDALF's Sinks.cpp:520-720.  Each alive gas particle
// belongs to its nearest active sink within sink_radius h_s (dist + 1e-30
// as the JAX form takes it, the first slot on ties); each sink sums over
// its gas the mass menc, the kernel norm sum m W / rho, the rotational
// energy sum, the potential sum, the mean log viscous time and the
// radial-drift sum, and from them taccrete and macc = menc (1 -
// exp(-dt / taccrete)); each particle gives up its kernel-weighted share
// of macc, or all of itself where the rest would fall below
// smooth_accrete_frac mmean or dt < smooth_accrete_dt t_orbit.  The
// second launch moves each sink to the centre of mass of itself and what
// it took and adds to its spin ledger the angular momentum of the old
// centre of mass and of each taken parcel about the new one, with r -
// r_new and v - v_new taken directly.  W is the smoothing kernel's
// w0_s2(s^2) / h^NDIM at s = dist / h_s, and the potential term its
// wpot(s): kernel_family.cuh's Kernel<T, FAM, TAB> (M4 or the quintic,
// direct or tabulated, with its norm in NDIM from the host; the gaussian
// has no softened gravity, fault F23, and is not instantiated), so a
// table quantises s^2 on its s^2 grid as JAX's w0_s2 does.  Any kernel
// but the direct M4 forms s^2 as one rounded product.  The claim, and
// K18 and the second launch, read no kernel.  The radial-drift term keeps
// the JAX form's 4 pi d^2 at every ndim.
//
// Bound on the card: the N x Ns distance tests of the claim (one pass,
// as K18's), then reads of each particle's 4 NDIM values and a few slot
// values; about 4e6 distance tests a step at 262,144 gas and 16 slots.
//
// Design: K18's.  One thread per gas particle finds its slot over the
// slots staged in shared memory and writes its terms (6 values); a warp
// per (32-slot tile, gas chunk) sums the terms of the chunk's gas that
// belongs to each lane's slot, in particle order, and one block a slot
// adds the chunks in a fixed order; one thread a slot then takes the
// timescales.  The update does the same twice: the sums of dm, dm r and
// dm v give the new centre of mass, then the sums of dm (r - r_new) x (v
// - v_new) the spin.  No atomics: every output is written once and the
// result does not depend on the order the blocks run in.
#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>

#include "kernel_family.cuh"
#include "tree.cuh"

namespace {

using tree::add_rn;
using tree::mul_rn;
using tree::sub_rn;

constexpr int kReduce = 256;  // K17 threads a block
constexpr int kMaxBlocks = 1024;
constexpr int kTile = 128;    // K18 threads a block, slots a tile
constexpr int kWarp = 32;
constexpr int kChunk = 256;   // gas particles a partial slot sum
constexpr int kFinish = 128;  // threads a slot's final sum

// sqrt((d0^2 + d1^2) + d2^2) of r_i - r_s (the first NDIM terms), in
// round-to-nearest steps the compiler may not contract; slot t's
// components at sp[k * kTile + t] (a staged tile)
template <typename T, int NDIM>
__device__ __forceinline__ T dist_rn(const T ri[NDIM], const T* sp, int t) {
  T d2 = T(0);
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    const T dk = sub_rn(ri[k], sp[k * kTile + t]);
    d2 = k == 0 ? mul_rn(dk, dk) : add_rn(d2, mul_rn(dk, dk));
  }
  return sqrt(d2);
}

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

template <typename T, int NDIM>
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
  for (int k = 0; k < NDIM; ++k) {
    cand[k] = r[static_cast<long long>(NDIM) * gi + k];
    cand[NDIM + k] = v[static_cast<long long>(NDIM) * gi + k];
  }
  cand[2 * NDIM] = m[gi];
  cand[2 * NDIM + 1] = h[gi];
  cand[2 * NDIM + 2] = ss[0];
  *gi_out = gi;
}

// K18 stage 1: the eating slot of each gas particle, -1 when not eaten
template <typename T, int NDIM>
__global__ void __launch_bounds__(kTile) accretion_nearest(
    const T* __restrict__ r, const unsigned char* __restrict__ alive, int n,
    const T* __restrict__ rs, const T* __restrict__ hs,
    const unsigned char* __restrict__ act, int ns, T sink_radius,
    int* __restrict__ slot_of, unsigned char* __restrict__ eaten) {
  __shared__ T sp[NDIM][kTile];
  __shared__ T sr[kTile];
  __shared__ unsigned char sa[kTile];
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool live = i < n;
  T ri[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k)
    ri[k] = live ? r[static_cast<long long>(NDIM) * i + k] : T(0);
  T best = T(INFINITY);
  int near = -1;
  for (int j0 = 0; j0 < ns; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    if (j < ns) {
#pragma unroll
      for (int k = 0; k < NDIM; ++k) sp[k][threadIdx.x] = rs[NDIM * j + k];
      sr[threadIdx.x] = mul_rn(sink_radius, hs[j]);
      sa[threadIdx.x] = act[j];
    }
    __syncthreads();
    const int nt = min(kTile, ns - j0);
    if (live) {
      for (int t = 0; t < nt; ++t) {
        const T dist = dist_rn<T, NDIM>(ri, &sp[0][0], t);
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
// blockIdx.y: part[(chunk * ns + slot) * (1 + 2 NDIM) + (dm, dmom NDIM,
// dmr NDIM)]
template <typename T, int NDIM>
__global__ void __launch_bounds__(kWarp) accretion_partial(
    const int* __restrict__ slot_of, const T* __restrict__ r,
    const T* __restrict__ v, const T* __restrict__ m, int n, int ns,
    T* __restrict__ part) {
  constexpr int C = 1 + 2 * NDIM;
  __shared__ int key[kWarp];
  const int j = blockIdx.x * kWarp + threadIdx.x;
  T acc[C];
#pragma unroll
  for (int k = 0; k < C; ++k) acc[k] = T(0);
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
#pragma unroll
      for (int k = 0; k < NDIM; ++k) {
        acc[1 + k] += w * v[NDIM * p + k];
        acc[1 + NDIM + k] += w * r[NDIM * p + k];
      }
    }
    __syncwarp();
  }
  if (j >= ns) return;
  T* out = part + (static_cast<long long>(blockIdx.y) * ns + j) * C;
#pragma unroll
  for (int k = 0; k < C; ++k) out[k] = acc[k];
}

// each slot's sums over the chunks: block j, thread t adds chunks t,
// t + kFinish, ... in order, then a tree over the threads (a fixed order)
template <typename T, int NDIM>
__global__ void __launch_bounds__(kFinish) accretion_finish(
    const T* __restrict__ part, int ns, int n_chunks, T* __restrict__ dm,
    T* __restrict__ dmom, T* __restrict__ dmr) {
  constexpr int C = 1 + 2 * NDIM;
  __shared__ T red[C][kFinish];
  const int j = blockIdx.x;
  T acc[C];
#pragma unroll
  for (int k = 0; k < C; ++k) acc[k] = T(0);
  for (int c = threadIdx.x; c < n_chunks; c += kFinish) {
    const T* p = part + (static_cast<long long>(c) * ns + j) * C;
#pragma unroll
    for (int k = 0; k < C; ++k) acc[k] += p[k];
  }
#pragma unroll
  for (int k = 0; k < C; ++k) red[k][threadIdx.x] = acc[k];
  __syncthreads();
  for (int o = kFinish / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o)
#pragma unroll
      for (int k = 0; k < C; ++k)
        red[k][threadIdx.x] += red[k][threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  dm[j] = red[0][0];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    dmom[NDIM * j + k] = red[1 + k][0];
    dmr[NDIM * j + k] = red[1 + NDIM + k][0];
  }
}

// K20's sums: part[(chunk * ns + slot) * C + k] of the C values
// vals[p * C + k] of the chunk's gas p with key[p] == slot, in order
template <typename T, int C>
__global__ void __launch_bounds__(kWarp) slot_partial(
    const int* __restrict__ key, const T* __restrict__ vals, int n, int ns,
    T* __restrict__ part) {
  __shared__ int sk[kWarp];
  const int j = blockIdx.x * kWarp + threadIdx.x;
  T acc[C];
#pragma unroll
  for (int k = 0; k < C; ++k) acc[k] = T(0);
  const long long c0 = static_cast<long long>(blockIdx.y) * kChunk;
  const long long c1 = min(static_cast<long long>(n), c0 + kChunk);
  for (long long g0 = c0; g0 < c1; g0 += kWarp) {
    const long long g = g0 + threadIdx.x;
    sk[threadIdx.x] = g < c1 ? key[g] : -1;
    __syncwarp();
    const int nt = static_cast<int>(min(static_cast<long long>(kWarp),
                                        c1 - g0));
    for (int t = 0; t < nt; ++t) {
      if (sk[t] != j) continue;
      const T* x = vals + (g0 + t) * C;
#pragma unroll
      for (int k = 0; k < C; ++k) acc[k] += x[k];
    }
    __syncwarp();
  }
  if (j >= ns) return;
  T* out = part + (static_cast<long long>(blockIdx.y) * ns + j) * C;
#pragma unroll
  for (int k = 0; k < C; ++k) out[k] = acc[k];
}

template <typename T, int C>
__global__ void __launch_bounds__(kFinish) slot_finish(
    const T* __restrict__ part, int ns, int n_chunks, T* __restrict__ sums) {
  __shared__ T red[C][kFinish];
  const int j = blockIdx.x;
  T acc[C];
#pragma unroll
  for (int k = 0; k < C; ++k) acc[k] = T(0);
  for (int c = threadIdx.x; c < n_chunks; c += kFinish) {
    const T* p = part + (static_cast<long long>(c) * ns + j) * C;
#pragma unroll
    for (int k = 0; k < C; ++k) acc[k] += p[k];
  }
#pragma unroll
  for (int k = 0; k < C; ++k) red[k][threadIdx.x] = acc[k];
  __syncthreads();
  for (int o = kFinish / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o)
#pragma unroll
      for (int k = 0; k < C; ++k)
        red[k][threadIdx.x] += red[k][threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int k = 0; k < C; ++k) sums[static_cast<long long>(j) * C + k] =
      red[k][0];
}

template <typename T, int C>
void slot_sums(const int* key, const T* vals, int n, int ns, T* part,
               T* sums, cudaStream_t stream) {
  const int n_chunks = (n + kChunk - 1) / kChunk;
  if (n_chunks > 0) {
    const dim3 grid((ns + kWarp - 1) / kWarp, n_chunks);
    slot_partial<T, C><<<grid, kWarp, 0, stream>>>(key, vals, n, ns, part);
  }
  slot_finish<T, C><<<ns, kFinish, 0, stream>>>(part, ns, n_chunks, sums);
}

constexpr int kTerms = 6;   // K20's terms a particle
constexpr int kSpin = 3;    // the spin ledger's columns at every ndim

// dm, dm r, dm v: the move table's columns
template <int NDIM>
constexpr int kMoveCols = 1 + 2 * NDIM;
constexpr int kSlotThreads = 128;
constexpr double kPi = 3.14159265358979323846;

// K20 launch 1, stage 1: each gas particle's slot (-1 for none) and its
// terms: m, m W/rho, m dv_t^2 W/rho, m wpot(s)/h_s, m log(sqrt(d)/c^2)
// (floored at 1e-30 inside the log) and |4 pi d^2 m dvdr W|
template <typename T, int NDIM, class KF>
__global__ void __launch_bounds__(kTile) smooth_terms(
    const T* __restrict__ r, const T* __restrict__ v,
    const T* __restrict__ m, const T* __restrict__ rho,
    const T* __restrict__ sound, const unsigned char* __restrict__ alive,
    int n, const T* __restrict__ rs, const T* __restrict__ vs,
    const T* __restrict__ hs, const unsigned char* __restrict__ act, int ns,
    T sink_radius, const KF kern, int* __restrict__ slot_of,
    T* __restrict__ vals) {
  __shared__ T sp[NDIM][kTile];
  __shared__ T sr[kTile];
  __shared__ unsigned char sa[kTile];
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool live = i < n && alive[i];
  T ri[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k)
    ri[k] = i < n ? r[static_cast<long long>(NDIM) * i + k] : T(0);
  T best = T(INFINITY);
  int near = -1;
  for (int j0 = 0; j0 < ns; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    if (j < ns) {
#pragma unroll
      for (int k = 0; k < NDIM; ++k) sp[k][threadIdx.x] = rs[NDIM * j + k];
      sr[threadIdx.x] = mul_rn(sink_radius, hs[j]);
      sa[threadIdx.x] = act[j];
    }
    __syncthreads();
    const int nt = min(kTile, ns - j0);
    if (live) {
      for (int t = 0; t < nt; ++t) {
        const T dist = add_rn(dist_rn<T, NDIM>(ri, &sp[0][0], t),
                              T(1e-30));
        if (sa[t] && dist < sr[t] && dist < best) {
          best = dist;
          near = j0 + t;
        }
      }
    }
    __syncthreads();
  }
  if (i >= n) return;
  slot_of[i] = near;
  T* out = vals + static_cast<long long>(kTerms) * i;
  if (near < 0) {
#pragma unroll
    for (int k = 0; k < kTerms; ++k) out[k] = T(0);
    return;
  }
  const T mi = m[i];
  T dr[NDIM], dv[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    dr[k] = ri[k] - rs[NDIM * near + k];
    dv[k] = v[static_cast<long long>(NDIM) * i + k] - vs[NDIM * near + k];
  }
  const T dist = best;
  const T ih = T(1) / max(hs[near], T(1e-30));
  const T s = dist * ih;
  // h^-NDIM: (ih ih) ih in 3D, as the 3D-only kernel took it
  T ihn = ih;
#pragma unroll
  for (int k = 1; k < NDIM; ++k) ihn *= ih;
  const T ssqd = KF::kExactD2 ? kf::mul(s, s) : s * s;
  const T w0 = kern.w0_s2(ssqd) * ihn;
  const T w_rho = w0 / max(rho[i], T(1e-30));
  T dvdr = T(0), dv2 = T(0);
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    dvdr += dv[k] * (dr[k] / dist);
    dv2 += dv[k] * dv[k];
  }
  const T c = max(sound[i], T(1e-30));
  out[0] = mi;
  out[1] = mi * w_rho;
  out[2] = mi * (dv2 - dvdr * dvdr) * w_rho;
  out[3] = mi * ih * kern.wpot(s);
  out[4] = mi * log(max(sqrt(dist) / (c * c), T(1e-30)));
  out[5] = fabs(T(4 * kPi) * dist * dist * mi * dvdr * w0);
}

// K20 launch 1, stage 2: each slot's timescales and accreted mass;
// slot_scr[2 j] = max(wnorm, 1e-30), slot_scr[2 j + 1] = t_orbit
template <typename T>
__global__ void __launch_bounds__(kSlotThreads) smooth_slots(
    const T* __restrict__ sums, const T* __restrict__ ms,
    const T* __restrict__ hs, int ns, T sink_radius, const T* __restrict__ dt,
    T alpha_ss, T* __restrict__ menc_out, T* __restrict__ macc_out,
    T* __restrict__ tacc_out, T* __restrict__ slot_scr) {
  const int j = blockIdx.x * kSlotThreads + threadIdx.x;
  if (j >= ns) return;
  const T* x = sums + static_cast<long long>(kTerms) * j;
  const T menc = x[0], wnorm = x[1], msink = ms[j];
  const T norm = T(0.5) * menc / max(wnorm, T(1e-30));
  const T rotke = norm * x[2];
  const T gpetot = T(0.5) * (msink + T(0.5) * menc) * x[3];
  const T tvisc = sqrt(msink + menc) * exp(x[4] / max(menc, T(1e-30)))
                  / alpha_ss;
  const T trad = menc / max(x[5], T(1e-30));
  const T racc = sink_radius * hs[j];
  const T trot = T(2 * kPi)
                 * sqrt(racc * racc * racc / max(menc + msink, T(1e-30)));
  const T efrac = min(max(T(2) * rotke / max(gpetot, T(1e-30)), T(0)),
                      T(1));
  const T tacc = pow(max(trad, T(1e-30)), T(1) - efrac)
                 * pow(max(tvisc, T(1e-30)), efrac);
  const T macc = menc * max(T(1) - exp(-*dt / max(tacc, T(1e-30))), T(0));
  menc_out[j] = menc;
  macc_out[j] = macc;
  tacc_out[j] = tacc;
  slot_scr[2 * j] = max(wnorm, T(1e-30));
  slot_scr[2 * j + 1] = trot;
}

// K20 launch 1, stage 3: the mass each particle gives up
template <typename T>
__global__ void __launch_bounds__(kTile) smooth_dm(
    const int* __restrict__ slot_of, const T* __restrict__ vals,
    const T* __restrict__ m, int n, const T* __restrict__ macc,
    const T* __restrict__ slot_scr, const T* __restrict__ dt, T frac_mmean,
    T sdt, T* __restrict__ dm_out) {
  const int i = blockIdx.x * kTile + threadIdx.x;
  if (i >= n) return;
  const int j = slot_of[i];
  if (j < 0) {
    dm_out[i] = min(T(0), m[i]);
    return;
  }
  const T mi = m[i];
  T dm = min(vals[static_cast<long long>(kTerms) * i + 1] / slot_scr[2 * j]
             * macc[j], mi);
  if (mi - dm < frac_mmean || *dt < sdt * slot_scr[2 * j + 1]) dm = mi;
  dm_out[i] = dm;
}

// K20 launch 2, stage 1: dm, dm r and dm v of each claimed particle, and
// the gas that is left
template <typename T, int NDIM>
__global__ void __launch_bounds__(kTile) move_terms(
    const int* __restrict__ slot_of, const T* __restrict__ r,
    const T* __restrict__ v, const T* __restrict__ m,
    const T* __restrict__ dm, const unsigned char* __restrict__ alive,
    int n, T* __restrict__ vals, T* __restrict__ m_gas,
    unsigned char* __restrict__ alive_new) {
  const int i = blockIdx.x * kTile + threadIdx.x;
  if (i >= n) return;
  const T w = slot_of[i] >= 0 ? dm[i] : T(0);
  T* out = vals + static_cast<long long>(kMoveCols<NDIM>) * i;
  out[0] = w;
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    out[1 + k] = w * r[static_cast<long long>(NDIM) * i + k];
    out[1 + NDIM + k] = w * v[static_cast<long long>(NDIM) * i + k];
  }
  const T left = m[i] - dm[i];
  m_gas[i] = left;
  alive_new[i] = (alive[i] && left > T(0)) ? 1 : 0;
}

// K20 launch 2, stage 2: each slot's new mass and centre of mass;
// com[(1 + 2 NDIM) j] = (m_new, r_new, v_new)
template <typename T, int NDIM>
__global__ void __launch_bounds__(kSlotThreads) move_slots(
    const T* __restrict__ sums, const T* __restrict__ rs,
    const T* __restrict__ vs, const T* __restrict__ ms, int ns,
    T* __restrict__ com) {
  const int j = blockIdx.x * kSlotThreads + threadIdx.x;
  if (j >= ns) return;
  constexpr int C = kMoveCols<NDIM>;
  const T* x = sums + static_cast<long long>(C) * j;
  const T m0 = ms[j];
  const T m_new = m0 + x[0];
  const T msafe = max(m_new, T(1e-300));
  T* out = com + static_cast<long long>(C) * j;
  out[0] = m_new;
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    out[1 + k] = (m0 * rs[NDIM * j + k] + x[1 + k]) / msafe;
    out[1 + NDIM + k] = (m0 * vs[NDIM * j + k] + x[1 + NDIM + k]) / msafe;
  }
}

// the spin a x b as the JAX package's apply_smooth_accretion takes it
// (gandalf_tpu/ops/sinks.py:288-292): the cross product in 3D; (0, 0,
// a0 b1 - a1 b0) in 2D; in 1D its a[..., 1] is out of bounds and JAX
// clamps a static index to the last one, so z = a0 b0 - a0 b0: exactly
// 0, and the ledger stays zero
template <typename T, int NDIM>
__device__ __forceinline__ void spin_cross(const T a[NDIM], const T b[NDIM],
                                           T c[3]) {
  if constexpr (NDIM == 3) {
    c[0] = a[1] * b[2] - a[2] * b[1];
    c[1] = a[2] * b[0] - a[0] * b[2];
    c[2] = a[0] * b[1] - a[1] * b[0];
  } else if constexpr (NDIM == 2) {
    c[0] = c[1] = T(0);
    c[2] = a[0] * b[1] - a[1] * b[0];
  } else {
    c[0] = c[1] = c[2] = T(0);
  }
}

// K20 launch 2, stage 3: dm (r - r_new) x (v - v_new) of each particle
template <typename T, int NDIM>
__global__ void __launch_bounds__(kTile) spin_terms(
    const int* __restrict__ slot_of, const T* __restrict__ r,
    const T* __restrict__ v, const T* __restrict__ dm, int n,
    const T* __restrict__ com, T* __restrict__ vals) {
  const int i = blockIdx.x * kTile + threadIdx.x;
  if (i >= n) return;
  const int j = slot_of[i];
  T* out = vals + static_cast<long long>(kSpin) * i;
  if (j < 0) {
    out[0] = out[1] = out[2] = T(0);
    return;
  }
  const T* c = com + static_cast<long long>(kMoveCols<NDIM>) * j;
  T a[NDIM], b[NDIM], l[3];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    a[k] = r[static_cast<long long>(NDIM) * i + k] - c[1 + k];
    b[k] = v[static_cast<long long>(NDIM) * i + k] - c[1 + NDIM + k];
  }
  spin_cross<T, NDIM>(a, b, l);
  const T w = dm[i];
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = w * l[k];
}

// K20 launch 2, stage 4: the slots' new fields, where a slot is active
// and took mass
template <typename T, int NDIM>
__global__ void __launch_bounds__(kSlotThreads) spin_slots(
    const T* __restrict__ move, const T* __restrict__ spin,
    const T* __restrict__ com, const T* __restrict__ rs,
    const T* __restrict__ vs, const T* __restrict__ r0s,
    const T* __restrict__ v0s, const T* __restrict__ ms,
    const T* __restrict__ angmom, const unsigned char* __restrict__ act,
    int ns, T* __restrict__ r_out, T* __restrict__ v_out,
    T* __restrict__ r0_out, T* __restrict__ v0_out, T* __restrict__ m_out,
    T* __restrict__ angmom_out) {
  const int j = blockIdx.x * kSlotThreads + threadIdx.x;
  if (j >= ns) return;
  constexpr int C = kMoveCols<NDIM>;
  const bool upd = act[j] && move[static_cast<long long>(C) * j] > T(0);
  const T* c = com + static_cast<long long>(C) * j;
  T a[NDIM], b[NDIM], l[3];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    a[k] = rs[NDIM * j + k] - c[1 + k];
    b[k] = vs[NDIM * j + k] - c[1 + NDIM + k];
  }
  spin_cross<T, NDIM>(a, b, l);
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    r_out[NDIM * j + k] = upd ? c[1 + k] : rs[NDIM * j + k];
    v_out[NDIM * j + k] = upd ? c[1 + NDIM + k] : vs[NDIM * j + k];
    r0_out[NDIM * j + k] = upd ? c[1 + k] : r0s[NDIM * j + k];
    v0_out[NDIM * j + k] = upd ? c[1 + NDIM + k] : v0s[NDIM * j + k];
  }
#pragma unroll
  for (int k = 0; k < kSpin; ++k)
    angmom_out[kSpin * j + k] =
        angmom[kSpin * j + k]
        + (upd ? ms[j] * l[k] + spin[kSpin * static_cast<long long>(j) + k]
               : T(0));
  m_out[j] = upd ? c[0] : ms[j];
}

int candidate_blocks(int n) {
  return max(1, min(kMaxBlocks, (n + kReduce - 1) / kReduce));
}

template <typename T, int NDIM>
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
  candidate_finish<T, NDIM><<<1, kReduce, 0, stream>>>(
      part_s, part_i, nb, r, v, m, h, n, cand, gi);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NDIM>
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
    accretion_nearest<T, NDIM><<<(n + kTile - 1) / kTile, kTile, 0,
                                 stream>>>(r, alive, n, rs, hs, act, ns,
                                           T(sink_radius), slot_of, eaten);
  if (ns > 0) {
    const int n_chunks = (n + kChunk - 1) / kChunk;
    if (n_chunks > 0) {
      const dim3 grid((ns + kWarp - 1) / kWarp, n_chunks);
      accretion_partial<T, NDIM><<<grid, kWarp, 0, stream>>>(
          slot_of, r, v, m, n, ns, part);
    }
    accretion_finish<T, NDIM><<<ns, kFinish, 0, stream>>>(
        part, ns, n_chunks, dm, dmom, dmr);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NDIM>
int run_smooth_sums(const T* r, const T* v, const T* m, const T* rho,
                    const T* sound, const unsigned char* alive, int n,
                    const T* rs, const T* vs, const T* ms, const T* hs,
                    const unsigned char* act, int ns, double sink_radius,
                    const T* dt, double norm, int family, int res,
                    double mmean, double alpha_ss, double frac, double sdt,
                    int* slot_of, T* vals, T* part,
                    T* sums, T* slot_scr, T* dm, T* menc, T* macc, T* tacc,
                    int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nb = (n + kTile - 1) / kTile;
  const bool known = kf::with_kernel<T, true>(
      family, res, norm, NDIM, [&](const auto& kern) {
        using KF = std::decay_t<decltype(kern)>;
        if (n > 0)
          smooth_terms<T, NDIM, KF><<<nb, kTile, 0, stream>>>(
              r, v, m, rho, sound, alive, n, rs, vs, hs, act, ns,
              T(sink_radius), kern, slot_of, vals);
      });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  if (ns > 0) {
    slot_sums<T, kTerms>(slot_of, vals, n, ns, part, sums, stream);
    smooth_slots<T><<<(ns + kSlotThreads - 1) / kSlotThreads, kSlotThreads,
                      0, stream>>>(sums, ms, hs, ns, T(sink_radius), dt,
                                   T(alpha_ss), menc, macc, tacc, slot_scr);
  }
  if (n > 0)
    smooth_dm<T><<<nb, kTile, 0, stream>>>(slot_of, vals, m, n, macc,
                                           slot_scr, dt, T(frac * mmean),
                                           T(sdt), dm);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NDIM>
int run_smooth_apply(const T* r, const T* v, const T* m, const T* dm,
                     const int* slot_of, const unsigned char* alive, int n,
                     const T* rs, const T* vs, const T* r0s, const T* v0s,
                     const T* ms, const T* angmom, const unsigned char* act,
                     int ns, T* vals, T* part, T* move, T* spin, T* com,
                     T* r_out, T* v_out, T* r0_out, T* v0_out, T* m_out,
                     T* angmom_out, T* m_gas, unsigned char* alive_new,
                     int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nb = (n + kTile - 1) / kTile;
  const int sb = (ns + kSlotThreads - 1) / kSlotThreads;
  if (n > 0)
    move_terms<T, NDIM><<<nb, kTile, 0, stream>>>(
        slot_of, r, v, m, dm, alive, n, vals, m_gas, alive_new);
  if (ns == 0) return static_cast<int>(cudaGetLastError());
  slot_sums<T, kMoveCols<NDIM>>(slot_of, vals, n, ns, part, move, stream);
  move_slots<T, NDIM><<<sb, kSlotThreads, 0, stream>>>(move, rs, vs, ms, ns,
                                                       com);
  if (n > 0)
    spin_terms<T, NDIM><<<nb, kTile, 0, stream>>>(slot_of, r, v, dm, n, com,
                                                  vals);
  slot_sums<T, kSpin>(slot_of, vals, n, ns, part, spin, stream);
  spin_slots<T, NDIM><<<sb, kSlotThreads, 0, stream>>>(
      move, spin, com, rs, vs, r0s, v0s, ms, angmom, act, ns, r_out, v_out,
      r0_out, v0_out, m_out, angmom_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sink_candidate_blocks(int n) { return candidate_blocks(n); }

// sink_candidate_{f32,f64}, accretion_sums_*, smooth_accretion_sums_*
// and smooth_accretion_apply_* in 3D; the same names with _2d and _1d
// before the float suffix below 3D
#define SINK_ENTRIES(DSFX, ND, SFX, T)                                      \
  int sink_candidate##DSFX##_##SFX(                                         \
      const T* rho, const unsigned char* alive, int n, double rho_sink,     \
      const T* r, const T* v, const T* m, const T* h, T* part_s,            \
      int* part_i, T* cand, long long* gi, int device, void* stream) {      \
    return run_candidate<T, ND>(rho, alive, n, rho_sink, r, v, m, h,        \
                                part_s, part_i, cand, gi, device, stream);  \
  }                                                                         \
  int accretion_sums##DSFX##_##SFX(                                         \
      const T* r, const T* v, const T* m, const unsigned char* alive,       \
      int n, const T* rs, const T* hs, const unsigned char* act, int ns,    \
      double sink_radius, int* slot_of, T* part, T* dm, T* dmom, T* dmr,    \
      unsigned char* eaten, int device, void* stream) {                     \
    return run_accretion<T, ND>(r, v, m, alive, n, rs, hs, act, ns,         \
                                sink_radius, slot_of, part, dm, dmom, dmr,  \
                                eaten, device, stream);                     \
  }                                                                         \
  int smooth_accretion_sums##DSFX##_##SFX(                                  \
      const T* r, const T* v, const T* m, const T* rho, const T* sound,     \
      const unsigned char* alive, int n, const T* rs, const T* vs,          \
      const T* ms, const T* hs, const unsigned char* act, int ns,           \
      double sink_radius, const T* dt, double norm, int family, int res,    \
      double mmean, double alpha_ss, double frac, double sdt, int* slot_of, \
      T* vals, T* part, T* sums, T* slot_scr, T* dm, T* menc, T* macc,      \
      T* tacc, int device, void* stream) {                                  \
    return run_smooth_sums<T, ND>(r, v, m, rho, sound, alive, n, rs, vs,    \
                                  ms, hs, act, ns, sink_radius, dt, norm,   \
                                  family, res, mmean, alpha_ss, frac, sdt,  \
                                  slot_of, vals, part, sums, slot_scr, dm,  \
                                  menc, macc, tacc, device, stream);        \
  }                                                                         \
  int smooth_accretion_apply##DSFX##_##SFX(                                 \
      const T* r, const T* v, const T* m, const T* dm, const int* slot_of,  \
      const unsigned char* alive, int n, const T* rs, const T* vs,          \
      const T* r0s, const T* v0s, const T* ms, const T* angmom,             \
      const unsigned char* act, int ns, T* vals, T* part, T* move, T* spin, \
      T* com, T* r_out, T* v_out, T* r0_out, T* v0_out, T* m_out,           \
      T* angmom_out, T* m_gas, unsigned char* alive_new, int device,        \
      void* stream) {                                                       \
    return run_smooth_apply<T, ND>(                                         \
        r, v, m, dm, slot_of, alive, n, rs, vs, r0s, v0s, ms, angmom, act,  \
        ns, vals, part, move, spin, com, r_out, v_out, r0_out, v0_out,      \
        m_out, angmom_out, m_gas, alive_new, device, stream);               \
  }

SINK_ENTRIES(, 3, f32, float)
SINK_ENTRIES(, 3, f64, double)
SINK_ENTRIES(_2d, 2, f32, float)
SINK_ENTRIES(_2d, 2, f64, double)
SINK_ENTRIES(_1d, 1, f32, float)
SINK_ENTRIES(_1d, 1, f64, double)

}  // extern "C"
