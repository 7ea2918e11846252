// K16 star_gas_forces: mean-h kernel-softened gravity between every gas
// particle and every star (sink) slot, both ways, in 1-3 dims (NDIM a
// template parameter: the softened wgrav and wpot carry no ndim
// normalisation, so only the separations change with NDIM).  The kernel
// is kernel_family.cuh's Kernel<T, FAM, TAB>, a template parameter: M4 or
// the quintic, direct or tabulated (the gaussian has no softened gravity,
// fault F23, and is not instantiated).
//
// Replaces gandalf_tpu/ops/sph_gravity.py:star_gas_forces (:30), which
// builds (N, Ns, ndim) pair arrays and reduces them along each axis:
//   gas side   a_i = sum_s m_s act_s wg unit,  gpot_i = sum_s m_s act_s wp
//   star side  a_s = -sum_i m_i wg unit,        gpot_s = sum_i m_i wp
// with dr = r_s - r_i, hbar = (h_i + h_s)/2, s = |dr|/hbar,
// wg = wgrav(s)/hbar^2, wp = wpot(s)/hbar and unit = dr/|dr|.
//
// Bound on the card: arithmetic.  N x Ns pairs, each with a square root,
// two divisions and the softening kernel, evaluated once for each side; the
// inputs are NDIM + 2 values a particle or slot.  At the Boss-Bodenheimer
// path's 262,144 gas particles and 16 slots the work is a few
// microseconds; at an embedded cluster's 4,096 stars it is 1.1e9 pairs a
// side.
//
// Design: the gas side is K14's tiled loop, one thread per gas particle
// with its sums in registers and the star slots staged in shared memory
// kTile at a time.  The star side needs a sum over N for only Ns targets,
// so it runs one warp per (32-slot tile, gas chunk of kChunk particles):
// a lane owns one slot and sweeps the chunk, staged through shared memory
// 32 gas particles at a time, and writes its NDIM + 1 partial sums; a
// second pass adds each slot's partials over the chunks in a fixed order,
// one block a slot.  No atomics, each target written once, sums in a
// fixed order; 16 slots at 262,144 particles make 1,024 warps, about 8 an
// SM.  Each pair follows the JAX formula term by term: a coincident pair
// (d^2 = 0) takes |dr| = 1 and unit 0 before any division, as there (its
// potential term stays), and an inactive slot counts on the gas side
// through act only.  IEEE sqrt and division (no fast-math).  The 3D
// instantiation keeps the arithmetic of the 3D-only kernel it replaced
// (d^2 = dx^2 + dy^2 + dz^2 written out, the components in order); any
// kernel but the direct M4 sums d^2 in the plain version's rounded steps
// (kExactD2), so that s, and a table index, are the plain version's.
#include <cuda_runtime.h>

#include "kernel_family.cuh"

namespace {

constexpr int kTile = 128;   // gas side: threads a block, slots a tile
constexpr int kWarp = 32;    // star side: slots a block
constexpr int kChunk = 256;  // star side: gas particles a block
constexpr int kFinish = 128; // star side: threads a slot's final sum

// |d|^2 of a separation, the components summed left to right (with
// kExactD2 each product and sum rounded on its own)
template <typename T, int NDIM, class KF>
__device__ __forceinline__ T norm2(const T d[NDIM]) {
  if constexpr (KF::kExactD2) {
    T d2 = kf::mul(d[0], d[0]);
#pragma unroll
    for (int k = 1; k < NDIM; ++k) d2 = kf::add(d2, kf::mul(d[k], d[k]));
    return d2;
  } else if constexpr (NDIM == 3) {
    return d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  } else if constexpr (NDIM == 2) {
    return d[0] * d[0] + d[1] * d[1];
  } else {
    return d[0] * d[0];
  }
}

// wg, wp and 1/|dr| (0 for a coincident pair) of one star-gas pair
template <typename T, class KF>
__device__ __forceinline__ void pair_terms(const KF& kern, T d2, T hg, T hs,
                                           T& wg, T& wp, T& inv) {
  const bool zero = d2 == T(0);
  const T drmag = zero ? T(1) : sqrt(d2);
  inv = zero ? T(0) : T(1) / drmag;
  const T invh = T(1) / (T(0.5) * (hg + hs));
  const T s = drmag * invh;
  wg = kern.wgrav(s) * invh * invh;
  wp = kern.wpot(s) * invh;
}

template <typename T, int NDIM, class KF>
__global__ void __launch_bounds__(kTile) star_gas_gas_side(
    const T* __restrict__ rg, const T* __restrict__ hg, int n,
    const T* __restrict__ rs, const T* __restrict__ ms,
    const T* __restrict__ hs, const unsigned char* __restrict__ act, int ns,
    const KF kern, T* __restrict__ a_gas, T* __restrict__ gpot_gas) {
  __shared__ T sr[NDIM][kTile];
  __shared__ T sm[kTile], sh[kTile], sa[kTile];
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool live = i < n;
  T ri[NDIM], acc[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    ri[k] = live ? rg[static_cast<long long>(NDIM) * i + k] : T(0);
    acc[k] = T(0);
  }
  const T hi = live ? hg[i] : T(1);
  T pot = T(0);
  for (int j0 = 0; j0 < ns; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    if (j < ns) {
#pragma unroll
      for (int k = 0; k < NDIM; ++k) sr[k][threadIdx.x] = rs[NDIM * j + k];
      sm[threadIdx.x] = ms[j];
      sh[threadIdx.x] = hs[j];
      sa[threadIdx.x] = act[j] ? T(1) : T(0);
    }
    __syncthreads();
    const int nt = min(kTile, ns - j0);
    if (live) {
      for (int t = 0; t < nt; ++t) {
        T d[NDIM];
#pragma unroll
        for (int k = 0; k < NDIM; ++k) d[k] = sr[k][t] - ri[k];
        T wg, wp, inv;
        pair_terms(kern, norm2<T, NDIM, KF>(d), hi, sh[t], wg, wp, inv);
        const T w = sm[t] * wg * sa[t];
#pragma unroll
        for (int k = 0; k < NDIM; ++k) acc[k] += w * (d[k] * inv);
        pot += sm[t] * wp * sa[t];
      }
    }
    __syncthreads();
  }
  if (!live) return;
#pragma unroll
  for (int k = 0; k < NDIM; ++k)
    a_gas[static_cast<long long>(NDIM) * i + k] = acc[k];
  gpot_gas[i] = pot;
}

// partial star-side sums of slot tile blockIdx.x over gas chunk
// blockIdx.y: part[(chunk * ns + slot) * (NDIM + 1) + (a (NDIM), pot)]
template <typename T, int NDIM, class KF>
__global__ void __launch_bounds__(kWarp) star_gas_star_side(
    const T* __restrict__ rg, const T* __restrict__ mg,
    const T* __restrict__ hg, int n, const T* __restrict__ rs,
    const T* __restrict__ hs, int ns, const KF kern,
    T* __restrict__ part) {
  __shared__ T gr[NDIM][kWarp];
  __shared__ T gm[kWarp], gh[kWarp];
  const int j = blockIdx.x * kWarp + threadIdx.x;
  const bool live = j < ns;
  T rj[NDIM], acc[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    rj[k] = live ? rs[NDIM * j + k] : T(0);
    acc[k] = T(0);
  }
  const T hj = live ? hs[j] : T(1);
  T pot = T(0);
  const long long c0 = static_cast<long long>(blockIdx.y) * kChunk;
  const long long c1 = min(static_cast<long long>(n), c0 + kChunk);
  for (long long g0 = c0; g0 < c1; g0 += kWarp) {
    const long long g = g0 + threadIdx.x;
    if (g < c1) {
#pragma unroll
      for (int k = 0; k < NDIM; ++k) gr[k][threadIdx.x] = rg[NDIM * g + k];
      gm[threadIdx.x] = mg[g];
      gh[threadIdx.x] = hg[g];
    }
    __syncwarp();
    const int nt = static_cast<int>(min(static_cast<long long>(kWarp),
                                        c1 - g0));
    if (live) {
      for (int t = 0; t < nt; ++t) {
        T d[NDIM];
#pragma unroll
        for (int k = 0; k < NDIM; ++k) d[k] = rj[k] - gr[k][t];
        T wg, wp, inv;
        pair_terms(kern, norm2<T, NDIM, KF>(d), gh[t], hj, wg, wp, inv);
        const T w = gm[t] * wg;
#pragma unroll
        for (int k = 0; k < NDIM; ++k) acc[k] += w * (d[k] * inv);
        pot += gm[t] * wp;
      }
    }
    __syncwarp();
  }
  if (!live) return;
  T* out = part + (static_cast<long long>(blockIdx.y) * ns + j) * (NDIM + 1);
#pragma unroll
  for (int k = 0; k < NDIM; ++k) out[k] = acc[k];
  out[NDIM] = pot;
}

// each slot's sums over the chunks: block j, thread t adds chunks t,
// t + kFinish, ... in order, then a tree over the threads (a fixed order)
template <typename T, int NDIM>
__global__ void __launch_bounds__(kFinish) star_gas_star_finish(
    const T* __restrict__ part, int ns, int n_chunks, T* __restrict__ a_star,
    T* __restrict__ gpot_star) {
  constexpr int C = NDIM + 1;
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
  for (int k = 0; k < NDIM; ++k) a_star[NDIM * j + k] = -red[k][0];
  gpot_star[j] = red[NDIM][0];
}

template <typename T, int NDIM, class KF>
void launch_star_gas(const T* rg, const T* mg, const T* hg, int n,
                     const T* rs, const T* ms, const T* hs,
                     const unsigned char* act, int ns, const KF& kern,
                     T* part, T* a_gas, T* gpot_gas, T* a_star,
                     T* gpot_star, cudaStream_t stream) {
  if (n > 0)
    star_gas_gas_side<T, NDIM, KF><<<(n + kTile - 1) / kTile, kTile, 0,
                                     stream>>>(rg, hg, n, rs, ms, hs, act,
                                               ns, kern, a_gas, gpot_gas);
  if (ns > 0) {
    const int n_chunks = (n + kChunk - 1) / kChunk;
    if (n_chunks > 0) {
      const dim3 grid((ns + kWarp - 1) / kWarp, n_chunks);
      star_gas_star_side<T, NDIM, KF><<<grid, kWarp, 0, stream>>>(
          rg, mg, hg, n, rs, hs, ns, kern, part);
    }
    star_gas_star_finish<T, NDIM><<<ns, kFinish, 0, stream>>>(
        part, ns, n_chunks, a_star, gpot_star);
  }
}

// the softening kernel: `family` (kf::Family, not the gaussian) with its
// norm, tabulated at `res` points (0: direct)
template <typename T, int NDIM>
int run_star_gas(const T* rg, const T* mg, const T* hg, int n, const T* rs,
                 const T* ms, const T* hs, const unsigned char* act, int ns,
                 double norm, int family, int res, T* part, T* a_gas,
                 T* gpot_gas, T* a_star, T* gpot_star, int device,
                 void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool known = kf::with_kernel<T, true>(
      family, res, norm, NDIM, [&](const auto& kern) {
        launch_star_gas<T, NDIM>(rg, mg, hg, n, rs, ms, hs, act, ns, kern,
                                 part, a_gas, gpot_gas, a_star, gpot_star,
                                 stream);
      });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// star_gas_forces_{f32,f64} (3D), star_gas_forces_2d_*, star_gas_forces_1d_*
#define STAR_GAS_ENTRY(NAME, ND, SFX, T)                                    \
  int NAME##_##SFX(const T* rg, const T* mg, const T* hg, int n,            \
                   const T* rs, const T* ms, const T* hs,                   \
                   const unsigned char* act, int ns, double norm,           \
                   int family, int res, T* part, T* a_gas, T* gpot_gas,     \
                   T* a_star, T* gpot_star, int device, void* stream) {     \
    return run_star_gas<T, ND>(rg, mg, hg, n, rs, ms, hs, act, ns, norm,    \
                               family, res, part, a_gas, gpot_gas, a_star,  \
                               gpot_star, device, stream);                  \
  }

STAR_GAS_ENTRY(star_gas_forces, 3, f32, float)
STAR_GAS_ENTRY(star_gas_forces, 3, f64, double)
STAR_GAS_ENTRY(star_gas_forces_2d, 2, f32, float)
STAR_GAS_ENTRY(star_gas_forces_2d, 2, f64, double)
STAR_GAS_ENTRY(star_gas_forces_1d, 1, f32, float)
STAR_GAS_ENTRY(star_gas_forces_1d, 1, f64, double)

}  // extern "C"
