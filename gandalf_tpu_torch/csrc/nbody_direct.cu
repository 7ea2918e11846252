// K13 direct_nbody, K14 direct_softened, K15 direct_snap: direct-summation
// gravity over all pairs of stars, in 2D or 3D (K14 also in 1D, for the
// star-star pull of a 1D run with sinks).
//
// Replaces gandalf_tpu/ops/gravity.py:direct_nbody (:30), direct_softened
// (:86) and direct_snap (:60), which build (N, N, ndim) pair arrays and
// reduce them along the source axis.
//
// Bound on the card: arithmetic.  Each pass reads O(N) values and does
// O(N^2) pair work: at 65,536 stars, 4.3e9 pairs, each with a square root
// and one (K13, K15) to four (K14: 1/|dr|, 1/hbar and the softening
// kernel's 1/s and 1/s^2 beyond the support) divisions, which in float64
// are multi-instruction sequences on the FP64 units.
//
// Design: the classic tiled all-pairs loop.  One thread per target star
// keeps its position (velocity, softening length, acceleration) and its
// sums in registers; a block of kTile threads stages kTile source stars
// at a time in shared memory and every thread sweeps the tile.  One write
// per target, no atomics, and a fixed order of the sums, so results are
// deterministic.  Pairs are masked as in the JAX package: the self pair by
// identity (j == i) and coincident distinct pairs by d^2 == 0, with no
// distance floor (collapsed sub-system members share one position).  The
// arithmetic follows the JAX formulas term by term: K13 forms 1/sqrt(d^2),
// K15 1/d^2 and then its square root, K14 the softening kernel's wgrav and
// wpot at s = |dr|/hbar with the Newtonian jerk (fault F9, kept for
// parity).  K14's kernel is kernel_family.cuh's Kernel<T, FAM, TAB> (M4
// or the quintic, direct or tabulated; the gaussian has no softened
// gravity, fault F23, and is not instantiated); any kernel but the direct
// M4 sums d^2 in the plain version's rounded steps (kExactD2), so that s,
// and a table index, are the plain version's.  No intrinsics in either
// precision: sqrt and division are IEEE (the library is built without
// --use_fast_math), so float32 uses no rsqrtf or __fdividef either.
// Split-j for small N, warp shuffles and mixed-precision sums are later
// work.
#include <cuda_runtime.h>

#include "kernel_family.cuh"

namespace {

constexpr int kTile = 128;

// K13: a, gpot and (JERK) adot of every star.
template <typename T, int ND, bool JERK>
__global__ void __launch_bounds__(kTile) direct_nbody_kernel(
    const T* __restrict__ r, const T* __restrict__ v,
    const T* __restrict__ m, int n, T* __restrict__ a_out,
    T* __restrict__ adot_out, T* __restrict__ gpot_out) {
  __shared__ T sr[ND][kTile];
  __shared__ T sv[ND][kTile];
  __shared__ T sm[kTile];
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool live = i < n;
  T ri[ND], vi[ND], acc[ND], jerk[ND];
  for (int k = 0; k < ND; ++k) {
    ri[k] = live ? r[i * ND + k] : T(0);
    vi[k] = (JERK && live) ? v[i * ND + k] : T(0);
    acc[k] = jerk[k] = T(0);
  }
  T pot = T(0);
  for (int j0 = 0; j0 < n; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    if (j < n) {
      for (int k = 0; k < ND; ++k) {
        sr[k][threadIdx.x] = r[j * ND + k];
        if (JERK) sv[k][threadIdx.x] = v[j * ND + k];
      }
      sm[threadIdx.x] = m[j];
    }
    __syncthreads();
    const int nt = min(kTile, n - j0);
    if (live) {
      for (int t = 0; t < nt; ++t) {
        if (j0 + t == i) continue;
        T dr[ND];
        T drsqd = T(0);
        for (int k = 0; k < ND; ++k) {
          dr[k] = sr[k][t] - ri[k];
          drsqd += dr[k] * dr[k];
        }
        if (drsqd == T(0)) continue;
        const T inv_dr = T(1) / sqrt(drsqd);
        const T w = sm[t] * (inv_dr * inv_dr * inv_dr);
        for (int k = 0; k < ND; ++k) acc[k] += w * dr[k];
        pot += sm[t] * inv_dr;
        if (JERK) {
          T dv[ND];
          T drdv = T(0);
          for (int k = 0; k < ND; ++k) {
            dv[k] = sv[k][t] - vi[k];
            drdv += dr[k] * dv[k];
          }
          const T q = T(3) * drdv * inv_dr * inv_dr;
          for (int k = 0; k < ND; ++k) jerk[k] += w * (dv[k] - q * dr[k]);
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;
  for (int k = 0; k < ND; ++k) {
    a_out[i * ND + k] = acc[k];
    if (JERK) adot_out[i * ND + k] = jerk[k];
  }
  gpot_out[i] = pot;
}

// K14: mean-h kernel-softened a and gpot, and (JERK) the Newtonian adot.
template <typename T, int ND, bool JERK, class KF>
__global__ void __launch_bounds__(kTile) direct_softened_kernel(
    const T* __restrict__ r, const T* __restrict__ v,
    const T* __restrict__ m, const T* __restrict__ h, int n, const KF kern,
    T* __restrict__ a_out, T* __restrict__ adot_out,
    T* __restrict__ gpot_out) {
  __shared__ T sr[ND][kTile];
  __shared__ T sv[ND][kTile];
  __shared__ T sm[kTile];
  __shared__ T sh[kTile];
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool live = i < n;
  T ri[ND], vi[ND], acc[ND], jerk[ND];
  for (int k = 0; k < ND; ++k) {
    ri[k] = live ? r[i * ND + k] : T(0);
    vi[k] = (JERK && live) ? v[i * ND + k] : T(0);
    acc[k] = jerk[k] = T(0);
  }
  const T hi = live ? h[i] : T(0);
  T pot = T(0);
  for (int j0 = 0; j0 < n; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    if (j < n) {
      for (int k = 0; k < ND; ++k) {
        sr[k][threadIdx.x] = r[j * ND + k];
        if (JERK) sv[k][threadIdx.x] = v[j * ND + k];
      }
      sm[threadIdx.x] = m[j];
      sh[threadIdx.x] = h[j];
    }
    __syncthreads();
    const int nt = min(kTile, n - j0);
    if (live) {
      for (int t = 0; t < nt; ++t) {
        if (j0 + t == i) continue;
        T dr[ND];
        T drsqd = T(0);
        for (int k = 0; k < ND; ++k) {
          dr[k] = sr[k][t] - ri[k];
          if (KF::kExactD2)
            drsqd = kf::add(drsqd, kf::mul(dr[k], dr[k]));
          else
            drsqd += dr[k] * dr[k];
        }
        if (drsqd == T(0)) continue;
        const T drmag = sqrt(drsqd);
        const T inv_drmag = T(1) / drmag;
        const T invh = T(1) / (T(0.5) * (hi + sh[t]));
        const T s = drmag * invh;
        const T w = sm[t] * (kern.wgrav(s) * invh * invh);
        for (int k = 0; k < ND; ++k) acc[k] += w * (dr[k] * inv_drmag);
        pot += sm[t] * kern.wpot(s) * invh;
        if (JERK) {
          T dv[ND];
          T drdv = T(0);
          for (int k = 0; k < ND; ++k) {
            dv[k] = sv[k][t] - vi[k];
            drdv += dr[k] * dv[k];
          }
          const T wj = sm[t] * (inv_drmag * inv_drmag * inv_drmag);
          const T q = T(3) * drdv * inv_drmag * inv_drmag;
          for (int k = 0; k < ND; ++k) jerk[k] += wj * (dv[k] - q * dr[k]);
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;
  for (int k = 0; k < ND; ++k) {
    a_out[i * ND + k] = acc[k];
    if (JERK) adot_out[i * ND + k] = jerk[k];
  }
  gpot_out[i] = pot;
}

// K15: the snap of every star from r, v and the current a.
template <typename T, int ND>
__global__ void __launch_bounds__(kTile) direct_snap_kernel(
    const T* __restrict__ r, const T* __restrict__ v,
    const T* __restrict__ a, const T* __restrict__ m, int n,
    T* __restrict__ snap_out) {
  __shared__ T sr[ND][kTile];
  __shared__ T sv[ND][kTile];
  __shared__ T sa[ND][kTile];
  __shared__ T sm[kTile];
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool live = i < n;
  T ri[ND], vi[ND], ai[ND], snap[ND];
  for (int k = 0; k < ND; ++k) {
    ri[k] = live ? r[i * ND + k] : T(0);
    vi[k] = live ? v[i * ND + k] : T(0);
    ai[k] = live ? a[i * ND + k] : T(0);
    snap[k] = T(0);
  }
  for (int j0 = 0; j0 < n; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    if (j < n) {
      for (int k = 0; k < ND; ++k) {
        sr[k][threadIdx.x] = r[j * ND + k];
        sv[k][threadIdx.x] = v[j * ND + k];
        sa[k][threadIdx.x] = a[j * ND + k];
      }
      sm[threadIdx.x] = m[j];
    }
    __syncthreads();
    const int nt = min(kTile, n - j0);
    if (live) {
      for (int t = 0; t < nt; ++t) {
        if (j0 + t == i) continue;
        T dr[ND], dv[ND], da[ND];
        T drsqd = T(0), drdv = T(0), dvsqd = T(0), drda = T(0);
        for (int k = 0; k < ND; ++k) {
          dr[k] = sr[k][t] - ri[k];
          dv[k] = sv[k][t] - vi[k];
          da[k] = sa[k][t] - ai[k];
          drsqd += dr[k] * dr[k];
        }
        if (drsqd == T(0)) continue;
        for (int k = 0; k < ND; ++k) {
          drdv += dr[k] * dv[k];
          dvsqd += dv[k] * dv[k];
          drda += dr[k] * da[k];
        }
        const T inv_r2 = T(1) / drsqd;
        const T inv_r = sqrt(inv_r2);
        const T inv_r3 = inv_r2 * inv_r;
        const T alpha = drdv * inv_r2;
        const T beta = (dvsqd + drda) * inv_r2 + alpha * alpha;
        const T c3a = T(3) * alpha * inv_r3;
        const T c6a = T(6) * alpha;
        const T c3b = T(3) * beta * inv_r3;
        for (int k = 0; k < ND; ++k) {
          const T jterm = dv[k] * inv_r3 - c3a * dr[k];
          snap[k] += sm[t] * (da[k] * inv_r3 - c6a * jterm - c3b * dr[k]);
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;
  for (int k = 0; k < ND; ++k) snap_out[i * ND + k] = snap[k];
}

int blocks_for(int n) { return (n + kTile - 1) / kTile; }

// ndim 2 or 3; with `one_d` also 1
cudaError_t prepare(int device, int ndim, bool one_d = false) {
  if (ndim != 2 && ndim != 3 && !(one_d && ndim == 1))
    return cudaErrorInvalidValue;
  return cudaSetDevice(device);
}

template <typename T>
int run_nbody(const T* r, const T* v, const T* m, int n, int ndim,
              int jerk, T* a, T* adot, T* gpot, int device,
              void* stream_ptr) {
  cudaError_t err = prepare(device, ndim);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n > 0) {
    const int b = blocks_for(n);
    if (ndim == 3 && jerk)
      direct_nbody_kernel<T, 3, true><<<b, kTile, 0, stream>>>(
          r, v, m, n, a, adot, gpot);
    else if (ndim == 3)
      direct_nbody_kernel<T, 3, false><<<b, kTile, 0, stream>>>(
          r, v, m, n, a, adot, gpot);
    else if (jerk)
      direct_nbody_kernel<T, 2, true><<<b, kTile, 0, stream>>>(
          r, v, m, n, a, adot, gpot);
    else
      direct_nbody_kernel<T, 2, false><<<b, kTile, 0, stream>>>(
          r, v, m, n, a, adot, gpot);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, class KF>
void launch_softened(const T* r, const T* v, const T* m, const T* h, int n,
                     int ndim, int jerk, const KF& kern, T* a, T* adot,
                     T* gpot, cudaStream_t stream) {
  const int b = blocks_for(n);
  if (ndim == 3 && jerk)
    direct_softened_kernel<T, 3, true, KF><<<b, kTile, 0, stream>>>(
        r, v, m, h, n, kern, a, adot, gpot);
  else if (ndim == 3)
    direct_softened_kernel<T, 3, false, KF><<<b, kTile, 0, stream>>>(
        r, v, m, h, n, kern, a, adot, gpot);
  else if (ndim == 2 && jerk)
    direct_softened_kernel<T, 2, true, KF><<<b, kTile, 0, stream>>>(
        r, v, m, h, n, kern, a, adot, gpot);
  else if (ndim == 2)
    direct_softened_kernel<T, 2, false, KF><<<b, kTile, 0, stream>>>(
        r, v, m, h, n, kern, a, adot, gpot);
  else if (jerk)
    direct_softened_kernel<T, 1, true, KF><<<b, kTile, 0, stream>>>(
        r, v, m, h, n, kern, a, adot, gpot);
  else
    direct_softened_kernel<T, 1, false, KF><<<b, kTile, 0, stream>>>(
        r, v, m, h, n, kern, a, adot, gpot);
}

// the softening kernel: `family` (kf::Family, not the gaussian) with its
// norm, tabulated at `res` points (0: direct)
template <typename T>
int run_softened(const T* r, const T* v, const T* m, const T* h, int n,
                 int ndim, int jerk, double norm, int family, int res,
                 T* a, T* adot, T* gpot, int device, void* stream_ptr) {
  cudaError_t err = prepare(device, ndim, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool known = kf::with_kernel<T, true>(
      family, res, norm, ndim, [&](const auto& kern) {
        if (n > 0)
          launch_softened<T>(r, v, m, h, n, ndim, jerk, kern, a, adot, gpot,
                             stream);
      });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_snap(const T* r, const T* v, const T* a, const T* m, int n,
             int ndim, T* snap, int device, void* stream_ptr) {
  cudaError_t err = prepare(device, ndim);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n > 0) {
    const int b = blocks_for(n);
    if (ndim == 3)
      direct_snap_kernel<T, 3><<<b, kTile, 0, stream>>>(r, v, a, m, n, snap);
    else
      direct_snap_kernel<T, 2><<<b, kTile, 0, stream>>>(r, v, a, m, n, snap);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define NBODY_ENTRIES(SFX, T)                                                \
  int direct_nbody_##SFX(const T* r, const T* v, const T* m, int n,         \
                         int ndim, int jerk, T* a, T* adot, T* gpot,         \
                         int device, void* stream) {                         \
    return run_nbody<T>(r, v, m, n, ndim, jerk, a, adot, gpot, device,      \
                        stream);                                             \
  }                                                                          \
  int direct_softened_##SFX(const T* r, const T* v, const T* m, const T* h, \
                            int n, int ndim, int jerk, double norm,          \
                            int family, int res, T* a, T* adot, T* gpot,     \
                            int device, void* stream) {                      \
    return run_softened<T>(r, v, m, h, n, ndim, jerk, norm, family, res, a, \
                           adot, gpot, device, stream);                      \
  }                                                                          \
  int direct_snap_##SFX(const T* r, const T* v, const T* a, const T* m,     \
                        int n, int ndim, T* snap, int device,                \
                        void* stream) {                                      \
    return run_snap<T>(r, v, a, m, n, ndim, snap, device, stream);          \
  }

NBODY_ENTRIES(f32, float)
NBODY_ENTRIES(f64, double)

}  // extern "C"
