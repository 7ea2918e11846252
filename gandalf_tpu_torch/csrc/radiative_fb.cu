// K30 ambient_temperature: the radiative-feedback ambient temperature of
// every particle from every sink slot, and the disc profile about the
// central slots, in 1-3 dims (NDIM a template parameter).
//
// Replaces gandalf_tpu/ops/radiative_fb.py:combined_ambient_temperature
// (:92), with ambient_temperature (:53) and disc_ambient_t4 (:81), which
// build (N, Ns) pair arrays and reduce them over the slots:
//   T^4 = T_inf^4 + sum_{s active, s >= n_central} 0.25 r_src_s^2
//         / max(d_is^2, 1e-30) T_sink_s^4
//       + sum_{s < n_central, s active} temp_au^4 (dmid_is^2 + rsmooth^2)
//         ^(-2 q)
//   T_amb = (T^4)^(1/4),
// with d the separation over the NDIM dims and dmid its part over the
// first min(2, NDIM) (x, y in 2D and 3D, x in 1D).  The per-slot
// factors q_s = 0.25 r_src^2 and T_sink^4 (from the accretion luminosity)
// are an O(Ns) torch pass in the wrapper; the sink sum's mask (active
// and, with disc heating, past the central slots) and the disc's (active
// alone) come in as bytes.
//
// Bound on the card: operations.  N x Ns pairs, each a separation, d^2, a
// division and a multiply-add, on 3 + 2 values a particle and 6 a slot;
// at 262,144 particles and 4,096 slots (K16's embedded cluster) 1.1e9
// pairs.  check.FLOPS_PER counts the active pairs and the inactive ones'
// test.
//
// Design: K16's gas side.  One thread a particle with its sum in a
// register; the slots staged in shared memory kTile at a time (their NDIM
// coordinates, q, T_sink^4 and the mask), so a warp reads each slot once from shared
// memory as a broadcast.  The pair follows the JAX formula term by term
// (d^2 summed in axis order; q / max(d^2, 1e-30) times T_sink^4; no fused
// multiply-add where a product meets a sum); the slot sum runs in slot
// order, where the plain version's torch.sum may pair the terms otherwise.
// IEEE division, pow for the disc and the fourth root.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// squared separation of a particle's first K coordinates xi from a slot's
// (x, y, z in sx[0..K-1][t]), summed in axis order without contraction
template <typename T, int K, int NDIM>
__device__ __forceinline__ T sep2(const T (&xi)[NDIM],
                                  const T (&sx)[NDIM][kTile], int t) {
  const T d0 = xi[0] - sx[0][t];
  T d2 = mul_rn(d0, d0);
#pragma unroll
  for (int k = 1; k < K; ++k) {
    const T dk = xi[k] - sx[k][t];
    d2 = d2 + mul_rn(dk, dk);
  }
  return d2;
}

template <typename T, int NDIM>
__global__ void __launch_bounds__(kTile) ambient_kernel(
    const T* __restrict__ r, int n, const T* __restrict__ rs,
    const T* __restrict__ q, const T* __restrict__ ts4,
    const unsigned char* __restrict__ act, int ns, T tinf4, int n_central,
    const unsigned char* __restrict__ disc_act, T tau4, T rsmooth2, T expo,
    T* __restrict__ out) {
  // the disc's midplane: the first min(2, NDIM) coordinates
  constexpr int kMid = NDIM < 2 ? NDIM : 2;
  __shared__ T sx[NDIM][kTile];
  __shared__ T sq[kTile], st[kTile];
  __shared__ unsigned char sa[kTile];
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool live = i < n;
  T xi[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k)
    xi[k] = live ? r[static_cast<long long>(NDIM) * i + k] : T(0);
  T acc = T(0);
  for (int j0 = 0; j0 < ns; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    if (j < ns) {
#pragma unroll
      for (int k = 0; k < NDIM; ++k) sx[k][threadIdx.x] = rs[NDIM * j + k];
      sq[threadIdx.x] = q[j];
      st[threadIdx.x] = ts4[j];
      sa[threadIdx.x] = act[j];
    }
    __syncthreads();
    const int nt = min(kTile, ns - j0);
    if (live) {
      for (int t = 0; t < nt; ++t) {
        if (!sa[t]) continue;
        const T d2 = sep2<T, NDIM, NDIM>(xi, sx, t);
        acc = acc + mul_rn(sq[t] / fmax(d2, T(1e-30)), st[t]);
      }
    }
    __syncthreads();
  }
  if (!live) return;
  T t4 = tinf4 + acc;
  if (n_central > 0) {
    T disc = T(0);
    for (int s = 0; s < n_central; ++s) {
      if (!disc_act[s]) continue;
      const T d0 = xi[0] - rs[NDIM * s];
      T d2 = mul_rn(d0, d0);
      if constexpr (kMid == 2) {
        const T d1 = xi[kMid - 1] - rs[NDIM * s + kMid - 1];
        d2 = d2 + mul_rn(d1, d1);
      }
      disc = disc + mul_rn(tau4, pow(d2 + rsmooth2, expo));
    }
    t4 = t4 + disc;
  }
  out[i] = pow(t4, T(0.25));
}

template <typename T, int NDIM>
void ambient_launch(const T* r, int n, const T* rs, const T* q, const T* ts4,
                    const unsigned char* act, int ns, double tinf4,
                    int n_central, const unsigned char* disc_act,
                    double tau4, double rsmooth2, double expo, T* out,
                    cudaStream_t stream) {
  ambient_kernel<T, NDIM><<<(n + kTile - 1) / kTile, kTile, 0, stream>>>(
      r, n, rs, q, ts4, act, ns, static_cast<T>(tinf4), n_central, disc_act,
      static_cast<T>(tau4), static_cast<T>(rsmooth2), static_cast<T>(expo),
      out);
}

// nd: the positions' dims (1-3), NDIM of the kernel launched
template <typename T>
int ambient_entry(const T* r, int n, int nd, const T* rs, const T* q,
                  const T* ts4, const unsigned char* act, int ns,
                  double tinf4, int n_central,
                  const unsigned char* disc_act, double tau4,
                  double rsmooth2, double expo, T* out, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nd < 1 || nd > 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    if (nd == 3)
      ambient_launch<T, 3>(r, n, rs, q, ts4, act, ns, tinf4, n_central,
                           disc_act, tau4, rsmooth2, expo, out, st);
    else if (nd == 2)
      ambient_launch<T, 2>(r, n, rs, q, ts4, act, ns, tinf4, n_central,
                           disc_act, tau4, rsmooth2, expo, out, st);
    else
      ambient_launch<T, 1>(r, n, rs, q, ts4, act, ns, tinf4, n_central,
                           disc_act, tau4, rsmooth2, expo, out, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define AMBIENT_ENTRY(SFX, T)                                               \
  int ambient_temperature_##SFX(                                            \
      const T* r, int n, int nd, const T* rs, const T* q, const T* ts4,     \
      const unsigned char* act, int ns, double tinf4, int n_central,        \
      const unsigned char* disc_act, double tau4, double rsmooth2,          \
      double expo, T* out, int device, void* stream) {                      \
    return ambient_entry<T>(r, n, nd, rs, q, ts4, act, ns, tinf4,           \
                            n_central, disc_act, tau4, rsmooth2, expo, out, \
                            device, stream);                                \
  }

AMBIENT_ENTRY(f32, float)
AMBIENT_ENTRY(f64, double)

}  // extern "C"
