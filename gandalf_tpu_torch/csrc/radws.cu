// K27 radws_eos, K28 radws_equilibrium and K29 radws_implicit_heating:
// the RadWS opacity-table passes, one thread per element.
//
// Replaces gandalf_tpu/ops/radws.py:temp_from_u (:133) through
// gandalf_tpu/ops/eos.py:Radws._gamma_of (:199) and thermal_update (K27),
// energy_find_equi (:156) with radws_col2 (:217) fused in (K28), and
// radws_implicit_heating (:229) with radws_col2 fused in (K29).  Each is
// a chain of nearest-index table gathers:
//   idens  = closest(log_dens, log10(max(rho, 1e-30)))
//   T(u)   = 10^log_temp[ii], ii the nearer of it - 1 and it, with it the
//            count of the row energy[idens, :] below u clipped to
//            [1, nt-1] (a count, not a binary search: a row that is not
//            monotone gives another index under a search);
//   itemp  = closest(log_temp, log10(max(T, 1e-30)))
// with closest() a lower-bound search clipped to [1, n-1] that takes the
// upper neighbour only where it is strictly nearer.
// K27: gamma at (idens, itemp(T(u))), P = (gamma-1) rho u and
//   c = sqrt(gamma (gamma-1) u).
// K28: col2 = fcol2 max(gpot, 0) rho; f(T) = dudt - 4 sigma (T^4 -
//   T_amb^4) / (col2 kappa + 1/kappa_p) at itemp(T); 30 bisection steps
//   on log T over [T_min, 10^log_temp[nt-1]] keeping the upper half where
//   f(mid) > 0, the clamps f(T_min) <= 0 -> T_min before f(top) >= 0 ->
//   top; ueq = energy[idens, itemp(T_eq)]; dt_therm = (ueq - u) / (dudt +
//   rate at T(u)) where |denom| > 1e-30, else 1e30, and 1e30 where
//   negative.  T_amb is a scalar or per element (radiative feedback).
// K29: g(T) = T / (mu (gamma-1)) - u - dt ebalance(T), 40 steps keeping
//   the upper half where g(mid) < 0, the rate at the root or, where g
//   keeps its sign, at the edge (T_min where g(T_min) >= 0, else the top
//   where g(top) <= 0).
// The optional int32 index output records where each result was read:
// K27 idens nt + itemp; K28 ((idens nt + it_eq) nt + it_now) 3 + branch;
// K29 (idens nt + it) 3 + branch (branch 0 root, 1 T_min, 2 top).
//
// Bound on the card: operations, but little of either.  An element reads
// 2 to 5 values and writes 2 (plus the index); the table (nd x nt entries
// of 7 arrays, 7 KB for the 8 x 128 synthetic table) stays in L1/L2.  K27
// does about 2 nt compares of the row count plus two searches; K28 and K29
// repeat a pow, a log10, a binary search of the nt temperatures and two or
// four gathers 32 and 42 times.  check.FLOPS_PER counts them.
//
// Design: a grid-stride loop, one element a thread, the table read
// through the read-only path from global memory (it sits in L1/L2 after
// the first warps).  The arithmetic follows the JAX formulas in the same
// rounded steps: no fused multiply-add where a product meets a sum (the
// products are __fmul_rn / __dmul_rn), IEEE division and square root (no
// fast-math), log10 and pow as torch's CUDA build calls them, so the plain
// version on the card reads the same indices.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFindIter = 30;
constexpr int kImplicitIter = 40;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// x^4 as (x x)(x x), the JAX package's integer power
template <typename T>
__device__ __forceinline__ T pow4(T x) {
  const T x2 = mul_rn(x, x);
  return mul_rn(x2, x2);
}

template <typename T>
struct Table {
  const T* log_dens;
  const T* log_temp;
  const T* energy;
  const T* mu;
  const T* kappa;
  const T* kappap;
  const T* gamma;
  int nd, nt;
  T fcol2, four_rad_const, temp_min;
};

// nearest grid index: lower bound of x, clipped to [1, n-1], then the
// upper neighbour where it is strictly nearer
template <typename T>
__device__ __forceinline__ int closest(const T* __restrict__ g, int n, T x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(g + mid) < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  const int h = min(max(lo, 1), n - 1);
  const int l = h - 1;
  return (x - __ldg(g + l)) > (__ldg(g + h) - x) ? h : l;
}

template <typename T>
__device__ __forceinline__ int idens_of(const Table<T>& tb, T rho) {
  return closest(tb.log_dens, tb.nd, log10(fmax(rho, T(1e-30))));
}

template <typename T>
__device__ __forceinline__ int itemp_of(const Table<T>& tb, T temp) {
  return closest(tb.log_temp, tb.nt, log10(fmax(temp, T(1e-30))));
}

// T(u) at density row idens: the count of the row below u
template <typename T>
__device__ __forceinline__ T temp_from_u(const Table<T>& tb, int idens, T u) {
  const T* __restrict__ row = tb.energy + static_cast<long long>(idens) * tb.nt;
  int it = 0;
  for (int j = 0; j < tb.nt; ++j) it += __ldg(row + j) < u ? 1 : 0;
  it = min(max(it, 1), tb.nt - 1);
  const int lo = it - 1;
  const T u_lo = __ldg(row + lo), u_hi = __ldg(row + it);
  const int ii = (u - u_lo) > (u_hi - u) ? it : lo;
  return pow(T(10), __ldg(tb.log_temp + ii));
}

// dudt - 4 sigma (T^4 - T_amb^4) / (col2 kappa + 1 / kappa_p)
template <typename T>
__device__ __forceinline__ T ebalance(const Table<T>& tb, T dudt, T tamb4,
                                      T temp, T kap, T kp, T col2) {
  return dudt - mul_rn(tb.four_rad_const, pow4(temp) - tamb4) /
                    (mul_rn(col2, kap) + T(1) / kp);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    radws_eos_kernel(Table<T> tb, const T* __restrict__ rho,
                     const T* __restrict__ u, long long n, T* __restrict__ P,
                     T* __restrict__ c, int* __restrict__ index) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const T r = rho[i], ui = u[i];
    const int id = idens_of(tb, r);
    const int it = itemp_of(tb, temp_from_u(tb, id, ui));
    const long long k = static_cast<long long>(id) * tb.nt + it;
    const T g = __ldg(tb.gamma + k);
    const T gm1 = g - T(1);
    P[i] = mul_rn(gm1, r) * ui;
    c[i] = sqrt(mul_rn(g, gm1) * ui);
    if (index) index[i] = static_cast<int>(k);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) radws_equilibrium_kernel(
    Table<T> tb, const T* __restrict__ rho, const T* __restrict__ u,
    const T* __restrict__ dudt, const T* __restrict__ gpot,
    const T* __restrict__ tamb, int tamb_per_element, long long n,
    T* __restrict__ ueq, T* __restrict__ dt_therm, int* __restrict__ index) {
  const int nt = tb.nt;
  const T t_lo = tb.temp_min;
  const T t_hi = pow(T(10), __ldg(tb.log_temp + nt - 1));
  const T log_lo = log10(t_lo), log_hi = log10(t_hi);
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const T r = rho[i], ui = u[i], du = dudt[i];
    const T col2 = mul_rn(tb.fcol2, fmax(gpot[i], T(0))) * r;
    const T tamb4 = pow4(tamb[tamb_per_element ? i : 0]);
    const int id = idens_of(tb, r);
    const long long row = static_cast<long long>(id) * nt;
    const T temp = temp_from_u(tb, id, ui);
    auto f_of = [&](T t) {
      const int it = itemp_of(tb, t);
      return ebalance(tb, du, tamb4, t, __ldg(tb.kappa + row + it),
                      __ldg(tb.kappap + row + it), col2);
    };
    const T f_lo = f_of(t_lo), f_hi = f_of(t_hi);
    T lo = log_lo, hi = log_hi;
    for (int s = 0; s < kFindIter; ++s) {
      const T mid = T(0.5) * (lo + hi);
      if (f_of(pow(T(10), mid)) > T(0))
        lo = mid;
      else
        hi = mid;
    }
    const int branch = f_lo <= T(0) ? 1 : (f_hi >= T(0) ? 2 : 0);
    T tequi = pow(T(10), T(0.5) * (lo + hi));
    tequi = branch == 1 ? t_lo : (branch == 2 ? t_hi : tequi);
    const int it_eq = itemp_of(tb, tequi);
    const T ue = __ldg(tb.energy + row + it_eq);
    const int it_now = itemp_of(tb, temp);
    const T rate = ebalance(tb, T(0), tamb4, temp,
                            __ldg(tb.kappa + row + it_now),
                            __ldg(tb.kappap + row + it_now), col2);
    const T denom = du + rate;
    T dtt = fabs(denom) > T(1e-30)
                ? (ue - ui) / (denom == T(0) ? T(1) : denom)
                : T(1e30);
    dtt = dtt < T(0) ? T(1e30) : dtt;
    ueq[i] = ue;
    dt_therm[i] = dtt;
    if (index)
      index[i] =
          static_cast<int>(((row + it_eq) * nt + it_now) * 3 + branch);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) radws_implicit_kernel(
    Table<T> tb, const T* __restrict__ rho, const T* __restrict__ u,
    const T* __restrict__ dudt, const T* __restrict__ gpot,
    const T* __restrict__ dt, int dt_per_element,
    const T* __restrict__ tamb, int tamb_per_element, long long n,
    T* __restrict__ heat_out, int* __restrict__ index) {
  const int nt = tb.nt;
  const T t_lo = tb.temp_min;
  const T t_hi = pow(T(10), __ldg(tb.log_temp + nt - 1));
  const T log_lo = log10(t_lo), log_hi = log10(t_hi);
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const T r = rho[i], ui = u[i], du = dudt[i];
    const T dti = dt[dt_per_element ? i : 0];
    const T col2 = mul_rn(tb.fcol2, fmax(gpot[i], T(0))) * r;
    const T tamb4 = pow4(tamb[tamb_per_element ? i : 0]);
    const int id = idens_of(tb, r);
    const long long row = static_cast<long long>(id) * nt;
    // g(T) and the rate there, at the temperature index it
    auto g_of = [&](T t, T& heat, int& it) {
      it = itemp_of(tb, t);
      heat = ebalance(tb, du, tamb4, t, __ldg(tb.kappa + row + it),
                      __ldg(tb.kappap + row + it), col2);
      const T u_t = t / mul_rn(__ldg(tb.mu + row + it),
                               __ldg(tb.gamma + row + it) - T(1));
      return (u_t - ui) - mul_rn(dti, heat);
    };
    T h_lo, h_hi, h_mid;
    int it_lo, it_hi, it_mid;
    const T g_lo = g_of(t_lo, h_lo, it_lo);
    const T g_hi = g_of(t_hi, h_hi, it_hi);
    T lo = log_lo, hi = log_hi;
    for (int s = 0; s < kImplicitIter; ++s) {
      const T mid = T(0.5) * (lo + hi);
      if (g_of(pow(T(10), mid), h_mid, it_mid) < T(0))
        lo = mid;
      else
        hi = mid;
    }
    g_of(pow(T(10), T(0.5) * (lo + hi)), h_mid, it_mid);
    const int branch = g_lo >= T(0) ? 1 : (g_hi <= T(0) ? 2 : 0);
    heat_out[i] = branch == 1 ? h_lo : (branch == 2 ? h_hi : h_mid);
    if (index) {
      const int it = branch == 1 ? it_lo : (branch == 2 ? it_hi : it_mid);
      index[i] = static_cast<int>((row + it) * 3 + branch);
    }
  }
}

template <typename T>
Table<T> make_table(const T* log_dens, const T* log_temp, const T* energy,
                    const T* mu, const T* kappa, const T* kappap,
                    const T* gamma, int nd, int nt, double fcol2,
                    double four_rad_const, double temp_min) {
  return Table<T>{log_dens, log_temp, energy, mu, kappa, kappap, gamma, nd,
                  nt, static_cast<T>(fcol2), static_cast<T>(four_rad_const),
                  static_cast<T>(temp_min)};
}

int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 65535LL * 16 ? blocks : 65535LL * 16);
}

}  // namespace

extern "C" {

#define RADWS_TABLE_ARGS(T)                                                 \
  const T *log_dens, const T *log_temp, const T *energy, const T *mu,       \
      const T *kappa, const T *kappap, const T *gamma, int nd, int nt,      \
      double fcol2, double four_rad_const, double temp_min
#define RADWS_TABLE(T)                                                      \
  make_table<T>(log_dens, log_temp, energy, mu, kappa, kappap, gamma, nd,   \
                nt, fcol2, four_rad_const, temp_min)

#define RADWS_ENTRIES(SFX, T)                                               \
  int radws_eos_##SFX(RADWS_TABLE_ARGS(T), const T* rho, const T* u,        \
                      long long n, T* P, T* c, int* index, int device,      \
                      void* stream) {                                       \
    cudaError_t err = cudaSetDevice(device);                                \
    if (err != cudaSuccess) return static_cast<int>(err);                   \
    if (n > 0)                                                              \
      radws_eos_kernel<T><<<grid_for(n), kThreads, 0,                       \
                            static_cast<cudaStream_t>(stream)>>>(           \
          RADWS_TABLE(T), rho, u, n, P, c, index);                          \
    return static_cast<int>(cudaGetLastError());                            \
  }                                                                         \
  int radws_equilibrium_##SFX(RADWS_TABLE_ARGS(T), const T* rho,            \
                              const T* u, const T* dudt, const T* gpot,     \
                              const T* tamb, int tamb_per_element,          \
                              long long n, T* ueq, T* dt_therm, int* index, \
                              int device, void* stream) {                   \
    cudaError_t err = cudaSetDevice(device);                                \
    if (err != cudaSuccess) return static_cast<int>(err);                   \
    if (n > 0)                                                              \
      radws_equilibrium_kernel<T><<<grid_for(n), kThreads, 0,               \
                                    static_cast<cudaStream_t>(stream)>>>(   \
          RADWS_TABLE(T), rho, u, dudt, gpot, tamb, tamb_per_element, n,    \
          ueq, dt_therm, index);                                            \
    return static_cast<int>(cudaGetLastError());                            \
  }                                                                         \
  int radws_implicit_heating_##SFX(                                         \
      RADWS_TABLE_ARGS(T), const T* rho, const T* u, const T* dudt,         \
      const T* gpot, const T* dt, int dt_per_element, const T* tamb,        \
      int tamb_per_element, long long n, T* heat, int* index, int device,   \
      void* stream) {                                                       \
    cudaError_t err = cudaSetDevice(device);                                \
    if (err != cudaSuccess) return static_cast<int>(err);                   \
    if (n > 0)                                                              \
      radws_implicit_kernel<T><<<grid_for(n), kThreads, 0,                  \
                                 static_cast<cudaStream_t>(stream)>>>(      \
          RADWS_TABLE(T), rho, u, dudt, gpot, dt, dt_per_element, tamb,     \
          tamb_per_element, n, heat, index);                                \
    return static_cast<int>(cudaGetLastError());                            \
  }

RADWS_ENTRIES(f32, float)
RADWS_ENTRIES(f64, double)

}  // extern "C"
