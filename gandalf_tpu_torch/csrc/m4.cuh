// M4 cubic-spline kernel for the grid and tree kernels: the polynomials of
// gandalf_tpu_torch/kernels/smoothing.py (and gandalf_tpu's _m4), written
// in the same form so that float64 results agree to rounding.
//   s     = r/h, support ends at s = 2
//   w0    = W without 1/h^ndim
//   w1    = dW/ds without 1/h^(ndim+1)
//   womega= -(ndim*w0 + s*w1)
//   wzeta = d(phi)/dh kernel (no normalisation)
//   wgrav = softened gravity force kernel, 1/s^2 from s = 2 on
//   wpot  = softened gravity potential kernel, 1/s from s = 2 on
//   wdrag = gas-dust drag kernel, normdrag s^2 w0 (kernnormdrag)
// `norm` is the ndim-dependent normalisation (1/pi in 3D), passed from
// the host so both sides use the same constant.
#pragma once

template <typename T>
__device__ __forceinline__ T m4_w0(T s, T norm) {
  if (s < T(1)) return norm * (T(1) - T(1.5) * s * s + T(0.75) * s * s * s);
  if (s < T(2)) {
    const T q = T(2) - s;
    return T(0.25) * norm * (q * q * q);
  }
  return T(0);
}

template <typename T>
__device__ __forceinline__ T m4_wdrag(T s, T norm, T normdrag) {
  return normdrag * s * s * m4_w0<T>(s, norm);
}

template <typename T>
__device__ __forceinline__ T m4_w1(T s, T norm) {
  if (s < T(1)) return norm * (T(-3) * s + T(2.25) * s * s);
  if (s < T(2)) {
    const T q = T(2) - s;
    return T(-0.75) * norm * (q * q);
  }
  return T(0);
}

template <typename T>
__device__ __forceinline__ T m4_womega(T s, T norm, T nd) {
  const T s2 = s * s, s3 = s2 * s;
  if (s < T(1))
    return norm * (-nd + T(1.5) * (nd + T(2)) * s2
                   - T(0.75) * (nd + T(3)) * s3);
  if (s < T(2))
    return norm * (T(-2) * nd + T(3) * (nd + T(1)) * s
                   - T(1.5) * (nd + T(2)) * s2
                   + T(0.25) * (nd + T(3)) * s3);
  return T(0);
}

template <typename T>
__device__ __forceinline__ T m4_wzeta(T s) {
  const T s2 = s * s, s3 = s2 * s, s4 = s2 * s2, s5 = s4 * s;
  if (s < T(1)) return T(1.4) - T(2) * s2 + T(1.5) * s4 - T(0.6) * s5;
  if (s < T(2))
    return T(1.6) - T(4) * s2 + T(4) * s3 - T(1.5) * s4 + T(0.2) * s5;
  return T(0);
}

template <typename T>
__device__ __forceinline__ T m4_wgrav(T s) {
  if (s < T(1)) return (T(4) / T(3)) * s - T(1.2) * s * s * s
                       + T(0.5) * (s * s) * (s * s);
  const T s_safe = s > T(1e-30) ? s : T(1e-30);
  if (s < T(2))
    return (T(8) / T(3)) * s - T(3) * s * s + T(1.2) * s * s * s
           - (T(1) / T(6)) * (s * s) * (s * s)
           - (T(1) / T(15)) / (s_safe * s_safe);
  return T(1) / (s_safe * s_safe);
}

template <typename T>
__device__ __forceinline__ T m4_wpot(T s) {
  const T s2 = s * s, s4 = s2 * s2;
  if (s < T(1)) return T(1.4) - (T(2) / T(3)) * s2 + T(0.3) * s4
                       - T(0.1) * s4 * s;
  const T s_safe = s > T(1e-30) ? s : T(1e-30);
  if (s < T(2))
    return T(-1) / (T(15) * s_safe) + T(1.6) - (T(4) / T(3)) * s2
           + s2 * s - T(0.3) * s4 + (T(1) / T(30)) * s4 * s;
  return T(1) / s_safe;
}
