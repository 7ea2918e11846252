// The periodic (Ewald) correction of one pair, shared by K6 and K7.
//
// Replaces gandalf_tpu/ops/ewald.py:ewald_correction (:352) with
// _trilinear (:331), and the min-image of gandalf_tpu/ops/tree.py (dr -
// L round(dr / L), with _ext_safe's huge period along an open axis,
// :231).  The plain version is gandalf_tpu_torch/ops/ewald.py.
//
// The table is (nx, ny, nz, 4): (pot, ax, ay, az) per node of the
// positive octant, so each of a lookup's 8 corners is one 16-byte load
// in float32 (two in float64), read through the read-only cache; the
// whole table is 64 KB in float32 at the 16^3 nodes of a fully periodic
// box.  The lookup follows the JAX code operation for operation: the
// sign of each component is 0 at 0 (jnp.sign, not copysign); the cell
// index is the truncated |dr| / spacing clipped to nmax; the weights
// multiply x, y, z in that order and the corners are summed with x
// outermost.  A slab (one open axis) or a cylinder (two) replaces the
// lookup beyond the table along an open axis by the analytic sheet or
// line far field.  The min-image rounds halves to even (rint, as
// jnp.round) with each step rounded on its own, so that the walk's
// decisions equal the plain version's bit for bit.
#pragma once

#include <cuda_runtime.h>

#include "tree.cuh"

namespace tree {

template <typename T>
struct EwaldTab {
  const T* tab;   // (nx, ny, nz, 4), or nullptr without the Ewald sum
  T inv[3];       // inverse grid spacing
  int nmax[3];    // last valid cell index per axis
  T period[3];    // min-image period (huge along an open axis)
  T thresh[3];    // |dr| beyond which the far field (open axes)
  int kind;       // 7 fully periodic, 2 slab, 1 cylinder
  int open0, open1;
  T ap;           // slab: 2 pi / area
  T lp;           // cylinder: periodic length
  T potc;         // cylinder: far potential constant
  int ny, nz;
};

// the table's device struct from the 22 values of the host's
// EwaldTable.meta() (gandalf_tpu_torch/ops/ewald.py); an empty struct
// (tab == nullptr) without a table
template <typename T>
EwaldTab<T> ewald_from_meta(const T* tab, const double* meta) {
  EwaldTab<T> e = {};
  e.tab = tab;
  if (tab == nullptr || meta == nullptr) {
    e.tab = nullptr;
    return e;
  }
  for (int k = 0; k < 3; ++k) {
    e.inv[k] = T(meta[k]);
    e.nmax[k] = static_cast<int>(meta[3 + k]);
    e.period[k] = T(meta[6 + k]);
    e.thresh[k] = T(meta[9 + k]);
  }
  e.kind = static_cast<int>(meta[12]);
  e.open0 = static_cast<int>(meta[13]);
  e.open1 = static_cast<int>(meta[14]);
  e.lp = T(meta[16]);
  e.ap = meta[17] > 0.0 ? T(2.0 * 3.14159265358979323846 / meta[17]) : T(0);
  e.potc = T(meta[18]);
  e.ny = static_cast<int>(meta[20]);
  e.nz = static_cast<int>(meta[21]);
  return e;
}

template <typename T>
__device__ __forceinline__ T sign0(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

__device__ __forceinline__ float round_even(float x) { return rintf(x); }
__device__ __forceinline__ double round_even(double x) { return rint(x); }

// d - period * round(d / period), each step rounded on its own
template <typename T>
__device__ __forceinline__ T min_image(T d, T period) {
  return sub_rn(d, mul_rn(period, round_even(div_rn(d, period))));
}

struct Node4f {
  float p, x, y, z;
};
struct Node4d {
  double p, x, y, z;
};

__device__ __forceinline__ Node4f load_node(const float* tab, long long i) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(tab) + i);
  return {v.x, v.y, v.z, v.w};
}

__device__ __forceinline__ Node4d load_node(const double* tab, long long i) {
  const double2* q = reinterpret_cast<const double2*>(tab) + 2 * i;
  const double2 a = __ldg(q), b = __ldg(q + 1);
  return {a.x, a.y, b.x, b.y};
}

// (ax, ay, az, pot) of the correction at the min-image pair vector d
template <typename T>
__device__ __forceinline__ void ewald_corr(const EwaldTab<T>& e, const T d[3],
                                           T& ax, T& ay, T& az, T& pot) {
  int i0[3];
  T w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T b = fabs(d[k]) * e.inv[k];
    // clip before the cast: a cast of a huge b is undefined
    const T bc = b < T(1 << 30) ? b : T(1 << 30);
    const int i = static_cast<int>(bc);
    i0[k] = i < e.nmax[k] ? i : e.nmax[k];
    w[k] = b - T(i0[k]);
  }
  T p = T(0), a0 = T(0), a1 = T(0), a2 = T(0);
#pragma unroll
  for (int cx = 0; cx < 2; ++cx) {
#pragma unroll
    for (int cy = 0; cy < 2; ++cy) {
#pragma unroll
      for (int cz = 0; cz < 2; ++cz) {
        const T wt = (cx ? w[0] : T(1) - w[0]) * (cy ? w[1] : T(1) - w[1])
                     * (cz ? w[2] : T(1) - w[2]);
        const long long idx =
            (static_cast<long long>(i0[0] + cx) * e.ny + i0[1] + cy) * e.nz
            + i0[2] + cz;
        const auto v = load_node(e.tab, idx);
        p += wt * v.p;
        a0 += wt * v.x;
        a1 += wt * v.y;
        a2 += wt * v.z;
      }
    }
  }
  ax = a0 * sign0(d[0]);
  ay = a1 * sign0(d[1]);
  az = a2 * sign0(d[2]);
  pot = p;
  if (e.kind == 7) return;
  const T d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  const T dinv = T(1) / sqrt(max(d2, T(1e-300)));
  const T dinv3 = dinv * dinv * dinv;
  T f[3] = {-d[0] * dinv3, -d[1] * dinv3, -d[2] * dinv3};
  T pf;
  bool out;
  if (e.kind == 2) {
    // uniform sheet
    const int o = e.open0;
    pf = -(fabs(d[o]) * e.ap + dinv);
    f[o] += e.ap * sign0(d[o]);
    out = fabs(d[o]) > e.thresh[o];
  } else {
    // line mass
    const int q1 = e.open0, q2 = e.open1;
    const T cs = max(d[q1] * d[q1] + d[q2] * d[q2], T(1e-300));
    pf = -(log(cs) / e.lp + e.potc + dinv);
    const T dfac = T(2) / (e.lp * cs);
    f[q1] += d[q1] * dfac;
    f[q2] += d[q2] * dfac;
    out = fabs(d[q1]) > e.thresh[q1] || fabs(d[q2]) > e.thresh[q2];
  }
  if (out) {
    ax = f[0];
    ay = f[1];
    az = f[2];
    pot = pf;
  }
}

}  // namespace tree
