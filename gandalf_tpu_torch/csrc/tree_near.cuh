// K7 tree_near: near-field pair sums of every group over its near
// leaves, the kernel-support overflow check, and the scatter of the
// total acceleration and potential to particle order, in 1-3 dims (NDIM
// a template parameter).  This header holds the kernel; tree_near.cu
// (3D), tree_near_2d.cu and tree_near_1d.cu instantiate it, so that the
// three build in parallel.  The Ewald sum is instantiated in 3D only.
//
// Replaces gandalf_tpu/ops/tree.py:_near_field (:635-855: the Newtonian
// block :663-706, the support tier :708-846 in both zeta scalings
// :770-780 and :817-835, with the Ewald sum's min-imaged pairs and
// per-pair correction :687-706, :723-725 and :796-846, and the fast
// multipoles' expansion to each slot :848-854) and the scatter of
// tree_gravity_grouped (:1389-1392).  There the whole (L, Wn*L) block
// gets the Newtonian sum, and the leaves within kernel support get a
// second pass that subtracts m/d^3 again and adds the softened term;
// both from a dot-product expansion (from the (L, Wn*L, 3) separations
// with the Ewald sum), with a cancellation floor for the self pair.
//
// Bound on the card: pair arithmetic.  At 262,144 particles each of
// 8,192 groups meets about 100 near leaves, so a pass is near 1e9 pair
// candidates; a Newtonian pair costs a reciprocal square root and ~15
// flops, a softened one (within 2h, a few per cent) the M4 gravity
// polynomials as well, and with the Ewald sum every pair ~35 flops more
// and 8 corner loads of the correction table (csrc/ewald.cuh).
//
// Design: one warp per group, lane = target slot, the sums in registers.
// The near leaves stream through shared memory, one leaf of 32 slots at
// a time, and every lane reads each partner as a broadcast.  Each pair
// is evaluated once (ROADMAP fault F6): where d < kernrange *
// max(h_i, h_j) the symmetric softened force and potential with the
// zeta*hfactor terms, elsewhere m/d^3 and m/d, which is what the
// softened formula equals there.  So no two terms of size 1/d^3 cancel,
// and close pairs keep their digits in float32.  The self pair is
// excluded by identity (same leaf, same slot) and coincident pairs by
// d^2 = 0 (F2), with no cancellation floor.  With the Ewald sum each
// pair's separation is min-imaged first and the pair adds m_j times the
// table's correction as well.  The support selection of gandalf_tpu
// (leaf-box gap, min-imaged with the Ewald sum, against kernrange *
// max(h over live slots)) raises the same overflow when more than
// min(support_cap, near_cap) leaves are in support, and a pair is
// softened only in a selected leaf: for a live target that is implied by
// d < kernrange * max(h_i, h_j), for a dead one (h = 1) it is what the
// JAX package's correction tier does.  The
// epilogue adds K6's far field, or with the fast multipoles K6's
// expansion a0 + J (r_i - gc), pot0 + a0 . (r_i - gc) (J NDIM x NDIM)
// about the group's
// box centre, and writes a and gpot to row out_index[slot] of every slot
// with a row (out_index >= 0) in a group with a live slot, dead slots
// included, as the JAX package's scatter does; the map is injective, so
// no atomics are needed.  The zeta term takes the
// grad-h SPH scaling m_j (zh_i w1_i + zh_j w1_j) / 2, or with `mfv` the
// meshless finite-volume one, (1/m_i) (zh_i w1_i + zh_j w1_j) / 2, not
// scaled by m_j and zero for a massless partner (MfvCommon.cpp:413-416).
// With a group list (K6's), warp k takes group group_ids[k], and only
// the listed groups' rows are written (the wrapper zeroes the outputs).
// The Ewald sum is a template parameter, so the other modes' pair loop
// carries none of its code or registers.  So is the smoothing kernel
// (kernel_family.cuh: M4 or the quintic, direct or tabulated; the
// gaussian has no softened gravity, ROADMAP fault F23); any kernel but
// the direct M4 sums d^2 in the plain version's rounded steps (kExactD2),
// so that s and a table index are the plain version's.  At kernrange 3 about (3/2)^3 =
// 3.4 times as many pairs fall in the support tier as with M4.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "ewald.cuh"
#include "kernel_family.cuh"
#include "tree.cuh"

// internal linkage: each of the three sources instantiates its own
namespace {

using namespace tree;

constexpr int kWarps = 4;

template <typename T, int NDIM, bool kEwald, class KF>
__global__ void __launch_bounds__(kWarps * kLeaf) tree_near_kernel(
    const T* __restrict__ ctab, const T* __restrict__ ptab,
    const unsigned char* __restrict__ alive, const int* __restrict__ near,
    const T* __restrict__ a_far, const T* __restrict__ pot_far,
    const T* __restrict__ fast_tab,
    const int* __restrict__ out_index, const int* __restrict__ group_ids,
    int n_groups, int depth, int near_cap,
    int support_cap, int smoothed, int mfv, T kernrange, KF kern,
    EwaldTab<T> ew, T* __restrict__ a_out, T* __restrict__ gpot_out,
    unsigned char* __restrict__ overflow) {
  using Lay = Layout<NDIM>;
  constexpr int kPCols = Lay::kPCols;
  __shared__ T part[kWarps][kLeaf][kPCols];
  __shared__ unsigned char part_live[kWarps][kLeaf];
  const int wib = threadIdx.x / kLeaf;
  const int lane = threadIdx.x % kLeaf;
  const int gk = blockIdx.x * kWarps + wib;
  if (gk >= n_groups) return;  // whole warps leave together
  const int g = group_ids != nullptr ? group_ids[gk] : gk;
  const long long slot = static_cast<long long>(g) * kLeaf + lane;
  const bool live = alive[slot] != 0;
  if (!__ballot_sync(kFull, live)) return;
  // targets: every mapped slot of a live group, dead ones included (a
  // dead particle is no source: its alive byte is 0 and its mass 0)
  const long long o = out_index[slot];
  const bool target = o >= 0;
  const T* p = ptab + kPCols * slot;
  T xi[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) xi[k] = p[Lay::kPX + k];
  const T h_i = p[Lay::kPH], zh_i = p[Lay::kPZH];
  const T invh_i = T(1) / h_i;
  const T invm_i = T(1) / max(p[Lay::kPM], T(1e-30));
  const T* leaves = ctab + Lay::kCCols * ((1LL << depth) - 1);
  const T* gcell = leaves + Lay::kCCols * static_cast<long long>(g);
  const T hg = warp_max(live ? h_i : T(0));
  const int* near_g = near + static_cast<long long>(g) * near_cap;
  T acc[NDIM], pot = T(0);
#pragma unroll
  for (int k = 0; k < NDIM; ++k) acc[k] = T(0);
  int n_sup = 0;
  for (int w = 0; w < near_cap; ++w) {
    const int nl = near_g[w];
    if (nl < 0) break;
    const long long ps = static_cast<long long>(nl) * kLeaf + lane;
    const T* q = ptab + kPCols * ps;
    T mine[kPCols];
#pragma unroll
    for (int c = 0; c < kPCols; ++c) {
      mine[c] = q[c];
      part[wib][lane][c] = mine[c];
    }
    const bool q_live = alive[ps] != 0;
    part_live[wib][lane] = q_live ? 1 : 0;
    bool leaf_sup = false;
    if (smoothed) {
      const T hc = warp_max(q_live && mine[Lay::kPM] > T(0) ? mine[Lay::kPH]
                                                              : T(0));
      const T* cell = leaves + Lay::kCCols * static_cast<long long>(nl);
      T gap2 = T(0);
#pragma unroll
      for (int k = 0; k < NDIM; ++k) {
        T dgc = cell[Lay::kCCen + k] - gcell[Lay::kCCen + k];
        if constexpr (kEwald) dgc = min_image(dgc, ew.period[k]);
        const T gap = max(fabs(dgc) - cell[Lay::kCHalf + k]
                          - gcell[Lay::kCHalf + k], T(0));
        gap2 += gap * gap;
      }
      const T rad = kernrange * max(hg, hc);
      leaf_sup = gap2 < rad * rad;
      n_sup += leaf_sup ? 1 : 0;
    }
    __syncwarp();
    if (target) {
      for (int j = 0; j < kLeaf; ++j) {
        if (!part_live[wib][j] || (nl == g && j == lane)) continue;
        const T* pj = part[wib][j];
        T dr[NDIM];
#pragma unroll
        for (int k = 0; k < NDIM; ++k) dr[k] = pj[Lay::kPX + k] - xi[k];
        if constexpr (kEwald) {
#pragma unroll
          for (int k = 0; k < NDIM; ++k) dr[k] = min_image(dr[k], ew.period[k]);
        }
        T d2;
        if constexpr (KF::kExactD2) {
          d2 = mul_rn(dr[0], dr[0]);
#pragma unroll
          for (int k = 1; k < NDIM; ++k) d2 = add_rn(d2, mul_rn(dr[k], dr[k]));
        } else {
          d2 = dr[0] * dr[0];
#pragma unroll
          for (int k = 1; k < NDIM; ++k) d2 = d2 + dr[k] * dr[k];
        }
        if (!(d2 > T(0))) continue;
        const T m_j = pj[Lay::kPM];
        const T d = sqrt(d2);
        T coef;
        // softened only in a leaf of the support selection, which
        // decides only for a dead target (its h = 1 is not in hg)
        if (smoothed && leaf_sup && d < kernrange * max(h_i, pj[Lay::kPH])) {
          const T invh_j = T(1) / pj[Lay::kPH];
          const T s_i = d * invh_i, s_j = d * invh_j;
          const T paux = T(0.5) * (invh_i * invh_i * kern.wgrav(s_i)
                                   + invh_j * invh_j * kern.wgrav(s_j));
          const T zterm = T(0.5) * (zh_i * kern.w1(s_i)
                                    + pj[Lay::kPZH] * kern.w1(s_j));
          const T gaux = T(0.5) * (invh_i * kern.wpot(s_i)
                                   + invh_j * kern.wpot(s_j));
          if (!mfv) {
            coef = m_j * (paux + zterm) / d;
          } else {
            // (1/m_i) zterm, not scaled by m_j, none from a massless j
            coef = m_j * paux / d + (m_j > T(0) ? invm_i * zterm : T(0)) / d;
          }
          pot += m_j * gaux;
        } else {
          const T inv_d = T(1) / d;
          coef = m_j * inv_d * inv_d * inv_d;
          pot += m_j * inv_d;
        }
#pragma unroll
        for (int k = 0; k < NDIM; ++k) acc[k] += coef * dr[k];
        if constexpr (kEwald) {
          T ex, ey, ez, ep;
          ewald_corr(ew, dr, ex, ey, ez, ep);
          acc[0] += m_j * ex;
          acc[1] += m_j * ey;
          acc[2] += m_j * ez;
          pot += m_j * ep;
        }
      }
    }
    __syncwarp();
  }
  const int ws = support_cap < near_cap ? support_cap : near_cap;
  if (smoothed && n_sup > ws && lane == 0) *overflow = 1;
  if (target) {
    T f[NDIM], fp;
    if (fast_tab != nullptr) {
      // the group's expansion about its box centre: a0[NDIM], pot0 and
      // the Jacobian row by row
      const T* e = fast_tab + static_cast<long long>(Lay::kFastCols) * g;
      T dc[NDIM];
#pragma unroll
      for (int k = 0; k < NDIM; ++k) dc[k] = xi[k] - gcell[Lay::kCCen + k];
#pragma unroll
      for (int i = 0; i < NDIM; ++i) {
        const T* jr = e + NDIM + 1 + NDIM * i;
        T s = jr[0] * dc[0];
#pragma unroll
        for (int j = 1; j < NDIM; ++j) s = s + jr[j] * dc[j];
        f[i] = e[i] + s;
      }
      T s = e[0] * dc[0];
#pragma unroll
      for (int j = 1; j < NDIM; ++j) s = s + e[j] * dc[j];
      fp = e[NDIM] + s;
    } else {
#pragma unroll
      for (int k = 0; k < NDIM; ++k) f[k] = a_far[NDIM * slot + k];
      fp = pot_far[slot];
    }
#pragma unroll
    for (int k = 0; k < NDIM; ++k) a_out[NDIM * o + k] = acc[k] + f[k];
    gpot_out[o] = pot + fp;
  }
}

template <typename T, int NDIM>
int run_near(const T* ctab, const T* ptab, const unsigned char* alive,
             const int* near, const T* a_far, const T* pot_far,
             const T* fast_tab, const int* out_index, const int* group_ids,
             int n_groups, int depth, int near_cap, int support_cap,
             int smoothed, int mfv, double kernrange, double norm,
             int family, int res, const T* ewald_tab,
             const double* ewald_meta, T* a_out,
             T* gpot_out, unsigned char* overflow, int device,
             void* stream_ptr) {
  if ((fast_tab == nullptr && (a_far == nullptr || pot_far == nullptr))
      || (NDIM != 3 && ewald_tab != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int groups = group_ids != nullptr ? n_groups : 1 << depth;
  const EwaldTab<T> ew = ewald_from_meta<T>(ewald_tab, ewald_meta);
  // the Newtonian mode (smoothed 0) takes the M4 instance
  const bool known = kf::with_kernel<T, true>(
      smoothed ? family : kf::kM4, smoothed ? res : 0, norm, NDIM,
      [&](const auto& kern) {
        using KF = std::decay_t<decltype(kern)>;
        auto kernel = tree_near_kernel<T, NDIM, false, KF>;
        if constexpr (NDIM == 3) {
          if (ew.tab != nullptr) kernel = tree_near_kernel<T, NDIM, true, KF>;
        }
        if (groups > 0)
          kernel<<<(groups + kWarps - 1) / kWarps, kWarps * kLeaf, 0,
                   stream>>>(
              ctab, ptab, alive, near, a_far, pot_far, fast_tab, out_index,
              group_ids, groups, depth, near_cap, support_cap, smoothed, mfv,
              T(kernrange), kern, ew, a_out, gpot_out, overflow);
      });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TREE_NEAR_ENTRY(NAME, T, NDIM)                                      \
  extern "C" int NAME(                                                      \
      const T* ctab, const T* ptab, const unsigned char* alive,             \
      const int* near, const T* a_far, const T* pot_far,                    \
      const T* fast_tab, const int* out_index, const int* group_ids,        \
      int n_groups, int depth, int near_cap, int support_cap,               \
      int smoothed, int mfv, double kernrange, double norm, int family,     \
      int res, const T* ewald_tab, const double* ewald_meta, T* a_out,      \
      T* gpot_out, unsigned char* overflow, int device, void* stream) {     \
    return run_near<T, NDIM>(ctab, ptab, alive, near, a_far, pot_far,       \
                             fast_tab, out_index, group_ids, n_groups,      \
                             depth, near_cap, support_cap, smoothed, mfv,   \
                             kernrange, norm, family, res, ewald_tab,       \
                             ewald_meta, a_out, gpot_out, overflow, device, \
                             stream);                                       \
  }
