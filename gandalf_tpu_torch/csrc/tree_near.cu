// K7 tree_near: near-field pair sums of every group over its near
// leaves, the kernel-support overflow check, and the scatter of the
// total acceleration and potential to particle order.
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
// max(h over live slots)) is kept only to raise the same overflow when
// more than min(support_cap, near_cap) leaves are in support.  The
// epilogue adds K6's far field, or with the fast multipoles K6's
// expansion a0 + J (r_i - gc), pot0 + a0 . (r_i - gc) about the group's
// box centre, and writes a and gpot to row out_index[slot]; the map is
// injective, so no atomics are needed.  The zeta term takes the
// grad-h SPH scaling m_j (zh_i w1_i + zh_j w1_j) / 2, or with `mfv` the
// meshless finite-volume one, (1/m_i) (zh_i w1_i + zh_j w1_j) / 2, not
// scaled by m_j and zero for a massless partner (MfvCommon.cpp:413-416).
// With a group list (K6's), warp k takes group group_ids[k], and only
// the listed groups' rows are written (the wrapper zeroes the outputs).
// The Ewald sum is a template parameter, so the other modes' pair loop
// carries none of its code or registers.
#include <cuda_runtime.h>

#include "ewald.cuh"
#include "m4.cuh"
#include "tree.cuh"

namespace {

using namespace tree;

constexpr int kWarps = 4;

template <typename T, bool kEwald>
__global__ void __launch_bounds__(kWarps * kLeaf) tree_near_kernel(
    const T* __restrict__ ctab, const T* __restrict__ ptab,
    const unsigned char* __restrict__ alive, const int* __restrict__ near,
    const T* __restrict__ a_far, const T* __restrict__ pot_far,
    const T* __restrict__ fast_tab,
    const int* __restrict__ out_index, const int* __restrict__ group_ids,
    int n_groups, int depth, int near_cap,
    int support_cap, int smoothed, int mfv, T kernrange, T norm,
    EwaldTab<T> ew, T* __restrict__ a_out, T* __restrict__ gpot_out,
    unsigned char* __restrict__ overflow) {
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
  constexpr bool ewald = kEwald;
  const T* p = ptab + kPCols * slot;
  const T xi = p[0], yi = p[1], zi = p[2];
  const T h_i = p[kPH], zh_i = p[kPZH];
  const T invh_i = T(1) / h_i;
  const T invm_i = T(1) / max(p[kPM], T(1e-30));
  const T* leaves = ctab + kCCols * ((1LL << depth) - 1);
  const T* gcell = leaves + kCCols * static_cast<long long>(g);
  const T hg = warp_max(live ? h_i : T(0));
  const int* near_g = near + static_cast<long long>(g) * near_cap;
  T ax = T(0), ay = T(0), az = T(0), pot = T(0);
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
    if (smoothed) {
      const T hc = warp_max(q_live && mine[kPM] > T(0) ? mine[kPH] : T(0));
      const T* cell = leaves + kCCols * static_cast<long long>(nl);
      T gap2 = T(0);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        T dgc = cell[kCCen + k] - gcell[kCCen + k];
        if (ewald) dgc = min_image(dgc, ew.period[k]);
        const T gap = max(fabs(dgc) - cell[kCHalf + k] - gcell[kCHalf + k],
                          T(0));
        gap2 += gap * gap;
      }
      const T rad = kernrange * max(hg, hc);
      n_sup += gap2 < rad * rad ? 1 : 0;
    }
    __syncwarp();
    if (live) {
      for (int j = 0; j < kLeaf; ++j) {
        if (!part_live[wib][j] || (nl == g && j == lane)) continue;
        const T* pj = part[wib][j];
        T dr[3] = {pj[0] - xi, pj[1] - yi, pj[2] - zi};
        if (ewald) {
#pragma unroll
          for (int k = 0; k < 3; ++k) dr[k] = min_image(dr[k], ew.period[k]);
        }
        const T dx = dr[0], dy = dr[1], dz = dr[2];
        const T d2 = dx * dx + dy * dy + dz * dz;
        if (!(d2 > T(0))) continue;
        const T m_j = pj[kPM];
        const T d = sqrt(d2);
        T coef;
        if (smoothed && d < kernrange * max(h_i, pj[kPH])) {
          const T invh_j = T(1) / pj[kPH];
          const T s_i = d * invh_i, s_j = d * invh_j;
          const T paux = T(0.5) * (invh_i * invh_i * m4_wgrav(s_i)
                                   + invh_j * invh_j * m4_wgrav(s_j));
          const T zterm = T(0.5) * (zh_i * m4_w1(s_i, norm)
                                    + pj[kPZH] * m4_w1(s_j, norm));
          const T gaux = T(0.5) * (invh_i * m4_wpot(s_i)
                                   + invh_j * m4_wpot(s_j));
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
        ax += coef * dx;
        ay += coef * dy;
        az += coef * dz;
        if (ewald) {
          T ex, ey, ez, ep;
          ewald_corr(ew, dr, ex, ey, ez, ep);
          ax += m_j * ex;
          ay += m_j * ey;
          az += m_j * ez;
          pot += m_j * ep;
        }
      }
    }
    __syncwarp();
  }
  const int ws = support_cap < near_cap ? support_cap : near_cap;
  if (smoothed && n_sup > ws && lane == 0) *overflow = 1;
  if (live) {
    T fx, fy, fz, fp;
    if (fast_tab != nullptr) {
      // the group's expansion about its box centre
      const T* f = fast_tab + 13LL * g;
      const T d0 = xi - gcell[kCCen], d1 = yi - gcell[kCCen + 1],
              d2 = zi - gcell[kCCen + 2];
      fx = f[0] + (f[4] * d0 + f[5] * d1 + f[6] * d2);
      fy = f[1] + (f[7] * d0 + f[8] * d1 + f[9] * d2);
      fz = f[2] + (f[10] * d0 + f[11] * d1 + f[12] * d2);
      fp = f[3] + (f[0] * d0 + f[1] * d1 + f[2] * d2);
    } else {
      fx = a_far[3 * slot];
      fy = a_far[3 * slot + 1];
      fz = a_far[3 * slot + 2];
      fp = pot_far[slot];
    }
    const long long o = out_index[slot];
    a_out[3 * o] = ax + fx;
    a_out[3 * o + 1] = ay + fy;
    a_out[3 * o + 2] = az + fz;
    gpot_out[o] = pot + fp;
  }
}

template <typename T>
int run_near(const T* ctab, const T* ptab, const unsigned char* alive,
             const int* near, const T* a_far, const T* pot_far,
             const T* fast_tab, const int* out_index, const int* group_ids,
             int n_groups, int depth, int near_cap, int support_cap,
             int smoothed, int mfv, double kernrange, double norm,
             const T* ewald_tab, const double* ewald_meta, T* a_out,
             T* gpot_out, unsigned char* overflow, int device,
             void* stream_ptr) {
  if (fast_tab == nullptr && (a_far == nullptr || pot_far == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int groups = group_ids != nullptr ? n_groups : 1 << depth;
  const EwaldTab<T> ew = ewald_from_meta<T>(ewald_tab, ewald_meta);
  auto kernel = ew.tab != nullptr ? tree_near_kernel<T, true>
                                  : tree_near_kernel<T, false>;
  if (groups > 0)
    kernel<<<(groups + kWarps - 1) / kWarps, kWarps * kLeaf, 0, stream>>>(
        ctab, ptab, alive, near, a_far, pot_far, fast_tab, out_index,
        group_ids, groups, depth, near_cap, support_cap, smoothed, mfv,
        T(kernrange), T(norm), ew, a_out, gpot_out, overflow);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define TREE_NEAR_ENTRY(NAME, T)                                            \
  int NAME(const T* ctab, const T* ptab, const unsigned char* alive,        \
           const int* near, const T* a_far, const T* pot_far,               \
           const T* fast_tab, const int* out_index, const int* group_ids,   \
           int n_groups, int depth, int near_cap, int support_cap,          \
           int smoothed, int mfv, double kernrange, double norm,            \
           const T* ewald_tab, const double* ewald_meta, T* a_out,          \
           T* gpot_out, unsigned char* overflow, int device,                \
           void* stream) {                                                  \
    return run_near<T>(ctab, ptab, alive, near, a_far, pot_far, fast_tab,   \
                       out_index, group_ids, n_groups, depth, near_cap,     \
                       support_cap, smoothed, mfv, kernrange, norm,         \
                       ewald_tab, ewald_meta, a_out, gpot_out, overflow,    \
                       device, stream);                                     \
  }

TREE_NEAR_ENTRY(tree_near_f32, float)
TREE_NEAR_ENTRY(tree_near_f64, double)

}  // extern "C"
