// K6 tree_walk: per-group frontier walk of the tree, the far field of
// accepted cells, and the near list of opened leaves.
//
// Replaces gandalf_tpu/ops/tree.py:tree_gravity -> walk_group (:390-592)
// with _compact (:268-279): the geometric MAC and the accuracy MACs
// gadget2 and eigenmac (:318-333, :457-475), the far field evaluated at
// every slot or, with the fast multipoles, its expansion at the group's
// box centre (:481-512), and the periodic (Ewald) walk (:440-455,
// :556-568).  There each group gathers a padded frontier of W cells per
// level and evaluates the far field as (L, W) matrix products, with
// distances from a dot-product expansion.
//
// Bound on the card: latency of dependent gathers.  Each level's
// frontier depends on the last, the cell rows are scattered through a
// table of 2^(D+1) rows, and per accepted cell every lane does ~60 flops
// of quadrupole far field (~100 more, and 8 table loads, with the Ewald
// correction); at 262,144 particles 8,192 groups walk 14 levels each.
//
// Design: one warp per group, lane = target slot.  The frontier is
// double-buffered in shared memory.  Per level the warp takes the
// frontier 32 cells at a time, lane c loading cell c.  The MAC is the
// same test for every lane, so two ballots give the accepted and opened
// cells:
// - geometric: per-axis gap = max(|com - gc| - gh, 0), accept if
//   dsqd * theta^2 > sum half^2; a cell with m = 0 is neither accepted
//   nor opened;
// - gadget2 also opens when dsqd^2 * amin * macerror < rmax^2 * m, with
//   amin the group's least |a_prev| (the wrapper's per-group factor);
// - eigenmac also opens when dsqd < (lambda / (2 macerror))^(2/3) * f,
//   with lambda = 2 sqrt(tr(Q^2) / 6) from the cell's quadrupole (loaded
//   for every valid cell, since the test needs it) and f the group's
//   largest gpot^(-2/3);
// - with the Ewald sum, com - gc is min-imaged first, so a cell close
//   through the box's seam is opened.
// The MAC's sums take round-to-nearest steps in the plain version's
// order, so both take the same decisions bit for bit.  Without the fast
// multipoles each accepted cell is shuffled to all lanes, which add its
// far field at dr = com - r_i, computed directly (min-imaged, plus m
// times the table's correction, with the Ewald sum).  With them each
// lane adds its own accepted cell's monopole (or quadrupole) field and
// its monopole Jacobian at dr = com - gc (min-imaged, the correction
// added to the field but not to the Jacobian, with the Ewald sum), and
// a warp sum gives the group's a0 (3), pot0 and Jacobian (3x3), which
// K7 expands to each slot.  The children of opened cells go to the next
// frontier at a prefix sum of the ballot (stable, so in the order of
// gandalf_tpu's _compact); at the leaf level the opened leaves form the
// near list (-1 padded).  Overflow iff the opened children exceed the
// next level's cap min(frontier, 2^(l+1), frontier_levels[l+1]), or the
// opened leaves exceed the near cap.  An empty group walks nothing.
//
// With a group list (the active groups of a block-timestep tick,
// gandalf_tpu/ops/tree.py:tree_gravity_active :1429 with group_ids),
// warp k walks group group_ids[k], and only the listed groups' rows are
// written; the wrapper zeroes the rest.  Without one, warp k walks group
// k of all 2^depth.  The Ewald sum and the fast multipoles are template
// parameters, so the default walk carries none of their code or
// registers.
#include <cuda_runtime.h>

#include "ewald.cuh"
#include "tree.cuh"

namespace {

using namespace tree;

struct LevelCaps {
  int w[kMaxLevels + 1];
};

// the options of a walk decided at run time: the multipole order, the
// MAC with its per-group factor, and the Ewald table (tab == nullptr
// without; the kernel's kEwald says which)
template <typename T>
struct WalkOpts {
  int quadrupole;
  int mac;  // 0 geometric, 1 gadget2, 2 eigenmac
  T macerror;
  const T* gfac;
  EwaldTab<T> ew;
};

constexpr int kFastCols = 13;  // a0 (3), pot0, Jacobian (9, row-major)

template <typename T>
__device__ __forceinline__ T safe_invr(T d2);

template <>
__device__ __forceinline__ float safe_invr<float>(float d2) {
  return d2 > 1e-24f ? rsqrtf(d2) : 0.0f;
}

template <>
__device__ __forceinline__ double safe_invr<double>(double d2) {
  return d2 > 1e-60 ? rsqrt(d2) : 0.0;
}

__device__ __forceinline__ float pow23(float x) {
  return powf(x, 2.0f / 3.0f);
}
__device__ __forceinline__ double pow23(double x) {
  return pow(x, 2.0 / 3.0);
}

// monopole (and quadrupole) field of a cell of mass m and traceless
// quadrupole q at dr = com - r: adds to a and pot
template <typename T>
__device__ __forceinline__ void multipole(const T d[3], T m, const T q[6],
                                          bool quadrupole, T a[3], T& pot) {
  const T inv_r = safe_invr(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  const T inv_r3 = inv_r * inv_r * inv_r;
  a[0] += m * inv_r3 * d[0];
  a[1] += m * inv_r3 * d[1];
  a[2] += m * inv_r3 * d[2];
  pot += m * inv_r;
  if (quadrupole) {
    const T qx = q[0] * d[0] + q[1] * d[1] + q[2] * d[2];
    const T qy = q[1] * d[0] + q[3] * d[1] + q[4] * d[2];
    const T qz = q[2] * d[0] + q[4] * d[1] + q[5] * d[2];
    const T drqdr = qx * d[0] + qy * d[1] + qz * d[2];
    const T inv_r5 = inv_r3 * inv_r * inv_r;
    const T s7 = T(2.5) * drqdr * inv_r5 * inv_r * inv_r;
    a[0] += s7 * d[0] - inv_r5 * qx;
    a[1] += s7 * d[1] - inv_r5 * qy;
    a[2] += s7 * d[2] - inv_r5 * qz;
    pot += T(0.5) * drqdr * inv_r5;
  }
}

template <typename T, bool kEwald, bool kFast>
__global__ void tree_walk_kernel(const T* __restrict__ ctab,
                                 const T* __restrict__ ptab,
                                 const unsigned char* __restrict__ alive,
                                 const int* __restrict__ group_ids,
                                 int n_groups, int depth, int near_cap,
                                 int wmax, T theta_sqd, WalkOpts<T> opt,
                                 LevelCaps caps,
                                 T* __restrict__ a_far,
                                 T* __restrict__ pot_far,
                                 T* __restrict__ fast_out,
                                 int* __restrict__ near,
                                 unsigned char* __restrict__ overflow) {
  extern __shared__ int frontier[];
  const int wib = threadIdx.x / kLeaf;
  const int lane = threadIdx.x % kLeaf;
  const int gk = blockIdx.x * (blockDim.x / kLeaf) + wib;
  if (gk >= n_groups) return;  // whole warps leave together
  const int g = group_ids != nullptr ? group_ids[gk] : gk;
  const long long slot = static_cast<long long>(g) * kLeaf + lane;
  const bool live = alive[slot] != 0;
  constexpr bool ewald = kEwald;
  const bool quad = opt.quadrupole != 0;
  const bool eigen = opt.mac == 2 && quad;
  int* near_g = near + static_cast<long long>(g) * near_cap;
  if (!__ballot_sync(kFull, live)) {
    for (int w = lane; w < near_cap; w += kLeaf) near_g[w] = -1;
    if (kFast) {
      if (lane < kFastCols) fast_out[kFastCols * g + lane] = T(0);
    } else {
      a_far[3 * slot] = a_far[3 * slot + 1] = a_far[3 * slot + 2] = T(0);
      pot_far[slot] = T(0);
    }
    return;
  }
  const T* p = ptab + kPCols * slot;
  const T rx = p[0], ry = p[1], rz = p[2];
  const T* leaf = ctab + kCCols * ((1LL << depth) - 1 + g);
  const T gc[3] = {leaf[kCCen], leaf[kCCen + 1], leaf[kCCen + 2]};
  const T gh[3] = {leaf[kCHalf], leaf[kCHalf + 1], leaf[kCHalf + 2]};
  const T gfac = opt.mac != 0 ? opt.gfac[g] : T(0);
  int* cur = frontier + 2 * wmax * wib;
  int* nxt = cur + wmax;
  if (lane == 0) cur[0] = 0;
  __syncwarp();
  int ncur = 1;
  bool ovf = false;
  // per slot (far field) or, fast, per lane's cells (the expansion)
  T acc3[3] = {T(0), T(0), T(0)}, pot = T(0);
  T jac[9] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  for (int ell = 0; ell <= depth; ++ell) {
    const bool at_leaves = ell == depth;
    const int cap = at_leaves ? near_cap : caps.w[ell + 1];
    const T* rows = ctab + kCCols * ((1LL << ell) - 1);
    int nnext = 0;
    for (int base = 0; base < ncur; base += kLeaf) {
      const int k = base + lane;
      int cell = -1;
      T m = T(0), com[3] = {T(0), T(0), T(0)}, dk[3] = {T(0), T(0), T(0)};
      T q[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      bool acc = false, opn = false;
      if (k < ncur) {
        cell = cur[k];
        const T* row = rows + kCCols * static_cast<long long>(cell);
        m = row[kCM];
        // the MAC with round-to-nearest steps in the plain version's
        // order, so both take the same decisions bit for bit
        T dsqd = T(0), rmax_sqd = T(0);
#pragma unroll
        for (int kk = 0; kk < 3; ++kk) {
          com[kk] = row[kCCom + kk];
          dk[kk] = sub_rn(com[kk], gc[kk]);
          if (ewald) dk[kk] = min_image(dk[kk], opt.ew.period[kk]);
          const T gap = max(sub_rn(fabs(dk[kk]), gh[kk]), T(0));
          const T hk = row[kCHalf + kk];
          const T g2 = mul_rn(gap, gap), h2 = mul_rn(hk, hk);
          dsqd = kk == 0 ? g2 : add_rn(dsqd, g2);
          rmax_sqd = kk == 0 ? h2 : add_rn(rmax_sqd, h2);
        }
        acc = m > T(0) && mul_rn(dsqd, theta_sqd) > rmax_sqd;
        if (quad && (acc || eigen)) {
#pragma unroll
          for (int kk = 0; kk < 6; ++kk) q[kk] = row[kCQ + kk];
        }
        if (opt.mac == 1) {
          // gadget2: dsqd^2 amin macerror < rmax^2 m opens
          const T lhs = mul_rn(mul_rn(mul_rn(dsqd, dsqd), gfac),
                               opt.macerror);
          acc = acc && !(lhs < mul_rn(rmax_sqd, m));
        } else if (eigen) {
          const T diag = add_rn(add_rn(mul_rn(q[0], q[0]), mul_rn(q[3], q[3])),
                                mul_rn(q[5], q[5]));
          const T offd = add_rn(add_rn(mul_rn(q[1], q[1]), mul_rn(q[2], q[2])),
                                mul_rn(q[4], q[4]));
          const T trq2 = add_rn(diag, mul_rn(T(2), offd));
          const T lam = mul_rn(T(2), sqrt(div_rn(max(trq2, T(0)), T(6))));
          const T cellmac = pow23(div_rn(mul_rn(T(0.5), lam), opt.macerror));
          acc = acc && !(dsqd < mul_rn(cellmac, gfac));
        }
        opn = m > T(0) && !acc;
      }
      const unsigned amask = __ballot_sync(kFull, acc);
      const unsigned omask = __ballot_sync(kFull, opn);
      if (kFast) {
        if (acc) {
          // this lane's cell, expanded about the group's box centre
          multipole(dk, m, q, quad, acc3, pot);
          if (ewald) {
            T ex, ey, ez, ep;
            ewald_corr(opt.ew, dk, ex, ey, ez, ep);
            acc3[0] += m * ex;
            acc3[1] += m * ey;
            acc3[2] += m * ez;
            pot += m * ep;
          }
          const T inv_r =
              safe_invr(dk[0] * dk[0] + dk[1] * dk[1] + dk[2] * dk[2]);
          const T inv_r3 = inv_r * inv_r * inv_r;
          const T inv_r5 = inv_r3 * inv_r * inv_r;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              jac[3 * i + j] += m * (T(3) * dk[i] * dk[j] * inv_r5
                                     - (i == j ? inv_r3 : T(0)));
            }
          }
        }
      } else {
        for (unsigned bits = amask; bits; bits &= bits - 1) {
          const int src = __ffs(bits) - 1;
          const T cm = __shfl_sync(kFull, m, src);
          T d[3] = {__shfl_sync(kFull, com[0], src) - rx,
                    __shfl_sync(kFull, com[1], src) - ry,
                    __shfl_sync(kFull, com[2], src) - rz};
          T qs[6];
#pragma unroll
          for (int kk = 0; kk < 6; ++kk)
            qs[kk] = quad ? __shfl_sync(kFull, q[kk], src) : T(0);
          if (ewald) {
#pragma unroll
            for (int kk = 0; kk < 3; ++kk)
              d[kk] = min_image(d[kk], opt.ew.period[kk]);
          }
          multipole(d, cm, qs, quad, acc3, pot);
          if (ewald) {
            T ex, ey, ez, ep;
            ewald_corr(opt.ew, d, ex, ey, ez, ep);
            acc3[0] += cm * ex;
            acc3[1] += cm * ey;
            acc3[2] += cm * ez;
            pot += cm * ep;
          }
        }
      }
      const int rank = __popc(omask & ((1u << lane) - 1u));
      if (!at_leaves) {
        const int pos = nnext + 2 * rank;
        if (opn && pos < cap) nxt[pos] = 2 * cell;
        if (opn && pos + 1 < cap) nxt[pos + 1] = 2 * cell + 1;
        nnext += 2 * __popc(omask);
      } else {
        const int pos = nnext + rank;
        if (opn && pos < cap) near_g[pos] = cell;
        nnext += __popc(omask);
      }
    }
    ovf = ovf || nnext > cap;
    ncur = nnext < cap ? nnext : cap;
    __syncwarp();
    int* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int w = ncur + lane; w < near_cap; w += kLeaf) near_g[w] = -1;
  if (kFast) {
    T vals[kFastCols] = {acc3[0], acc3[1], acc3[2], pot};
#pragma unroll
    for (int i = 0; i < 9; ++i) vals[4 + i] = jac[i];
#pragma unroll
    for (int c = 0; c < kFastCols; ++c) vals[c] = warp_sum(vals[c]);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kFastCols; ++c) fast_out[kFastCols * g + c] = vals[c];
    }
  } else {
    // every slot of a live group, a dead one too (K7 writes the mapped
    // slots: a dead particle gets the field at its frozen position, as
    // in the JAX package)
    a_far[3 * slot] = acc3[0];
    a_far[3 * slot + 1] = acc3[1];
    a_far[3 * slot + 2] = acc3[2];
    pot_far[slot] = pot;
  }
  if (ovf && lane == 0) *overflow = 1;
}

template <typename T>
int run_walk(const T* ctab, const T* ptab, const unsigned char* alive,
             const int* group_ids, int n_groups, int depth, int near_cap,
             const int* level_caps, double theta_sqd, int quadrupole,
             int fast, int mac, double macerror, const T* gfac,
             const T* ewald_tab, const double* ewald_meta, T* a_far,
             T* pot_far, T* fast_out, int* near, unsigned char* overflow,
             int device, void* stream_ptr) {
  if (depth < 0 || depth > kMaxLevels || near_cap < 1 || mac < 0 || mac > 2
      || (mac != 0 && gfac == nullptr)
      || (fast ? fast_out == nullptr : (a_far == nullptr || pot_far == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  LevelCaps caps = {};
  int wmax = 1;
  for (int ell = 1; ell <= depth; ++ell) {
    caps.w[ell] = level_caps[ell];
    wmax = level_caps[ell] > wmax ? level_caps[ell] : wmax;
  }
  WalkOpts<T> opt = {};
  opt.quadrupole = quadrupole;
  opt.mac = mac;
  opt.macerror = T(macerror);
  opt.gfac = gfac;
  opt.ew = ewald_from_meta<T>(ewald_tab, ewald_meta);
  const bool ewald = opt.ew.tab != nullptr;
  auto kernel = ewald ? (fast ? tree_walk_kernel<T, true, true>
                              : tree_walk_kernel<T, true, false>)
                      : (fast ? tree_walk_kernel<T, false, true>
                              : tree_walk_kernel<T, false, false>);
  // two frontier buffers per warp; fewer warps per block when they are
  // wide, and more than the default 48 KB only when one warp needs it
  const size_t per_warp = 2 * sizeof(int) * static_cast<size_t>(wmax);
  int warps = 4;
  while (warps > 1 && warps * per_warp > 48 * 1024) warps /= 2;
  const size_t smem = warps * per_warp;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int groups = group_ids != nullptr ? n_groups : 1 << depth;
  if (groups > 0)
    kernel<<<(groups + warps - 1) / warps, warps * kLeaf, smem, stream>>>(
        ctab, ptab, alive, group_ids, groups, depth, near_cap, wmax,
        T(theta_sqd), opt, caps, a_far, pot_far, fast_out, near, overflow);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define TREE_WALK_ENTRY(NAME, T)                                            \
  int NAME(const T* ctab, const T* ptab, const unsigned char* alive,        \
           const int* group_ids, int n_groups, int depth, int near_cap,     \
           const int* level_caps, double theta_sqd, int quadrupole,         \
           int fast, int mac, double macerror, const T* gfac,               \
           const T* ewald_tab, const double* ewald_meta, T* a_far,          \
           T* pot_far, T* fast_out, int* near, unsigned char* overflow,     \
           int device, void* stream) {                                      \
    return run_walk<T>(ctab, ptab, alive, group_ids, n_groups, depth,       \
                       near_cap, level_caps, theta_sqd, quadrupole, fast,   \
                       mac, macerror, gfac, ewald_tab, ewald_meta, a_far,   \
                       pot_far, fast_out, near, overflow, device, stream);  \
  }

TREE_WALK_ENTRY(tree_walk_f32, float)
TREE_WALK_ENTRY(tree_walk_f64, double)

}  // extern "C"
