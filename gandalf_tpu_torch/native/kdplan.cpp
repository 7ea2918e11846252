// Native host-side planners of the gravity tree: the part of the JAX
// package's gandalf_tpu/native/kdplan.cpp that the port runs, copied.
//
// The planning passes (the analogue of KDTree::BuildTree's recursive
// longest-axis median splits, reference src/Tree/KDTree.cpp:442-595, and
// the walk statistics that size the device walk's caps) are
// latency-critical CPU code that runs every tree-rebuild cadence.  A numpy
// implementation needs seconds per million particles; this C++ version is
// O(N log G) with nth_element and runs in tens of milliseconds.
//
// Exposed as a plain C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Task {
  int64_t lo, hi;   // particle index range [lo, hi)
  double box_lo[8];
  double box_hi[8];
};

}  // namespace

extern "C" {

// KD bucket planner: splits [0, N) by longest-axis medians until every
// bucket holds <= leaf_size particles.  Writes bucket-major particle ids
// into gmap (G_pad x leaf_size, -1 padded) and returns the number of
// buckets used, or -1 if G_pad is too small.
//
//   r         : (N x ndim) float64 positions
//   idx_tmp   : (N,) int64 scratch (any contents)
//   gmap      : (G_pad * leaf_size) int32, pre-filled with -1 by caller
int64_t kd_plan_buckets(const double* r, int64_t N, int32_t ndim,
                        int32_t leaf_size, int32_t* gmap, int64_t G_pad) {
  if (N <= 0 || ndim <= 0 || leaf_size <= 0 || ndim > 8) return 0;
  std::vector<int64_t> idx(N);
  for (int64_t i = 0; i < N; ++i) idx[i] = i;

  // root bounding box (the only full scan; children use split-plane boxes,
  // which are exact enough for axis choice — the device-side stocking
  // recomputes tight boxes from live particle positions anyway)
  Task root{0, N, {}, {}};
  for (int k = 0; k < ndim; ++k) {
    root.box_lo[k] = 1e300;
    root.box_hi[k] = -1e300;
  }
  for (int64_t i = 0; i < N; ++i) {
    const double* p = r + i * ndim;
    for (int k = 0; k < ndim; ++k) {
      if (p[k] < root.box_lo[k]) root.box_lo[k] = p[k];
      if (p[k] > root.box_hi[k]) root.box_hi[k] = p[k];
    }
  }

  std::vector<Task> stack;
  stack.push_back(root);
  int64_t next_bucket = 0;

  while (!stack.empty()) {
    Task t = stack.back();
    stack.pop_back();
    const int64_t n = t.hi - t.lo;
    if (n <= leaf_size) {
      if (next_bucket >= G_pad) return -1;
      int32_t* row = gmap + next_bucket * leaf_size;
      for (int64_t i = 0; i < n; ++i)
        row[i] = static_cast<int32_t>(idx[t.lo + i]);
      ++next_bucket;
      continue;
    }
    int axis = 0;
    double best = -1.0;
    for (int k = 0; k < ndim; ++k) {
      const double ext = t.box_hi[k] - t.box_lo[k];
      if (ext > best) {
        best = ext;
        axis = k;
      }
    }
    const int64_t mid = t.lo + (n + 1) / 2;
    std::nth_element(idx.begin() + t.lo, idx.begin() + mid,
                     idx.begin() + t.hi,
                     [r, ndim, axis](int64_t a, int64_t b) {
                       return r[a * ndim + axis] < r[b * ndim + axis];
                     });
    const double split = r[idx[mid] * ndim + axis];
    Task upper = t;
    upper.lo = mid;
    upper.box_lo[axis] = split;
    Task lower = t;
    lower.hi = mid;
    lower.box_hi[axis] = split;
    // push upper half first so the lower half is processed next (keeps
    // bucket ids in near-spatial order for the implicit pairing above)
    stack.push_back(upper);
    stack.push_back(lower);
  }
  return next_bucket;
}

}  // extern "C"

namespace {

// Bottom-up level tables: per cell lo/hi box, COM, mass, hmax.
struct Level {
  std::vector<double> lo, hi, com;
  std::vector<double> mass, hmax;
};

// Builds the implicit binary tree's per-level cell properties from the
// bucket gather map.
// Returns depth, or -1 when G_pad is not a power of two.
int build_levels(const double* r, const double* m, const double* h,
                 int32_t ndim, const int32_t* gmap, int64_t G_pad,
                 int32_t leaf_size, std::vector<Level>& levels) {
  int depth = 0;
  while ((int64_t(1) << depth) < G_pad) ++depth;
  if ((int64_t(1) << depth) != G_pad) return -1;
  levels.assign(depth + 1, Level());
  Level& leaf = levels[depth];
  leaf.lo.assign(G_pad * ndim, 1e300);
  leaf.hi.assign(G_pad * ndim, -1e300);
  leaf.com.assign(G_pad * ndim, 0.0);
  leaf.mass.assign(G_pad, 0.0);
  leaf.hmax.assign(G_pad, 0.0);
  for (int64_t g = 0; g < G_pad; ++g) {
    double msum = 0.0;
    for (int32_t s = 0; s < leaf_size; ++s) {
      const int32_t pid = gmap[g * leaf_size + s];
      if (pid < 0) continue;
      const double* p = r + int64_t(pid) * ndim;
      const double mi = m ? m[pid] : 1.0;
      msum += mi;
      for (int k = 0; k < ndim; ++k) {
        if (p[k] < leaf.lo[g * ndim + k]) leaf.lo[g * ndim + k] = p[k];
        if (p[k] > leaf.hi[g * ndim + k]) leaf.hi[g * ndim + k] = p[k];
        leaf.com[g * ndim + k] += mi * p[k];
      }
      if (h && h[pid] > leaf.hmax[g]) leaf.hmax[g] = h[pid];
    }
    leaf.mass[g] = msum;
    if (msum > 0.0)
      for (int k = 0; k < ndim; ++k) leaf.com[g * ndim + k] /= msum;
  }
  for (int ell = depth - 1; ell >= 0; --ell) {
    const Level& ch = levels[ell + 1];
    Level& pa = levels[ell];
    const int64_t n = int64_t(1) << ell;
    pa.lo.assign(n * ndim, 1e300);
    pa.hi.assign(n * ndim, -1e300);
    pa.com.assign(n * ndim, 0.0);
    pa.mass.assign(n, 0.0);
    pa.hmax.assign(n, 0.0);
    for (int64_t c = 0; c < n; ++c) {
      for (int child = 0; child < 2; ++child) {
        const int64_t cc = 2 * c + child;
        if (ch.mass[cc] <= 0.0) continue;
        pa.mass[c] += ch.mass[cc];
        if (ch.hmax[cc] > pa.hmax[c]) pa.hmax[c] = ch.hmax[cc];
        for (int k = 0; k < ndim; ++k) {
          if (ch.lo[cc * ndim + k] < pa.lo[c * ndim + k])
            pa.lo[c * ndim + k] = ch.lo[cc * ndim + k];
          if (ch.hi[cc * ndim + k] > pa.hi[c * ndim + k])
            pa.hi[c * ndim + k] = ch.hi[cc * ndim + k];
          pa.com[c * ndim + k] += ch.mass[cc] * ch.com[cc * ndim + k];
        }
      }
      if (pa.mass[c] > 0.0)
        for (int k = 0; k < ndim; ++k) pa.com[c * ndim + k] /= pa.mass[c];
    }
  }
  return depth;
}

}  // namespace

extern "C" {

// Walk-statistics pass: simulates the device's implicit-tree MAC walk
// (the frontier walk of ops/tree.py) over a strided sample of target
// groups and reports the worst-case frontier width, near-field leaf count
// and kernel-support leaf count actually NEEDED by this particle
// distribution.  Used at plan time to size TreeSpec caps from measurement
// instead of the conservative worst-case law (reference analogue: the
// Nneibmax growth loop, src/GradhSph/GradhSphTree.cpp:172-185, which also
// sizes buffers from observed demand).
//
//   r       : (N x ndim) float64 positions
//   m       : (N,) float64 masses, or nullptr (all occupied slots count)
//   h       : (N,) float64 smoothing lengths, or nullptr (sup_max = 0)
//   gmap    : (G_pad x leaf_size) int32 bucket map, -1 = empty slot
//   sample  : walk every `stride`-th occupied group so that about `sample`
//             groups are visited (<= 0 means walk all groups)
//   out3    : int32[3] = {near_max, front_max, sup_max}
//   out_levels : int32[depth+1], the maximum frontier width ENTERING
//             each tree level over the sampled groups (out_levels[0] ==
//             1, the root)
// Returns 0 on success.
int64_t tree_walk_stats_levels(const double* r, const double* m,
                               const double* h, int64_t N, int32_t ndim,
                               const int32_t* gmap, int64_t G_pad,
                               int32_t leaf_size, double theta_sqd,
                               double kernrange, int64_t sample,
                               int32_t* out3, int32_t* out_levels) {
  out3[0] = out3[1] = out3[2] = 0;
  if (G_pad <= 0 || ndim <= 0 || ndim > 8) return -1;
  std::vector<Level> levels;
  const int depth = build_levels(r, m, h, ndim, gmap, G_pad, leaf_size,
                                 levels);
  if (depth < 0) return -1;
  const Level& leaf = levels[depth];
  for (int ell = 0; ell <= depth; ++ell) out_levels[ell] = 0;

  int64_t n_occ = 0;
  for (int64_t g = 0; g < G_pad; ++g)
    if (leaf.mass[g] > 0.0) ++n_occ;
  if (n_occ == 0) return 0;
  const int64_t stride =
      (sample <= 0 || sample >= n_occ) ? 1 : (n_occ + sample - 1) / sample;

  int32_t near_max = 0, front_max = 1, sup_max = 0;
  out_levels[0] = 1;
  std::vector<int64_t> front, next;
  int64_t visited = 0;
  for (int64_t g = 0; g < G_pad; ++g) {
    if (leaf.mass[g] <= 0.0) continue;
    if ((visited++) % stride) continue;
    double gc[8], gh[8];
    for (int k = 0; k < ndim; ++k) {
      gc[k] = 0.5 * (leaf.lo[g * ndim + k] + leaf.hi[g * ndim + k]);
      gh[k] = 0.5 * (leaf.hi[g * ndim + k] - leaf.lo[g * ndim + k]);
    }
    const double hg_max = leaf.hmax[g];
    front.assign(1, 0);
    for (int ell = 0; ell <= depth; ++ell) {
      const Level& lv = levels[ell];
      next.clear();
      int32_t n_near = 0, n_sup = 0;
      for (const int64_t c : front) {
        if (lv.mass[c] <= 0.0) continue;
        double dsqd = 0.0, rmax_sqd = 0.0;
        for (int k = 0; k < ndim; ++k) {
          const double half =
              0.5 * (lv.hi[c * ndim + k] - lv.lo[c * ndim + k]);
          double d = std::abs(lv.com[c * ndim + k] - gc[k]) - gh[k];
          if (d < 0.0) d = 0.0;
          dsqd += d * d;
          rmax_sqd += half * half;
        }
        if (dsqd * theta_sqd > rmax_sqd) continue;
        if (ell < depth) {
          next.push_back(2 * c);
          next.push_back(2 * c + 1);
        } else {
          ++n_near;
          if (h) {
            double gap2 = 0.0;
            for (int k = 0; k < ndim; ++k) {
              const double half =
                  0.5 * (lv.hi[c * ndim + k] - lv.lo[c * ndim + k]);
              const double centre =
                  0.5 * (lv.hi[c * ndim + k] + lv.lo[c * ndim + k]);
              double d = std::abs(centre - gc[k]) - half - gh[k];
              if (d < 0.0) d = 0.0;
              gap2 += d * d;
            }
            const double hm = hg_max > lv.hmax[c] ? hg_max : lv.hmax[c];
            const double rad = kernrange * hm;
            if (gap2 < rad * rad) ++n_sup;
          }
        }
      }
      if (ell < depth) {
        const int32_t w = static_cast<int32_t>(next.size());
        if (w > front_max) front_max = w;
        if (w > out_levels[ell + 1]) out_levels[ell + 1] = w;
        front.swap(next);
      } else {
        if (n_near > near_max) near_max = n_near;
        if (n_sup > sup_max) sup_max = n_sup;
      }
    }
  }
  out3[0] = near_max;
  out3[1] = front_max;
  out3[2] = sup_max;
  return 0;
}

}  // extern "C"
