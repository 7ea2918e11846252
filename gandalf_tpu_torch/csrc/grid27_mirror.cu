// K19 grid27_mirror: the reflected image copies of the grid path's mirror
// and wall boundaries, in 1, 2 or 3 dims.
//
// Replaces gandalf_tpu/ops/sph_grid27.py:grid_mirror_extend (:234-256),
// called by _hydro_pass_grid27_mirror (:737): for W walls it writes the
// (1+W) N extended set, copy 0 the particles themselves and copy w their
// reflections in wall w (dim k, plane b): r_k -> 2 b - r_k, v_k -> -v_k,
// every other component unchanged, and the keep mask, alive for copy 0
// and alive & |r_k - b| < rad_w for copy w (rad_w the layers times the
// cell width along k: the image-cell layer beyond the wall).  The
// discarded images are routed away by K1.
//
// Bound on the card: bytes.  Each output element is one read and one
// write, ((1+W) N (2 ndim + 1) values), with one subtraction a
// component; at 262,144 particles and two walls ~3e7 bytes, ~9 us at
// 3.35 TB/s.
//
// Design: one thread per (copy, particle) pair, all copies in one
// launch; the walls' dims, planes and radii come by value in a struct.
// The reflection and the keep test are the plain version's rounded steps
// (the plane 2 b formed in double and cast, as a Python float is), so
// the two agree bit for bit.
#include <cuda_runtime.h>

// the walls, as the wrapper's ctypes structure lays them out
constexpr int kMaxWalls = 6;

struct MirrorWalls {
  int n;
  int dim[kMaxWalls];
  double bound[kMaxWalls];
  double rad[kMaxWalls];
};

namespace {

template <typename T>
__global__ void grid27_mirror_kernel(const T* __restrict__ r,
                                     const T* __restrict__ v,
                                     const unsigned char* __restrict__ alive,
                                     int n_part, int ndim, MirrorWalls w,
                                     T* __restrict__ r_out,
                                     T* __restrict__ v_out,
                                     unsigned char* __restrict__ keep) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (t >= static_cast<long long>(n_part) * (w.n + 1)) return;
  const int copy = static_cast<int>(t / n_part);
  const long long i = t % n_part;
  const bool live = alive == nullptr || alive[i] != 0;
  const int kw = copy > 0 ? w.dim[copy - 1] : -1;
  for (int k = 0; k < ndim; ++k) {
    const T x = r[ndim * i + k];
    const T u = v[ndim * i + k];
    if (k == kw) {
      r_out[ndim * t + k] = T(2.0 * w.bound[copy - 1]) - x;
      v_out[ndim * t + k] = -u;
    } else {
      r_out[ndim * t + k] = x;
      v_out[ndim * t + k] = u;
    }
  }
  bool kept = live;
  if (copy > 0) {
    const T x = r[ndim * i + kw];
    kept = live && fabs(x - T(w.bound[copy - 1])) < T(w.rad[copy - 1]);
  }
  keep[t] = kept ? 1 : 0;
}

template <typename T>
int run_mirror(const T* r, const T* v, const unsigned char* alive,
               int n_part, int ndim, const MirrorWalls* walls, T* r_out,
               T* v_out, unsigned char* keep, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ndim < 1 || ndim > 3 || walls->n < 0 || walls->n > kMaxWalls)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long total = static_cast<long long>(n_part) * (walls->n + 1);
  const int threads = 256;
  if (total > 0)
    grid27_mirror_kernel<T><<<static_cast<int>((total + threads - 1)
                                               / threads),
                              threads, 0, stream>>>(
        r, v, alive, n_part, ndim, *walls, r_out, v_out, keep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define GRID27_MIRROR_ENTRY(NAME, T)                                        \
  int NAME(const T* r, const T* v, const unsigned char* alive, int n_part,  \
           int ndim, const MirrorWalls* walls, T* r_out, T* v_out,          \
           unsigned char* keep, int device, void* stream) {                 \
    return run_mirror<T>(r, v, alive, n_part, ndim, walls, r_out, v_out,    \
                         keep, device, stream);                             \
  }

GRID27_MIRROR_ENTRY(grid27_mirror_f32, float)
GRID27_MIRROR_ENTRY(grid27_mirror_f64, double)

}  // extern "C"
