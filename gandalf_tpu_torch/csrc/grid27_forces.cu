// K3 grid27_forces: grad-h SPH pair forces over the 27-cell stencil.
//
// Replaces gandalf_tpu/ops/sph_grid27.py:forces_grid27 and _force_shifts
// (:528-734), which evaluate one (cells, K, 27K) pair block per slab of
// cells from ghost-layer copies, with pair distances and (v_j-v_i).(r_j-r_i)
// taken from a dot-product expansion that keeps the TPU's matrix unit busy.
//
// Bound on the card: pair arithmetic.  One pass is about 4.6e8 pair
// candidates at 262,144 particles, each loading 15 values of its
// neighbour (position, velocity, nine scalars) and, inside the support,
// costing two kernel derivatives, a square root and several divisions.
//
// Design: one block per cell and one thread per slot, as in K2.  A thread
// sums its particle's acceleration, du/dt and -sum m_j dvdr W'_i over the
// 27 neighbour cells in registers.  Pair separations and dvdr are computed
// directly (no expansion, so no cancellation floor is needed): a pair
// counts when the neighbour slot is filled, is not the particle itself
// (same slot of the cell's own shift, d = 13) and does not coincide with
// it (d^2 > 0).  Viscosity (mon97, or mm97 with per-particle alpha) acts
// on approaching pairs with the signal velocity; the Wadsley (2008) and
// Price (2008) conductivities are selected by integer arguments.  The
// epilogue (div_v normalisation, -P div_v term, MM97 dalpha/dt) stays
// elementwise torch.  No shared-memory staging yet: that is later work.
#include <cuda_runtime.h>

#include "grid27.cuh"
#include "m4.cuh"

namespace {

// dissipation codes of gandalf_tpu_torch/ops/forces.py
constexpr int kAviscNone = 0;
constexpr int kAviscMon97 = 1;
constexpr int kAcondWadsley2008 = 1;
constexpr int kAcondPrice2008 = 2;

// packed per-slot scalars, ops/sph_grid27.py:FORCE_SCALARS
enum Scalar { kM, kH, kRho, kU, kPress, kSound, kInvom, kHfac, kAlpha,
              kNScalars };

template <typename T>
__global__ void __launch_bounds__(256) grid27_forces_kernel(
    const T* __restrict__ r, const T* __restrict__ v,
    const T* __restrict__ pk, const unsigned char* __restrict__ fill,
    Grid3 g, T norm, int avisc, int acond, T alpha_visc, T beta_visc,
    T* __restrict__ a_out, T* __restrict__ dudt_out,
    T* __restrict__ divv_out) {
  const int c = blockIdx.x;
  const int K = g.K;
  int cc[3];
  cell_coords(g, c, cc);
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const long long p = static_cast<long long>(c) * K + i;
    if (!fill[p]) {
      a_out[3 * p] = a_out[3 * p + 1] = a_out[3 * p + 2] = T(0);
      dudt_out[p] = T(0);
      divv_out[p] = T(0);
      continue;
    }
    const T xi = r[3 * p], yi = r[3 * p + 1], zi = r[3 * p + 2];
    const T vxi = v[3 * p], vyi = v[3 * p + 1], vzi = v[3 * p + 2];
    const T* si = pk + kNScalars * p;
    const T invh_i = T(1) / max(si[kH], T(1e-30));
    const T invrho_i = T(1) / max(si[kRho], T(1e-300));
    const T press_i = si[kPress], sound_i = si[kSound], u_i = si[kU];
    const T hfac_i = si[kHfac], alpha_i = si[kAlpha];
    const T pterm_i = press_i * si[kInvom] * invrho_i * invrho_i;
    T ax = T(0), ay = T(0), az = T(0), dudt = T(0), divv = T(0);
    for (int d = 0; d < 27; ++d) {
      int nc;
      T sh[3];
      if (!neighbour_cell<T>(g, cc, d, &nc, sh)) continue;
      const long long q0 = static_cast<long long>(nc) * K;
      for (int j = 0; j < K; ++j) {
        const long long q = q0 + j;
        if (!fill[q] || (d == 13 && j == i)) continue;
        const T dx = (r[3 * q] + sh[0]) - xi;
        const T dy = (r[3 * q + 1] + sh[1]) - yi;
        const T dz = (r[3 * q + 2] + sh[2]) - zi;
        const T drsqd = dx * dx + dy * dy + dz * dz;
        if (!(drsqd > T(0))) continue;
        const T drmag = sqrt(drsqd);
        const T inv_drmag = T(1) / drmag;
        const T* sj = pk + kNScalars * q;
        const T m_j = sj[kM];
        const T invrho_j = T(1) / sj[kRho];
        const T wkerni = hfac_i * m4_w1<T>(drmag * invh_i, norm);
        const T wkernj = sj[kHfac] * m4_w1<T>(drmag / sj[kH], norm);
        const T dvdr = ((v[3 * q] - vxi) * dx + (v[3 * q + 1] - vyi) * dy
                        + (v[3 * q + 2] - vzi) * dz) * inv_drmag;
        divv -= m_j * dvdr * wkerni;
        T paux = pterm_i * wkerni
                 + sj[kPress] * sj[kInvom] * invrho_j * invrho_j * wkernj;
        if (avisc != kAviscNone && dvdr < T(0)) {
          const T winvrho = T(0.25) * (wkerni + wkernj)
                            * (invrho_i + invrho_j);
          const T alpha_eff = avisc == kAviscMon97
                                  ? alpha_visc
                                  : T(0.5) * (alpha_i + sj[kAlpha]);
          const T vsignal = sound_i + sj[kSound]
                            - beta_visc * alpha_eff * dvdr;
          paux -= alpha_eff * vsignal * dvdr * winvrho;
          dudt -= T(0.5) * m_j * alpha_eff * vsignal * dvdr * dvdr * winvrho;
          if (acond == kAcondWadsley2008) {
            dudt += m_j * dvdr * (sj[kU] - u_i)
                    * (invrho_i * wkerni + invrho_j * wkernj);
          } else if (acond == kAcondPrice2008) {
            dudt += T(0.5) * m_j * (u_i - sj[kU]) * winvrho
                    * (invrho_i + invrho_j)
                    * sqrt(fabs(press_i - sj[kPress]));
          }
        }
        const T w_pair = m_j * paux * inv_drmag;
        ax += w_pair * dx;
        ay += w_pair * dy;
        az += w_pair * dz;
      }
    }
    a_out[3 * p] = ax;
    a_out[3 * p + 1] = ay;
    a_out[3 * p + 2] = az;
    dudt_out[p] = dudt;
    divv_out[p] = divv;
  }
}

template <typename T>
int run_forces(const T* r, const T* v, const T* pk,
               const unsigned char* fill, int n0, int n1, int n2,
               int k_cell, int per0, int per1, int per2, double L0,
               double L1, double L2, double norm, int avisc, int acond,
               double alpha_visc, double beta_visc, T* a, T* dudt, T* div_v,
               int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Grid3 g = {{n0, n1, n2}, {per0, per1, per2}, {L0, L1, L2}, k_cell};
  const int n_cells = n0 * n1 * n2;
  if (n_cells > 0 && k_cell > 0)
    grid27_forces_kernel<T><<<n_cells, slot_threads(k_cell), 0, stream>>>(
        r, v, pk, fill, g, T(norm), avisc, acond, T(alpha_visc),
        T(beta_visc), a, dudt, div_v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define GRID27_FORCES_ENTRY(NAME, T)                                        \
  int NAME(const T* r, const T* v, const T* pk, const unsigned char* fill,  \
           int n0, int n1, int n2, int k_cell, int per0, int per1,          \
           int per2, double L0, double L1, double L2, double norm,          \
           int avisc, int acond, double alpha_visc, double beta_visc,       \
           T* a, T* dudt, T* div_v, int device, void* stream) {             \
    return run_forces<T>(r, v, pk, fill, n0, n1, n2, k_cell, per0, per1,    \
                         per2, L0, L1, L2, norm, avisc, acond, alpha_visc,  \
                         beta_visc, a, dudt, div_v, device, stream);        \
  }

GRID27_FORCES_ENTRY(grid27_forces_f32, float)
GRID27_FORCES_ENTRY(grid27_forces_f64, double)

}  // extern "C"
