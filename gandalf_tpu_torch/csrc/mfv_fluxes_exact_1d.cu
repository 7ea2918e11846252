// K12 mfv_fluxes in 1D with the exact Riemann solver
// (riemann_exact.cuh); mfv_fluxes.cuh holds the kernel and its notes.
#include "mfv_fluxes.cuh"

MFV_FLUXES_ENTRY(mfv_fluxes_exact_1d_f32, float, mfv_k12::kExact, 1)
MFV_FLUXES_ENTRY(mfv_fluxes_exact_1d_f64, double, mfv_k12::kExact, 1)
