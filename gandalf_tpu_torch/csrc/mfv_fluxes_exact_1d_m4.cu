// K12 mfv_fluxes in 1D with the exact Riemann solver and the M4
// kernel, direct and tabulated; mfv_fluxes.cuh holds the kernel and its
// notes.
#include "mfv_fluxes.cuh"

MFV_FLUXES_FAMILY(exact, mfv_k12::kExact, 1, m4, kf::kM4)
