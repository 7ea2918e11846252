// K12 mfv_fluxes in 2D with the HLLC Riemann solver and the M4
// kernel, direct and tabulated; mfv_fluxes.cuh holds the kernel and its
// notes.
#include "mfv_fluxes.cuh"

MFV_FLUXES_FAMILY(hllc, mfv_k12::kHllc, 2, m4, kf::kM4)
