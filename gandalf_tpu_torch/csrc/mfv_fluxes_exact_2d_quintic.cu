// K12 mfv_fluxes in 2D with the exact Riemann solver and the quintic
// kernel, direct and tabulated; mfv_fluxes.cuh holds the kernel and its
// notes.
#include "mfv_fluxes.cuh"

MFV_FLUXES_FAMILY(exact, mfv_k12::kExact, 2, quintic, kf::kQuintic)
