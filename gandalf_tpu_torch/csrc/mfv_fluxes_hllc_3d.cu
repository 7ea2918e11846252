// K12 mfv_fluxes in 3D with the HLLC Riemann solver; mfv_fluxes.cuh
// holds the kernel and its notes.
#include "mfv_fluxes.cuh"

MFV_FLUXES_ENTRY(mfv_fluxes_hllc_3d_f32, float, mfv_k12::kHllc, 3)
MFV_FLUXES_ENTRY(mfv_fluxes_hllc_3d_f64, double, mfv_k12::kHllc, 3)
