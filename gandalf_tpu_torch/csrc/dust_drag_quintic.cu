// K23 dust_drag_sums and K24 dust_drag_deposit with the quintic kernel,
// direct and tabulated; dust_drag.cuh holds the kernels and their notes.
#include "dust_drag.cuh"

DUST_DRAG_FAMILY(quintic, kf::kQuintic)
