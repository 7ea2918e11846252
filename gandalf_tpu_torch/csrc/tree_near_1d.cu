// K7 tree_near in 1D; tree_near.cuh holds the kernel and its notes.
#include "tree_near.cuh"

TREE_NEAR_ENTRY(tree_near_1d_f32, float, 1)
TREE_NEAR_ENTRY(tree_near_1d_f64, double, 1)
