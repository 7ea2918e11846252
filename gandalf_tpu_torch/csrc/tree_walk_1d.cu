// K6 tree_walk in 1D; tree_walk.cuh holds the kernel and its notes.
#include "tree_walk.cuh"

TREE_WALK_ENTRY(tree_walk_1d_f32, float, 1)
TREE_WALK_ENTRY(tree_walk_1d_f64, double, 1)
