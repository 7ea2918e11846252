// K6 tree_walk in 2D; tree_walk.cuh holds the kernel and its notes.
#include "tree_walk.cuh"

TREE_WALK_ENTRY(tree_walk_2d_f32, float, 2)
TREE_WALK_ENTRY(tree_walk_2d_f64, double, 2)
