// K6 tree_walk in 3D; tree_walk.cuh holds the kernel and its notes.
#include "tree_walk.cuh"

TREE_WALK_ENTRY(tree_walk_3d_f32, float, 3)
TREE_WALK_ENTRY(tree_walk_3d_f64, double, 3)
