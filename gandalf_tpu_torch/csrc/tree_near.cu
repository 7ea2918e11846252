// K7 tree_near in 3D; tree_near.cuh holds the kernel and its notes.
#include "tree_near.cuh"

TREE_NEAR_ENTRY(tree_near_3d_f32, float, 3)
TREE_NEAR_ENTRY(tree_near_3d_f64, double, 3)
