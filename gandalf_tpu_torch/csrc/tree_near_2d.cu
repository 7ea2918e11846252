// K7 tree_near in 2D; tree_near.cuh holds the kernel and its notes.
#include "tree_near.cuh"

TREE_NEAR_ENTRY(tree_near_2d_f32, float, 2)
TREE_NEAR_ENTRY(tree_near_2d_f64, double, 2)
