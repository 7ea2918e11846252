// Layouts and warp helpers shared by the tree kernels K4-K7.
//
// The tables are those of gandalf_tpu_torch/ops/tree.py, in NDIM = 1, 2
// or 3 dims (Layout<NDIM>).  Slot table ptab (G*32, NDIM + 3): x[NDIM],
// m, h, zh per bucket slot, bucket order; alive (G*32) bytes.  Cell
// table ctab (2^(D+1) - 1, 1 + 3 NDIM + NDIM (NDIM + 1) / 2): row
// (1 << l) - 1 + c is cell c of level l, columns m, com[NDIM],
// half[NDIM], the quadrupole's upper triangle row by row (the JAX
// package's `tri` order, gandalf_tpu/ops/tree.py:342: 00 01 02 11 12 22
// in 3D, 00 01 11 in 2D, 00 in 1D) and centre[NDIM]: 16, 10 and 5
// columns.  The fast multipoles' expansion of a group: a0[NDIM], pot0
// and the Jacobian row by row, 13, 7 and 3 columns.  Every kernel works
// with one warp per bucket of 32 slots, lane = slot.
#pragma once

#include <cuda_runtime.h>

namespace tree {

constexpr int kLeaf = 32;

template <int NDIM>
struct Layout {
  static_assert(NDIM >= 1 && NDIM <= 3, "the tree takes 1-3 dims");
  static constexpr int kNQ = NDIM * (NDIM + 1) / 2;
  // slot table
  static constexpr int kPCols = NDIM + 3;
  static constexpr int kPX = 0, kPM = NDIM, kPH = NDIM + 1, kPZH = NDIM + 2;
  // cell table
  static constexpr int kCM = 0, kCCom = 1, kCHalf = 1 + NDIM;
  static constexpr int kCQ = 1 + 2 * NDIM, kCCen = 1 + 2 * NDIM + kNQ;
  static constexpr int kCCols = kCCen + NDIM;
  // a group's fast expansion
  static constexpr int kFastCols = NDIM + 1 + NDIM * NDIM;
};

// column of Q_ij (i <= j) in the quadrupole's upper triangle
template <int NDIM>
__host__ __device__ constexpr int tri(int i, int j) {
  return i * NDIM - i * (i - 1) / 2 + (j - i);
}

constexpr unsigned kFull = 0xffffffffu;
// far sentinel of empty cells, and the bound for min/max over live slots
constexpr double kFar = 1e15;
constexpr double kBig = 1e30;
// deepest tree the kernels take (level caps are passed by value)
constexpr int kMaxLevels = 40;

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T>
__device__ __forceinline__ T warp_min(T x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

template <typename T>
__device__ __forceinline__ T warp_max(T x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// round-to-nearest arithmetic that the compiler may not contract into
// an FMA, for results that must equal the plain version bit for bit
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

}  // namespace tree
