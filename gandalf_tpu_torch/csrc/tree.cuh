// Layouts and warp helpers shared by the tree kernels K4-K7.
//
// Slot table ptab (G*32, 6): x, y, z, m, h, zh per bucket slot, bucket
// order; alive (G*32) bytes.  Cell table ctab (2^(D+1) - 1, 16): row
// (1 << l) - 1 + c is cell c of level l, columns m, com(3), half(3),
// q6(6: 00 01 02 11 12 22), centre(3).  The layouts are those of
// gandalf_tpu_torch/ops/tree.py.  Every kernel works with one warp per
// bucket of 32 slots, lane = slot.
#pragma once

#include <cuda_runtime.h>

namespace tree {

constexpr int kLeaf = 32;
constexpr int kPCols = 6;
constexpr int kCCols = 16;
enum PCol { kPX = 0, kPM = 3, kPH = 4, kPZH = 5 };
enum CCol { kCM = 0, kCCom = 1, kCHalf = 4, kCQ = 7, kCCen = 13 };
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
