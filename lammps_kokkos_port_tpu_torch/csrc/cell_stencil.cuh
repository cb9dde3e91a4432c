// Helpers shared by the port's cell kernels (sm_90a): explicitly rounded
// products and sums (Rn: r2 formed without fused multiply-adds, so it is
// bit-identical to the plain PyTorch versions and both make the same
// cutoff decisions), the half stencil's 14 offsets, the wrap of a
// neighbour index with its +-prd shift, and the launch shape of the
// kernels that give one thread to each row of a cell (lj_ablate.cu's
// asm_only).
//
// Layout: per-row channels (x, y, z, and for some kernels one more per-row
// value) are [ncells, cc] rows, cell id (cx*ny + cy)*nz + cz; padding rows
// hold distinct far-away position sentinels (ops/sortedforce.PAD_POS).

#pragma once

#include <cuda_runtime.h>

namespace cell_stencil {

template <typename T> struct Rn;

template <> struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
};

template <> struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
};

// The half stencil of the JAX package (_HALF,
// lammps_kokkos_port_tpu/ops/pallas_pair.py:208-212), in its order: the own
// cell and the 13 lexicographically positive neighbour offsets, so each
// unordered pair of cells appears once.
constexpr int kHalfBlocks = 14;
__constant__ int kHalf[kHalfBlocks][3] = {
    {0, 0, 0},   {0, 0, 1},   {0, 1, -1},  {0, 1, 0},  {0, 1, 1},
    {1, -1, -1}, {1, -1, 0},  {1, -1, 1},  {1, 0, -1}, {1, 0, 0},
    {1, 0, 1},   {1, 1, -1},  {1, 1, 0},   {1, 1, 1}};

// wrapped neighbour index along one dim and the shift to apply to it
template <typename T>
__device__ __forceinline__ int wrap_dim(int c, int n, T prd, T* shift) {
  if (c < 0) {
    *shift = -prd;
    return c + n;
  }
  if (c >= n) {
    *shift = prd;
    return c - n;
  }
  *shift = T(0);
  return c;
}

// launch shape for cell_cap cc: (lanes, cells per block, blocks)
struct Launch {
  dim3 grid, block;
};

inline Launch launch_shape(int ncell, int cc) {
  const int lanes = ((cc + 31) / 32) * 32;
  const int cpb = lanes >= 128 ? 1 : 128 / lanes;
  return {dim3((ncell + cpb - 1) / cpb), dim3(lanes, cpb)};
}

}  // namespace cell_stencil
