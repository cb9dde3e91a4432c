// The 27-cell stencil walk shared by the port's cell kernels (sm_90a).
//
// Layout: per-row channels (x, y, z, and for some kernels one more per-row
// value) are [ncells, cc] rows, cell id (cx*ny + cy)*nz + cz; padding rows
// hold distinct far-away position sentinels (ops/sortedforce.PAD_POS), so
// they fail any cutoff by distance and need no validity lanes.
//
// Block shape: blockDim.x = `lanes` threads (cc rounded up to a warp), one
// thread per row of a cell; blockDim.y = `cpb` cells per block. For each of
// the 27 neighbour offsets the block stages each cell's neighbour block in
// shared memory, positions shifted by +-prd where the offset wraps across
// the box (no minimum image); every thread of a cell then reads the same
// address (a broadcast) as it walks the cc candidates. One thread owns one
// row and writes its result once: no atomics, deterministic.
//
// r2 is formed with explicitly rounded multiplies and adds (no fused
// multiply-add), so it is bit-identical to the plain PyTorch versions and
// both make the same cutoff decisions.

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

// the row this thread owns
struct Row {
  int row;
  bool row_live;
};

// per-row input channels: x, y, z first, then NCH - 3 plain values
template <typename T, int NCH> struct Channels {
  const T* p[NCH];
};

// Walk the 27 neighbour cells of this thread's cell and call
// pair(dx, dy, dz, r2, stage, j) for every candidate j with r2 < cutsq
// that is not the row itself (with SelfByLane; without it the pair closure
// masks the self pair by its own rule); stage[c * cc + j] holds channel c
// of candidate j (positions already shifted across the box). Loads the own
// row's channels into own[] first. Every thread of the block must call it
// (it synchronises the block).
template <typename T, int NCH, bool SelfByLane = true, typename Pair>
__device__ __forceinline__ Row sweep(const Channels<T, NCH>& ch,
                                     const T* __restrict__ prd, int nx,
                                     int ny, int nz, int cc, T cutsq,
                                     T (&own)[NCH], Pair pair) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage = reinterpret_cast<T*>(smem_raw) + threadIdx.y * NCH * cc;

  const int ncell = nx * ny * nz;
  const int cell = blockIdx.x * blockDim.y + threadIdx.y;
  const bool cell_live = cell < ncell;
  const int lane = threadIdx.x;
  const Row me{cell * cc + lane, cell_live && lane < cc};

  int cx = 0, cy = 0, cz = 0;
  if (cell_live) {
    cz = cell % nz;
    const int t = cell / nz;
    cy = t % ny;
    cx = t / ny;
  }
  const T px = prd[0], py = prd[1], pz = prd[2];
#pragma unroll
  for (int c = 0; c < NCH; ++c) own[c] = me.row_live ? ch.p[c][me.row] : T(0);

  for (int ox = -1; ox <= 1; ++ox) {
    T shx;
    const int wx = wrap_dim(cx + ox, nx, px, &shx);
    for (int oy = -1; oy <= 1; ++oy) {
      T shy;
      const int wy = wrap_dim(cy + oy, ny, py, &shy);
      for (int oz = -1; oz <= 1; ++oz) {
        T shz;
        const int wz = wrap_dim(cz + oz, nz, pz, &shz);
        const int nbase = ((wx * ny + wy) * nz + wz) * cc;
        __syncthreads();  // the previous neighbour block has been read
        if (cell_live) {
          for (int j = lane; j < cc; j += blockDim.x) {
            stage[j] = ch.p[0][nbase + j] + shx;
            stage[cc + j] = ch.p[1][nbase + j] + shy;
            stage[2 * cc + j] = ch.p[2][nbase + j] + shz;
#pragma unroll
            for (int c = 3; c < NCH; ++c)
              stage[c * cc + j] = ch.p[c][nbase + j];
          }
        }
        __syncthreads();
        if (me.row_live) {
          // the self pair sits in the own cell at the own lane
          const int self_lane =
              (SelfByLane && ox == 0 && oy == 0 && oz == 0) ? lane : -1;
          for (int j = 0; j < cc; ++j) {
            const T dx = own[0] - stage[j];
            const T dy = own[1] - stage[cc + j];
            const T dz = own[2] - stage[2 * cc + j];
            const T r2 = Rn<T>::add(Rn<T>::add(Rn<T>::mul(dx, dx),
                                               Rn<T>::mul(dy, dy)),
                                    Rn<T>::mul(dz, dz));
            if (r2 < cutsq && j != self_lane) pair(dx, dy, dz, r2, stage, j);
          }
        }
      }
    }
  }
  return me;
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
