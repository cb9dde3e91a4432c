// lj/cut force-only pass over the cell-major grid, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of the JAX package's sorted path,
// which compute the same forces and differ only in how they tile TPU VMEM:
//   K1 column_half_force_pallas  lammps_kokkos_port_tpu/ops/pallas_pair.py:319
//      (kernel _column_half_kernel :215-315, pallas_call :331)
//   K2 slab_half_force_pallas    pallas_pair.py:659
//      (kernel _slab_half_kernel :532-629, pallas_call :645)
//   K3 plane_force_pallas        pallas_pair.py:811
//      (kernel _slab_kernel :728-787, pallas_call :799)
// The full 27-cell stencil with no Newton halving, as K3 does. One thread
// owns one row and writes its sum once: deterministic, no atomics. (K1/K2
// add reactions into other columns without atomics, which is safe only
// because the TPU grid runs sequentially.)
//
// What bounds it on this card: issue slots and latency, not bytes (the
// bound of the 1M pass is 0.0116 ms of bytes). The first design
// (cell_stencil.cuh's sweep, 1.236 ms at 1M f32 on an H100, about 26
// issue slots per warp and stencil candidate at 132 SMs x 4 schedulers x
// 1.75 GHz) walked all 27 * cc candidates in every lane, pads included,
// three 4-byte shared loads each, with the pair body inside the loop: with
// about 20 live lanes the warp took the body for most candidates, though
// about 6% of the lane-candidates were inside the cutoff.
//
// Design (cell_walk.cuh), measured against the first design and against
// variants of itself in PERF.md section 6: one warp per cell (32 rows a
// pass), no block barrier; the neighbour blocks' positions copied with
// cp.async a batch ahead; only live candidates within the cutoff of the
// warp's own rows' bounding box are staged (none of the pads); staged
// plane by plane; r2 for every staged candidate in pass 1, the lj body
// only over each lane's in-cutoff list in pass 2. At 1M f32 it takes about
// 0.70 ms on an H100, about 15 issue slots per warp and stencil candidate
// on the same reckoning. Three warps sharing one cell's walk were slower
// at both deck sizes.
//
// Pads are told by position and skipped where the box keeps them out of
// every cutoff (sorted_grid.cuh: the premise, its conditions (a)-(c), and
// the walk of every row where (b) or (c) fails). r2 is formed with
// explicitly rounded multiplies and adds (no fused multiply-add), as the
// plain PyTorch version rounds it, so both make the same cutoff decisions;
// only the order of the force sums differs.

#include "sorted_grid.cuh"

namespace {

using Geo32 = sorted_grid::SortedGrid<float, 3>;
using Geo64 = sorted_grid::SortedGrid<double, 3>;

template <typename T>
__global__ void CELL_WALK_BOUNDS lj_cell_force_kernel(
    const T* __restrict__ gx, const T* __restrict__ gy,
    const T* __restrict__ gz, const T* __restrict__ prd,
    T* __restrict__ fx, T* __restrict__ fy, T* __restrict__ fz,
    int nx, int ny, int nz, int cc, T lj1, T lj2, T cutsq) {
  sorted_grid::walk_rows<T, 3>(
      {gx, gy, gz, nullptr}, prd, nx, ny, nz, cc, cutsq,
      cell_walk::LjBody<T>{lj1, lj2},
      [=](int row, const T (&acc)[3]) {
        fx[row] = acc[0];
        fy[row] = acc[1];
        fz[row] = acc[2];
      });
}

template <typename T>
int launch(const void* gx, const void* gy, const void* gz, const void* prd,
           void* fx, void* fy, void* fz, int nx, int ny, int nz, int cc,
           double lj1, double lj2, double cutsq, void* stream) {
  const cell_walk::Launch L =
      cell_walk::launch_shape<T, sorted_grid::SortedGrid<T, 3>>(
          nx * ny * nz);
  lj_cell_force_kernel<T><<<L.grid, L.block, L.smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gx), static_cast<const T*>(gy),
      static_cast<const T*>(gz), static_cast<const T*>(prd),
      static_cast<T*>(fx), static_cast<T*>(fy), static_cast<T*>(fz), nx, ny,
      nz, cc, static_cast<T>(lj1), static_cast<T>(lj2),
      static_cast<T>(cutsq));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Launch on `stream`, do not
// synchronise; return cudaGetLastError() after the launch (0 = success).
extern "C" int lj_cell_force_f32(const void* gx, const void* gy,
                                 const void* gz, const void* prd, void* fx,
                                 void* fy, void* fz, int nx, int ny, int nz,
                                 int cc, double lj1, double lj2, double cutsq,
                                 void* stream) {
  return launch<float>(gx, gy, gz, prd, fx, fy, fz, nx, ny, nz, cc, lj1, lj2,
                       cutsq, stream);
}

extern "C" int lj_cell_force_f64(const void* gx, const void* gy,
                                 const void* gz, const void* prd, void* fx,
                                 void* fy, void* fz, int nx, int ny, int nz,
                                 int cc, double lj1, double lj2, double cutsq,
                                 void* stream) {
  return launch<double>(gx, gy, gz, prd, fx, fy, fz, nx, ny, nz, cc, lj1,
                        lj2, cutsq, stream);
}

// The launch the kernel makes on `ncell` cells: out[0] blocks, out[1] x
// out[2] threads per block, out[3] dynamic shared memory bytes.
extern "C" int lj_cell_force_shape(int ncell, int f64, int* out) {
  return cell_walk::report_shape<Geo32, Geo64>(ncell, f64, out);
}
