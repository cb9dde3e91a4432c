// lj/cut force-only pass over the full 27-cell stencil, masked by float
// atom ids, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel K7 of the JAX package:
//   column_force_pallas  lammps_kokkos_port_tpu/ops/pallas_pair.py:344
//      (kernel _column_kernel :134-198, pallas_call :354)
// It is not a second launch of lj_cell_force.cu: K7 carries a fourth
// channel, the float id of every row (-1 for padding), and a candidate is
// skipped when its id equals the own row's id (`own_i != ic`, :192), not
// when it sits at the own lane. Any gi the JAX function takes gives its
// result here: two rows with one id never pair, a row's periodic images
// (same id) never pair with it, and pads (id -1, distinct far sentinels)
// die by distance against real rows and by id against each other.
//
// Design: the stencil walk of cell_stencil.cuh with the id as channel 3
// and the lane rule switched off. One thread per row, one block row per
// cell; each of the 27 neighbour blocks is staged in shared memory with
// its +-prd shift where the offset wraps (the per-column shifts and the z
// roll seam of :146-176); one write per row, no atomics, deterministic.
// Any grid of >= 1 cell per dim works, as in JAX: with fewer than 3 cells
// the -1 and +1 neighbours are images of one cell, each with its shift.
//
// Cost: 27*cc candidates per row, like lj_cell_force.cu plus one shared
// load and compare per candidate; bound by pair arithmetic on this card,
// not by memory (each row reads 4 values and writes 3 from device memory).
// r2 is formed with explicitly rounded products and sums, as the plain
// twin forms it, so both make the same cutoff decisions; 1/r2 is an exact
// IEEE divide (the JAX `_recip` is an exact divide off the TPU).

#include "cell_stencil.cuh"

namespace {

template <typename T>
__global__ void lj_column_full_kernel(
    const T* __restrict__ gx, const T* __restrict__ gy,
    const T* __restrict__ gz, const T* __restrict__ gi,
    const T* __restrict__ prd, T* __restrict__ fx, T* __restrict__ fy,
    T* __restrict__ fz, int nx, int ny, int nz, int cc, T lj1, T lj2,
    T cutsq) {
  T own[4] = {};  // filled by the sweep before any pair call
  T ax = T(0), ay = T(0), az = T(0);
  const cell_stencil::Row me = cell_stencil::sweep<T, 4, false>(
      {{gx, gy, gz, gi}}, prd, nx, ny, nz, cc, cutsq, own,
      [&ax, &ay, &az, &own, cc, lj1, lj2](T dx, T dy, T dz, T r2,
                                          const T* stage, int j) {
        if (stage[3 * cc + j] == own[3]) return;  // K7's rule: by id
        const T r2inv = T(1) / r2;
        const T r6inv = r2inv * r2inv * r2inv;
        const T fpair = r6inv * (lj1 * r6inv - lj2) * r2inv;
        ax += dx * fpair;
        ay += dy * fpair;
        az += dz * fpair;
      });
  if (me.row_live) {
    fx[me.row] = ax;
    fy[me.row] = ay;
    fz[me.row] = az;
  }
}

template <typename T>
int launch(const void* gx, const void* gy, const void* gz, const void* gi,
           const void* prd, void* fx, void* fy, void* fz, int nx, int ny,
           int nz, int cc, double lj1, double lj2, double cutsq,
           void* stream) {
  const cell_stencil::Launch L = cell_stencil::launch_shape(nx * ny * nz, cc);
  const size_t smem = size_t(4) * L.block.y * cc * sizeof(T);
  lj_column_full_kernel<T><<<L.grid, L.block, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gx), static_cast<const T*>(gy),
      static_cast<const T*>(gz), static_cast<const T*>(gi),
      static_cast<const T*>(prd), static_cast<T*>(fx), static_cast<T*>(fy),
      static_cast<T*>(fz), nx, ny, nz, cc, static_cast<T>(lj1),
      static_cast<T>(lj2), static_cast<T>(cutsq));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Launch on `stream`, do not
// synchronise; return cudaGetLastError() after the launch (0 = success).
extern "C" int lj_column_full_f32(const void* gx, const void* gy,
                                  const void* gz, const void* gi,
                                  const void* prd, void* fx, void* fy,
                                  void* fz, int nx, int ny, int nz, int cc,
                                  double lj1, double lj2, double cutsq,
                                  void* stream) {
  return launch<float>(gx, gy, gz, gi, prd, fx, fy, fz, nx, ny, nz, cc, lj1,
                       lj2, cutsq, stream);
}

extern "C" int lj_column_full_f64(const void* gx, const void* gy,
                                  const void* gz, const void* gi,
                                  const void* prd, void* fx, void* fy,
                                  void* fz, int nx, int ny, int nz, int cc,
                                  double lj1, double lj2, double cutsq,
                                  void* stream) {
  return launch<double>(gx, gy, gz, gi, prd, fx, fy, fz, nx, ny, nz, cc, lj1,
                        lj2, cutsq, stream);
}
