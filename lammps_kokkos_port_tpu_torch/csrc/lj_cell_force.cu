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
//
// Design (the stencil walk of cell_stencil.cuh): the full 27-cell
// stencil with no Newton halving, as K3 does. One thread owns one row and
// writes its sum once, so the result is deterministic and needs no atomics.
// K1/K2 add reactions into other columns without atomics, which is safe
// only because the TPU grid runs sequentially; CUDA blocks run
// concurrently, so a literal port would race.
//
// Cost: 27*cc candidate pairs per row, about 2x the pair count of the
// Newton-halved K1 (14 blocks, half of them masked in the self block), so
// on this card the kernel is bound by pair arithmetic, not by memory: each
// row reads 27*cc*3 values from shared memory and its own 3 values from
// device memory. The Newton-half variant (atomics or a colouring of the
// cells) is left to a later performance change.
//
// r2 is bit-identical to the plain PyTorch version's (cell_stencil.cuh),
// so both make the same cutoff decisions; only the order of the force sums
// differs. 1/r2 is an exact IEEE divide (nvcc's default -prec-div=true).

#include "cell_stencil.cuh"

namespace {

template <typename T>
__global__ void lj_cell_force_kernel(
    const T* __restrict__ gx, const T* __restrict__ gy,
    const T* __restrict__ gz, const T* __restrict__ prd,
    T* __restrict__ fx, T* __restrict__ fy, T* __restrict__ fz,
    int nx, int ny, int nz, int cc, T lj1, T lj2, T cutsq) {
  T own[3];
  T ax = T(0), ay = T(0), az = T(0);
  const cell_stencil::Row me = cell_stencil::sweep<T, 3>(
      {{gx, gy, gz}}, prd, nx, ny, nz, cc, cutsq, own,
      [&ax, &ay, &az, lj1, lj2](T dx, T dy, T dz, T r2, const T*, int) {
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
int launch(const void* gx, const void* gy, const void* gz, const void* prd,
           void* fx, void* fy, void* fz, int nx, int ny, int nz, int cc,
           double lj1, double lj2, double cutsq, void* stream) {
  const cell_stencil::Launch L = cell_stencil::launch_shape(nx * ny * nz, cc);
  const size_t smem = size_t(3) * L.block.y * cc * sizeof(T);
  lj_cell_force_kernel<T><<<L.grid, L.block, smem,
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
  return launch<double>(gx, gy, gz, prd, fx, fy, fz, nx, ny, nz, cc, lj1, lj2,
                        cutsq, stream);
}
