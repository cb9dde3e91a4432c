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
//
// The same file carries P6 and P7 of benchmarks/prof/prof_kernel_v3.py
// (make(kern) -> call :185-198, pallas_call :187; P7 :204-212 launches
// k1_kernel once more for its parity line, so it is P6 k1's instance with
// another caller). Both bodies compute K7's forces with one more test,
// a candidate is taken only when its id is >= 0 (:131-134, :168-171), so a
// padding row never acts on a real one, wherever it sits:
//   k1 (k1_kernel :109-142, the 27 blocks concatenated to [nz, 27 cc]) is
//      the sweep above with CandLive = true;
//   k2 (k2_kernel :145-183, accumulated over the nine (dx, dy) columns,
//      three dz blocks each) is a split candidate walk: one block per cell,
//      one warp row (thread group) per (dx, dy) column, which stages and
//      walks that column's three blocks for every row of the cell; the nine
//      partial sums meet in shared memory and are added in group order, as
//      k2 adds them. Nine times the threads of k1 per cell, a ninth of the
//      candidates per thread: more rows in flight at the 32k grid, where the
//      sweep is bound by latency (PERF.md). Same forces as k1 to rounding.

#include "cell_stencil.cuh"

namespace {

using cell_stencil::Rn;
using cell_stencil::wrap_dim;

constexpr int kGroups = 9;  // the (dx, dy) columns of the 27-cell stencil

template <typename T, bool CandLive>
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
        if (CandLive && stage[3 * cc + j] < T(0)) return;  // P6: ci >= 0
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

// P6 k2: blockDim = (lanes, 9), one block per cell. Group g = threadIdx.y
// walks the column (dx, dy) = (g / 3 - 1, g % 3 - 1) at dz = -1, 0, 1 (the
// order of k2's neighbor_blocks); smem: stage[9][3 dz][4][cc], then
// part[9][3][cc].
template <typename T>
__global__ void lj_column_groups_kernel(
    const T* __restrict__ gx, const T* __restrict__ gy,
    const T* __restrict__ gz, const T* __restrict__ gi,
    const T* __restrict__ prd, T* __restrict__ fx, T* __restrict__ fy,
    T* __restrict__ fz, int nx, int ny, int nz, int cc, T lj1, T lj2,
    T cutsq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int g = threadIdx.y, lane = threadIdx.x;
  T* stage = reinterpret_cast<T*>(smem_raw) + g * 3 * 4 * cc;
  T* part = reinterpret_cast<T*>(smem_raw) + kGroups * 3 * 4 * cc;
  const int cell = blockIdx.x;
  const int cz = cell % nz, cy = (cell / nz) % ny, cx = cell / (nz * ny);
  T shx, shy;
  const int wx = wrap_dim(cx + g / 3 - 1, nx, prd[0], &shx);
  const int wy = wrap_dim(cy + g % 3 - 1, ny, prd[1], &shy);
  for (int d = 0; d < 3; ++d) {
    T shz;
    const int wz = wrap_dim(cz + d - 1, nz, prd[2], &shz);
    const int nbase = ((wx * ny + wy) * nz + wz) * cc;
    T* blk = stage + d * 4 * cc;
    for (int j = lane; j < cc; j += blockDim.x) {
      blk[j] = gx[nbase + j] + shx;
      blk[cc + j] = gy[nbase + j] + shy;
      blk[2 * cc + j] = gz[nbase + j] + shz;
      blk[3 * cc + j] = gi[nbase + j];
    }
  }
  __syncthreads();
  const int row = cell * cc + lane;
  const bool live = lane < cc;
  if (live) {
    const T ox = gx[row], oy = gy[row], oz = gz[row], oid = gi[row];
    T ax = T(0), ay = T(0), az = T(0);
    for (int d = 0; d < 3; ++d) {
      const T* blk = stage + d * 4 * cc;
      for (int j = 0; j < cc; ++j) {
        const T cid = blk[3 * cc + j];
        const T dx = ox - blk[j];
        const T dy = oy - blk[cc + j];
        const T dz = oz - blk[2 * cc + j];
        const T r2 = Rn<T>::add(Rn<T>::add(Rn<T>::mul(dx, dx),
                                           Rn<T>::mul(dy, dy)),
                                Rn<T>::mul(dz, dz));
        if (r2 < cutsq && cid != oid && cid >= T(0)) {
          const T r2inv = T(1) / r2;
          const T r6inv = r2inv * r2inv * r2inv;
          const T fpair = r6inv * (lj1 * r6inv - lj2) * r2inv;
          ax += dx * fpair;
          ay += dy * fpair;
          az += dz * fpair;
        }
      }
    }
    part[(g * 3) * cc + lane] = ax;
    part[(g * 3 + 1) * cc + lane] = ay;
    part[(g * 3 + 2) * cc + lane] = az;
  }
  __syncthreads();
  if (g == 0 && live) {
    T ax = T(0), ay = T(0), az = T(0);
    for (int k = 0; k < kGroups; ++k) {  // in group order, as k2 adds them
      ax += part[(k * 3) * cc + lane];
      ay += part[(k * 3 + 1) * cc + lane];
      az += part[(k * 3 + 2) * cc + lane];
    }
    fx[row] = ax;
    fy[row] = ay;
    fz[row] = az;
  }
}

// variant 0: K7; 1: P6 k1 (ci >= 0); 2: P6 k2 (ci >= 0, split walk)
template <typename T>
int launch(int variant, const void* gx, const void* gy, const void* gz,
           const void* gi, const void* prd, void* fx, void* fy, void* fz,
           int nx, int ny, int nz, int cc, double lj1, double lj2,
           double cutsq, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 2) {
    const int lanes = ((cc + 31) / 32) * 32;
    if (lanes * kGroups > 1024) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = size_t(kGroups) * 15 * cc * sizeof(T);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          reinterpret_cast<const void*>(&lj_column_groups_kernel<T>),
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    lj_column_groups_kernel<T><<<nx * ny * nz, dim3(lanes, kGroups), smem,
                                 st>>>(
        static_cast<const T*>(gx), static_cast<const T*>(gy),
        static_cast<const T*>(gz), static_cast<const T*>(gi),
        static_cast<const T*>(prd), static_cast<T*>(fx), static_cast<T*>(fy),
        static_cast<T*>(fz), nx, ny, nz, cc, static_cast<T>(lj1),
        static_cast<T>(lj2), static_cast<T>(cutsq));
    return static_cast<int>(cudaGetLastError());
  }
  const cell_stencil::Launch L = cell_stencil::launch_shape(nx * ny * nz, cc);
  const size_t smem = size_t(4) * L.block.y * cc * sizeof(T);
  auto kernel = variant == 1 ? lj_column_full_kernel<T, true>
                             : lj_column_full_kernel<T, false>;
  kernel<<<L.grid, L.block, smem, st>>>(
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
#define LJ_COLUMN_FULL_ENTRY(NAME, T, VARIANT)                                \
  extern "C" int NAME(const void* gx, const void* gy, const void* gz,        \
                      const void* gi, const void* prd, void* fx, void* fy,   \
                      void* fz, int nx, int ny, int nz, int cc, double lj1,  \
                      double lj2, double cutsq, void* stream) {              \
    return launch<T>(VARIANT, gx, gy, gz, gi, prd, fx, fy, fz, nx, ny, nz,   \
                     cc, lj1, lj2, cutsq, stream);                           \
  }

LJ_COLUMN_FULL_ENTRY(lj_column_full_f32, float, 0)
LJ_COLUMN_FULL_ENTRY(lj_column_full_f64, double, 0)
LJ_COLUMN_FULL_ENTRY(lj_column_v3_k1_f32, float, 1)
LJ_COLUMN_FULL_ENTRY(lj_column_v3_k1_f64, double, 1)
LJ_COLUMN_FULL_ENTRY(lj_column_v3_k2_f32, float, 2)
LJ_COLUMN_FULL_ENTRY(lj_column_v3_k2_f64, double, 2)
