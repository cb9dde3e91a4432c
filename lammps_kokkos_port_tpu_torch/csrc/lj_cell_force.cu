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
// (a sweep of every slot, 1.236 ms at 1M f32 on an H100, about 26
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
//
// The frame (sorted_grid::FramedGrid): each pair is formed as the
// Newton-half K1/K2 form it, once, from the cell whose half stencil holds
// the other: across a wrapped face the row whose candidate sits at a
// negative stencil offset moves itself by -shift and leaves the candidate
// unshifted, so both rows of a pair at the cutoff take K1's one decision
// (ROADMAP F12; tests/test_torch_cutoff_frame.py). The plain version forms
// d alike (ops/pair_kernels.stencil, frame "half"). Only the batches of
// cells at a face that hold such a tile pay for it (a fifth of the batches
// at the 32k grid, 7% at 1M: PERF.md has the cost).
//
// Tally instance (thermo rows: energy and virial; no TPU kernel, the JAX
// package left the energy pass to XLA's grid-roll path, which the port ran
// in plain PyTorch until this one): lj_cell_force_tally_kernel, the same
// walk on the same geometry, so a row's cutoff decisions are the step's,
// under its own kernel name, so that the step's kernel keeps its
// registers, its SASS and its name (by-name readers of the step's kernel
// see only the step's calls). Its body (LjTallyBody) sums ten values a
// row: the force, evdwl = r6inv (lj3 r6inv - lj4) - offset, and fpair
// dx_a dx_b (xx, yy, zz, xy, xz, yz); each row writes its force and seven
// planes of one [7, rows] buffer, halved, since the 27-cell stencil sees
// every pair from both rows: pe_i = 1/2 sum_j evdwl and the virial 1/2
// sum_j fpair dx_a dx_b. The wrapper sums the planes over the valid rows
// in float64 (no atomics: deterministic).

#include "sorted_grid.cuh"

namespace {

template <typename T> using Geo = sorted_grid::FramedGrid<T, 3>;

template <typename T>
__global__ void CELL_WALK_BOUNDS lj_cell_force_kernel(
    const T* __restrict__ gx, const T* __restrict__ gy,
    const T* __restrict__ gz, const T* __restrict__ prd,
    T* __restrict__ fx, T* __restrict__ fy, T* __restrict__ fz,
    int nx, int ny, int nz, int cc, T lj1, T lj2, T cutsq) {
  sorted_grid::walk_grid<Geo<T>>(
      {gx, gy, gz, nullptr}, prd, nx, ny, nz, cc, cutsq,
      cell_walk::LjBody<T>{lj1, lj2},
      [=](int row, const T (&acc)[3]) {
        fx[row] = acc[0];
        fy[row] = acc[1];
        fz[row] = acc[2];
      });
}

// a pair's two values in the tally instance
template <typename T> struct LjTerm {
  T fpair, evdwl;
};

// pairs an iteration of pass 2 in the tally instance: the faster of one
// and two in each type (PERF.md section 6)
template <typename T> constexpr int kTallyPairs = sizeof(T) == 4 ? 2 : 1;

// the lj/cut tally body: fpair as LjBody forms it and evdwl from the same
// r6inv; acc 0-2 the force, 3 sum evdwl, 4-9 sum fpair dx_a dx_b (xx, yy,
// zz, xy, xz, yz)
template <typename T> struct LjTallyBody {
  static constexpr int kAcc = 10;
  static constexpr int kPairs = kTallyPairs<T>;
  T lj1, lj2, lj3, lj4, offset;
  __device__ LjTerm<T> term(const cell_walk::Cand<T>&,
                            const cell_walk::Cand<T>&, T r2) const {
    const T r2inv = T(1) / r2;
    const T r6inv = r2inv * r2inv * r2inv;
    return {r6inv * (lj1 * r6inv - lj2) * r2inv,
            r6inv * (lj3 * r6inv - lj4) - offset};
  }
  static __device__ T part(const T (&d)[3], const LjTerm<T>& e, int a) {
    switch (a) {
      case 3: return e.evdwl;
      case 4: return d[0] * e.fpair * d[0];
      case 5: return d[1] * e.fpair * d[1];
      case 6: return d[2] * e.fpair * d[2];
      case 7: return d[0] * e.fpair * d[1];
      case 8: return d[0] * e.fpair * d[2];
      case 9: return d[1] * e.fpair * d[2];
      default: return d[a] * e.fpair;
    }
  }
};

// the walk with each row's tallies: tally[k * rows + row], k = 0 pe
// (1/2 sum evdwl), 1-6 the virial's halves
template <typename T>
__global__ void CELL_WALK_BOUNDS lj_cell_force_tally_kernel(
    const T* __restrict__ gx, const T* __restrict__ gy,
    const T* __restrict__ gz, const T* __restrict__ prd,
    T* __restrict__ fx, T* __restrict__ fy, T* __restrict__ fz,
    T* __restrict__ tally, int nx, int ny, int nz, int cc, T lj1, T lj2,
    T lj3, T lj4, T offset, T cutsq) {
  const long long rows = static_cast<long long>(nx) * ny * nz * cc;
  sorted_grid::walk_grid<Geo<T>>(
      {gx, gy, gz, nullptr}, prd, nx, ny, nz, cc, cutsq,
      LjTallyBody<T>{lj1, lj2, lj3, lj4, offset},
      [=](int row, const T (&acc)[10]) {
        fx[row] = acc[0];
        fy[row] = acc[1];
        fz[row] = acc[2];
#pragma unroll
        for (int k = 0; k < 7; ++k)
          tally[k * rows + row] = T(0.5) * acc[3 + k];
      });
}

template <typename T>
int launch(const void* gx, const void* gy, const void* gz, const void* prd,
           void* fx, void* fy, void* fz, int nx, int ny, int nz, int cc,
           double lj1, double lj2, double cutsq, void* stream) {
  const cell_walk::Launch L =
      cell_walk::launch_shape<T, Geo<T>>(nx * ny * nz);
  lj_cell_force_kernel<T><<<L.grid, L.block, L.smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gx), static_cast<const T*>(gy),
      static_cast<const T*>(gz), static_cast<const T*>(prd),
      static_cast<T*>(fx), static_cast<T*>(fy), static_cast<T*>(fz), nx, ny,
      nz, cc, static_cast<T>(lj1), static_cast<T>(lj2),
      static_cast<T>(cutsq));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tally(const void* gx, const void* gy, const void* gz,
                 const void* prd, void* fx, void* fy, void* fz, void* tally,
                 int nx, int ny, int nz, int cc, double lj1, double lj2,
                 double lj3, double lj4, double offset, double cutsq,
                 void* stream) {
  const cell_walk::Launch L =
      cell_walk::launch_shape<T, Geo<T>>(nx * ny * nz);
  lj_cell_force_tally_kernel<T><<<L.grid, L.block, L.smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gx), static_cast<const T*>(gy),
      static_cast<const T*>(gz), static_cast<const T*>(prd),
      static_cast<T*>(fx), static_cast<T*>(fy), static_cast<T*>(fz),
      static_cast<T*>(tally), nx, ny, nz, cc, static_cast<T>(lj1),
      static_cast<T>(lj2), static_cast<T>(lj3), static_cast<T>(lj4),
      static_cast<T>(offset), static_cast<T>(cutsq));
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

// The tally instance: the forces and `tally`, 7 planes of nx * ny * nz *
// cc rows (pe_i, then the virial's halves xx, yy, zz, xy, xz, yz).
extern "C" int lj_cell_force_tally_f32(const void* gx, const void* gy,
                                       const void* gz, const void* prd,
                                       void* fx, void* fy, void* fz,
                                       void* tally, int nx, int ny, int nz,
                                       int cc, double lj1, double lj2,
                                       double lj3, double lj4, double offset,
                                       double cutsq, void* stream) {
  return launch_tally<float>(gx, gy, gz, prd, fx, fy, fz, tally, nx, ny, nz,
                             cc, lj1, lj2, lj3, lj4, offset, cutsq, stream);
}

extern "C" int lj_cell_force_tally_f64(const void* gx, const void* gy,
                                       const void* gz, const void* prd,
                                       void* fx, void* fy, void* fz,
                                       void* tally, int nx, int ny, int nz,
                                       int cc, double lj1, double lj2,
                                       double lj3, double lj4, double offset,
                                       double cutsq, void* stream) {
  return launch_tally<double>(gx, gy, gz, prd, fx, fy, fz, tally, nx, ny, nz,
                              cc, lj1, lj2, lj3, lj4, offset, cutsq, stream);
}

// The launch either kernel makes on `ncell` cells (the tally instance
// launches as the step's): out[0] blocks, out[1] x
// out[2] threads per block, out[3] dynamic shared memory bytes.
extern "C" int lj_cell_force_shape(int ncell, int f64, int* out) {
  return cell_walk::report_shape<Geo<float>, Geo<double>>(ncell, f64, out);
}
