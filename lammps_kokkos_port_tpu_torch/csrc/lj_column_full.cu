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
// (same id) never pair with it, and pads (id -1) never pair with each other
// and die by distance against real rows, unless a pad sits off its
// sentinel, where K7 pairs it with the real rows in its cutoff.
//
// The same file carries P6 and P7 of benchmarks/prof/prof_kernel_v3.py
// (make(kern) -> call :185-198, pallas_call :187; P7 :204-212 launches
// k1_kernel once more for its parity line, so it is P6 k1's instance with
// another caller). Both bodies compute K7's forces with one more test,
// a candidate is taken only when its id is >= 0 (:131-134, :168-171), so a
// padding row never acts on a real one, wherever it sits:
//   k1 (k1_kernel :109-142, the 27 blocks concatenated to [nz, 27 cc]) is
//      K7's pass with CandLive = true;
//   k2 (k2_kernel :145-183, accumulated over the nine (dx, dy) columns,
//      three dz blocks each) is k1's instance with group sums (IdGrid's
//      Group = 3): the walk's entries run dx, dy, dz with dz innermost, so
//      group g is entries 3g..3g+2, and pass 2 keeps each row's group sum
//      apart and adds it into the row's total when the walk leaves the
//      group, in k2's order. Its first design, a split walk (nine thread
//      groups a cell, every slot of its column walked, pads included, the
//      body inside the loop; cc <= 96), lost to the walk on this card.
//
// What bounds K7, k1 and k2 on this card: issue slots and latency, not bytes
// (each row reads 4 values and writes 3). The first design (a
// sweep: one thread per row walking all 27 * cc candidate slots, pads
// included, the pair body inside the loop; 0.0910 ms at the 32k melt in
// f32 on an H100, 2.5x lj_cell_force on the same planes) is replaced by the
// candidate walk of cell_walk.cuh over sorted_grid::IdGrid: K7's column
// layout [nx*ny, nz, cc] is the sorted cell-major layout, so K7 is the walk
// of lj_cell_force.cu over packed (x, y, z, id) records with the pair rule
// own_id != cand_id in place of the lane rule (self_tile -1). One warp per
// cell, only live candidates within the cutoff of the warp's rows' box
// staged (k1 drops candidates with id < 0 there), r2 masks in pass 1, the
// body over each lane's own list in pass 2. Each row is written once by
// its lane: no reductions, bit-repeatable from run to run.
//
// Any grid of >= 1 cell per dim works, as in JAX: with fewer than 3 cells
// the -1 and +1 neighbours are images of one cell, each entry staged with
// its own shift and pruned in its own frame, and at nx = 1 a row's 26
// images carry its id and drop out by the id rule. Pads at their sentinel
// are skipped by position where sorted_grid.cuh's premise holds (on such
// small grids it does not, and every row and candidate is walked). The
// candidate is shifted by +-prd as JAX K7 shifts it, and r2 is formed with
// explicitly rounded products and sums, as the plain twins form it, so
// kernel and twin make the same cutoff decisions; 1/r2 is an exact IEEE
// divide (the JAX `_recip` is an exact divide off the TPU).

#include "sorted_grid.cuh"

namespace {

constexpr int kK2Group = 3;  // k2: the three dz entries of a (dx, dy) column

template <typename T, bool CandLive, int Group = 0>
using Geo = sorted_grid::IdGrid<T, CandLive, Group>;

template <typename T, bool CandLive, int Group>
__global__ void CELL_WALK_BOUNDS lj_column_full_kernel(
    const T* __restrict__ gx, const T* __restrict__ gy,
    const T* __restrict__ gz, const T* __restrict__ gi,
    const T* __restrict__ prd, T* __restrict__ fx, T* __restrict__ fy,
    T* __restrict__ fz, int nx, int ny, int nz, int cc, T lj1, T lj2,
    T cutsq) {
  sorted_grid::walk_grid<Geo<T, CandLive, Group>>(
      {gx, gy, gz, gi}, prd, nx, ny, nz, cc, cutsq,
      cell_walk::LjBody<T>{lj1, lj2},
      [=](int row, const T (&acc)[3]) {
        fx[row] = acc[0];
        fy[row] = acc[1];
        fz[row] = acc[2];
      });
}

// variant 0: K7; 1: P6 k1 (ci >= 0); 2: P6 k2 (ci >= 0, group sums); one
// launch shape for all three
template <typename T>
int launch(int variant, const void* gx, const void* gy, const void* gz,
           const void* gi, const void* prd, void* fx, void* fy, void* fz,
           int nx, int ny, int nz, int cc, double lj1, double lj2,
           double cutsq, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cell_walk::Launch L =
      cell_walk::launch_shape<T, Geo<T, false>>(nx * ny * nz);
  auto kernel = variant == 2   ? lj_column_full_kernel<T, true, kK2Group>
                : variant == 1 ? lj_column_full_kernel<T, true, 0>
                               : lj_column_full_kernel<T, false, 0>;
  kernel<<<L.grid, L.block, L.smem, st>>>(
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

// The launch K7 (and k1, k2: the same shape) makes on `ncell` cells: out[0]
// blocks, out[1] x out[2] threads per block, out[3] dynamic shared memory
// bytes.
extern "C" int lj_column_full_shape(int ncell, int f64, int* out) {
  return cell_walk::report_shape<Geo<float, false>, Geo<double, false>>(
      ncell, f64, out);
}
