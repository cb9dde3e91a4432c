// lj/cut force-only pass over the Newton-half stencil of the sorted
// cell-major grid, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   K8  plane_half_force_pallas  lammps_kokkos_port_tpu/ops/pallas_pair.py:471
//       (kernel _plane_half_kernel :375-459, pallas_call :512, the fold of
//       the cross-column reactions :521-529)
//   P10 fwd_call                 benchmarks/prof/prof_v3_iso.py:77
//       (kernel fwd_kernel :42-74, pallas_call :97): K8's forward sums only,
//       no reactions (physically wrong, a timing ablation)
// as two instances of one template (`React`).
//
// What K8 computes: each own row i pairs with the 14 candidate blocks of
// the half stencil _HALF (:208-212): the own cell and the 13 offsets that
// are lexicographically positive. Candidate ids of blocks s > 0 are offset
// by `idcap` (:402-403; -1 stays -1), and a pair is taken where own_id <
// cand_id and r2 < cutsq, so each unordered pair of real rows is evaluated
// once: fij goes to row i and -fij to row j.
//
// The hazard: K8 is race-free on the TPU because every program writes its
// own reaction slot and the caller folds them. CUDA blocks run
// concurrently, so a reaction either goes to a slot of its own and is
// folded by a second pass, or is added atomically.
//
// What bounds it on this card: issue slots and latency, as the full
// stencil (lj_cell_force.cu), not bytes (the bound of the 1M pass is
// 0.0136 ms of bytes). The first design staged each of the 14
// blocks for a block of cells with two block-wide barriers, walked every
// candidate slot in every thread (pads and far candidates included), added
// each reaction with three shared atomics per pair and wrote 13 x 3 x cc
// reactions per cell to a buffer that a second launch folded (253 MB each
// way at the 1M grid in f32).
//
// Design: cell_walk.cuh's walk over sorted_grid::HalfGrid, the 14 entries
// of the half stencil: one warp per cell, no block barrier, cp.async a
// batch ahead, only live candidates within the cutoff of the warp's own
// rows' bounding box staged, as packed (x, y, z, id) records; pass 1 forms
// the masks with the pair rule, pass 2 runs the lj body over each lane's
// own list. With React, the pack step keeps each kept candidate's row and
// pass 2 lands each pair's reaction on it with a global reduction
// (red.global.add: one four-wide in f32 into an interleaved output, three
// in f64; `Landing` below), and each row adds its forward sum the same
// way at the end, into an output the wrapper zeroes. So there is no
// reaction buffer and no fold launch, the own cell's reactions reach
// their rows whatever row pass owns them (cc > 32), and the sums come out
// in an order that varies from run to run. Measured against the other
// designs of the reactions (PERF.md section 6; each built from this
// source): a shared-memory accumulator per kept candidate with a shared
// atomic per pair and component (the first design's scheme, on the walk)
// took about twice this design's time; the designs with no atomic per
// pair (a lane-rotated pass with the reactions moved by shuffles, or a
// transposed pass from the candidates' side) paid more in their extra
// pass than the reductions cost; in f32 one reduction per component made
// the pass about a quarter slower than the four-wide one.
//
// Pads are told by position and skipped where the box keeps them out of
// every cutoff (sorted_grid.cuh, conditions (a)-(c)); where it does not,
// every row and candidate is walked and the pair rule decides, as in the
// twin (which gives a pad own row, id -1, a pair with any real candidate
// inside the cutoff). r2 is formed with explicitly rounded products and
// sums, as the plain twin forms it; 1/r2 is an IEEE divide (the JAX
// `_recip` off the TPU).

#include "sorted_grid.cuh"

namespace {

using cell_walk::Cand;

// Where K8's sums land, `rows` rows of output at `out`, which holds zeros
// on entry: in f32 interleaved [rows, 4] (x, y, z, unused), each sum one
// four-wide global reduction (sm_90's float4 atomicAdd); in f64 three
// planes [3, rows], one reduction per component (no wider one for double).
template <typename T> struct Landing {
  T* out;
  int rows;

  __device__ void add(int row, T x, T y, T z) const {
    if constexpr (sizeof(T) == 4) {
      atomicAdd(reinterpret_cast<float4*>(out) + row,
                make_float4(x, y, z, 0.0f));
    } else {
      atomicAdd(out + row, x);
      atomicAdd(out + rows + row, y);
      atomicAdd(out + 2 * rows + row, z);
    }
  }
};

// The reactions: each pair's -fij straight onto the candidate's row.
template <typename T> struct Reactions : Landing<T> {
  static constexpr bool kOn = true;

  template <typename B, typename S>
  __device__ void pair(const S& sm, int slot, const T (&d)[3], T f) const {
    this->add(sm.rows()[slot], -B::part(d, f, 0), -B::part(d, f, 1),
              -B::part(d, f, 2));
  }
};

// K8 (React) adds each row's forward sum and every reaction into `out`
// (Landing's layout); P10 writes each row's forward sum into three planes
// [3, rows].
template <typename T, bool React>
__global__ void CELL_WALK_BOUNDS lj_plane_half_kernel(
    const T* __restrict__ gx, const T* __restrict__ gy,
    const T* __restrict__ gz, const T* __restrict__ gi,
    const T* __restrict__ prd, T* __restrict__ out, int nx, int ny, int nz,
    int cc, T idcap, T lj1, T lj2, T cutsq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Geo = sorted_grid::HalfGrid<T, React>;
  const int ncell = nx * ny * nz;
  const int cell = blockIdx.x * cell_walk::kWarpsPerBlock + threadIdx.y;
  if (cell >= ncell) return;  // the whole warp
  const auto sm = cell_walk::warp_smem<T, Geo>(smem_raw);

  const int cz = cell % nz, t = cell / nz;
  const int tiles = (cc + cell_walk::kTile - 1) / cell_walk::kTile;
  const T px = prd[0], py = prd[1], pz = prd[2];
  const bool skip_pads = sorted_grid::pads_apart(px, py, pz, nx, ny, nz, cc);
  const Geo geo{{{gx, gy, gz, gi}, nx, ny, nz, cc, tiles, t / ny, t % ny,
                 cz, px, py, pz, skip_pads},
                idcap};
  const cell_walk::LjBody<T> body{lj1, lj2};
  const int rows = ncell * cc;
  const int lane = threadIdx.x;

  for (int rp = 0; rp < tiles; ++rp) {
    const int j = rp * cell_walk::kTile + lane;
    const int row = cell * cc + j;
    Cand<T> own = {T(0), T(0), T(0), T(0)};
    if (j < cc) own = {gx[row], gy[row], gz[row], gi[row]};
    const bool live =
        j < cc && (!skip_pads || own.x < T(sorted_grid::kPadPos / 2));
    T acc[3] = {T(0), T(0), T(0)};
    if constexpr (React) {
      const Reactions<T> react{{out, rows}};
      if (__any_sync(0xffffffffu, live))
        cell_walk::walk(geo, body, own, live, -1, cutsq, sm, acc, react);
      if (live) react.add(row, acc[0], acc[1], acc[2]);
    } else {
      if (__any_sync(0xffffffffu, live))
        cell_walk::walk(geo, body, own, live, -1, cutsq, sm, acc);
      if (j < cc) {
        out[row] = acc[0];
        out[rows + row] = acc[1];
        out[2 * rows + row] = acc[2];
      }
    }
  }
}

template <typename T, bool React>
int launch(const void* gx, const void* gy, const void* gz, const void* gi,
           const void* prd, void* out, int nx, int ny, int nz, int cc,
           double idcap, double lj1, double lj2, double cutsq,
           void* stream) {
  const cell_walk::Launch L =
      cell_walk::launch_shape<T, sorted_grid::HalfGrid<T, React>>(nx * ny *
                                                                  nz);
  lj_plane_half_kernel<T, React><<<L.grid, L.block, L.smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gx), static_cast<const T*>(gy),
      static_cast<const T*>(gz), static_cast<const T*>(gi),
      static_cast<const T*>(prd), static_cast<T*>(out), nx, ny, nz, cc,
      static_cast<T>(idcap), static_cast<T>(lj1), static_cast<T>(lj2),
      static_cast<T>(cutsq));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Launch on `stream`, do not
// synchronise; return cudaGetLastError() after the launch (0 = success).
// lj_plane_half_* add into `out` (f32: [rows, 4] interleaved; f64: [3,
// rows]), which must hold zeros on entry; lj_plane_half_fwd_* write every
// row of [3, rows]. rows = nx * ny * nz * cc.
#define LJ_PLANE_HALF_ENTRY(NAME, T, REACT)                                  \
  extern "C" int NAME(const void* gx, const void* gy, const void* gz,       \
                      const void* gi, const void* prd, void* out, int nx,   \
                      int ny, int nz, int cc, double idcap, double lj1,     \
                      double lj2, double cutsq, void* stream) {             \
    return launch<T, REACT>(gx, gy, gz, gi, prd, out, nx, ny, nz, cc,       \
                            idcap, lj1, lj2, cutsq, stream);                \
  }

LJ_PLANE_HALF_ENTRY(lj_plane_half_f32, float, true)
LJ_PLANE_HALF_ENTRY(lj_plane_half_f64, double, true)
LJ_PLANE_HALF_ENTRY(lj_plane_half_fwd_f32, float, false)
LJ_PLANE_HALF_ENTRY(lj_plane_half_fwd_f64, double, false)

// The launch each kernel makes on `ncell` cells: out[0] blocks, out[1] x
// out[2] threads per block, out[3] dynamic shared memory bytes.
extern "C" int lj_plane_half_shape(int ncell, int f64, int* out) {
  return cell_walk::report_shape<sorted_grid::HalfGrid<float, true>,
                                 sorted_grid::HalfGrid<double, true>>(
      ncell, f64, out);
}

extern "C" int lj_plane_half_fwd_shape(int ncell, int f64, int* out) {
  return cell_walk::report_shape<sorted_grid::HalfGrid<float, false>,
                                 sorted_grid::HalfGrid<double, false>>(
      ncell, f64, out);
}
