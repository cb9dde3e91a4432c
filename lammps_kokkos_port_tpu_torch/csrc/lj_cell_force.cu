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
// Pads. The sorted layout has no validity channel: a pad row holds the
// position sentinel PAD_POS + row * PAD_STEP on the space diagonal
// (ops/sortedforce.py; kPadPos and kPadStep below), and its premise is
// that every pair with a pad fails the cutoff by distance. Under it the
// twin adds nothing for a pad candidate and sums nothing into a pad row,
// so skipping pad candidates and writing zero into pad rows gives the
// twin's result. A row is a pad when its x >= PAD_POS / 2. The premise
// holds, in every frame the stencil shifts a candidate into, when
//   (a) cutsq < PAD_STEP^2 (the wrapper raises otherwise): in a frame
//       where one axis is not shifted, two pads differ by a nonzero
//       multiple of PAD_STEP in that axis, exactly;
//   (b) max(prd) < PAD_POS / 4: a real row lies in the box (within a skin
//       of it), so it and its images stay below PAD_POS / 2 and at least
//       PAD_POS / 4 from any pad's image;
//   (c) 2 (max(prd) + 2 PAD_STEP) <= PAD_STEP * apart, apart = (nx - 2)
//       ny nz cc + 1: a candidate shifted in all three axes comes from
//       the far corner of the grid, at least `apart` rows from the own
//       row (x is the outermost cell index), so two pads differ by at
//       least PAD_STEP * apart - max(prd) - PAD_STEP / 2 (the rounding of
//       the shifted sentinel) > PAD_STEP in each axis.
// prd lives on the card and the wrapper cannot read it without a
// synchronisation (which CUDA-graph capture also forbids), so the kernel
// checks (b) and (c) itself and, where either fails, treats every row as
// live and walks every candidate, as the twin does. Pads may sit anywhere
// among the live rows: no packing is assumed.
//
// r2 is formed with explicitly rounded multiplies and adds (no fused
// multiply-add), as the plain PyTorch version rounds it, so both make the
// same cutoff decisions; only the order of the force sums differs.

#include "cell_walk.cuh"

namespace {

using cell_stencil::Rn;
using cell_stencil::wrap_dim;
using cell_walk::Cand;

// ops/sortedforce.py's PAD_POS and PAD_STEP (a CPU test holds them equal)
constexpr double kPadPos = 1.0e8;
constexpr double kPadStep = 16.0;

template <typename T> struct SortedGrid {
  const T *gx, *gy, *gz;
  int nx, ny, nz, cc, tiles;
  int cx, cy, cz;
  T px, py, pz;
  bool skip_pads;

  // a neighbour block: its first row and the shift across the box
  struct Entry {
    int base;
    T shx, shy, shz;
  };
  static constexpr int kPlanes = 3;
  static constexpr bool kTwoPass = true;
  static constexpr bool kIndexFirst = false;

  __device__ Entry entry(int s) const {
    Entry e;
    const int wx = wrap_dim(cx + s / 9 - 1, nx, px, &e.shx);
    const int wy = wrap_dim(cy + (s / 3) % 3 - 1, ny, py, &e.shy);
    const int wz = wrap_dim(cz + s % 3 - 1, nz, pz, &e.shz);
    e.base = ((wx * ny + wy) * nz + wz) * cc;
    return e;
  }

  __device__ Entry fetch(const Entry& m, int s) const {
    return {__shfl_sync(0xffffffffu, m.base, s),
            __shfl_sync(0xffffffffu, m.shx, s),
            __shfl_sync(0xffffffffu, m.shy, s),
            __shfl_sync(0xffffffffu, m.shz, s)};
  }

  __device__ void issue_a(const Entry& e, int k, int lane, T* raw) const {
    const int j = k * cell_walk::kTile + lane;
    if (j >= cc) return;
    cell_walk::copy_async(raw + lane, gx + e.base + j);
    cell_walk::copy_async(raw + cell_walk::kTile + lane, gy + e.base + j);
    cell_walk::copy_async(raw + 2 * cell_walk::kTile + lane, gz + e.base + j);
  }
  __device__ void issue_b(const Entry&, int, int, T*) const {}

  // the candidate shifted across the box as the twin shifts it
  __device__ bool pack(const Entry& e, int k, int lane, const T* raw,
                       Cand<T>* c) const {
    if (k * cell_walk::kTile + lane >= cc) {
      *c = {T(0), T(0), T(0), T(0)};
      return false;
    }
    const T x = raw[lane];
    *c = {x + e.shx, raw[cell_walk::kTile + lane] + e.shy,
          raw[2 * cell_walk::kTile + lane] + e.shz, T(0)};
    return !skip_pads || x < T(kPadPos / 2);
  }

  __device__ bool near(const cell_walk::Box<T>& b, const Cand<T>& c,
                       T near_cutsq) const {
    return cell_walk::near_box(b, c, near_cutsq);
  }

  __device__ T dist(const Cand<T>& o, const Cand<T>& c, T& dx, T& dy,
                    T& dz) const {
    dx = o.x - c.x;
    dy = o.y - c.y;
    dz = o.z - c.z;
    return Rn<T>::add(Rn<T>::add(Rn<T>::mul(dx, dx), Rn<T>::mul(dy, dy)),
                      Rn<T>::mul(dz, dz));
  }

  // the self pair is masked by its packed position in the own tile
  __device__ bool other(const Cand<T>&, const Cand<T>&) const { return true; }
};

template <typename T>
__global__ void CELL_WALK_BOUNDS lj_cell_force_kernel(
    const T* __restrict__ gx, const T* __restrict__ gy,
    const T* __restrict__ gz, const T* __restrict__ prd,
    T* __restrict__ fx, T* __restrict__ fy, T* __restrict__ fz,
    int nx, int ny, int nz, int cc, T lj1, T lj2, T cutsq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Geo = SortedGrid<T>;
  const int cell = blockIdx.x * cell_walk::kWarpsPerBlock + threadIdx.y;
  if (cell >= nx * ny * nz) return;  // the whole warp
  const auto sm = cell_walk::warp_smem<T, Geo>(smem_raw);

  const int cz = cell % nz, t = cell / nz;
  const int tiles = (cc + cell_walk::kTile - 1) / cell_walk::kTile;
  const T px = prd[0], py = prd[1], pz = prd[2];
  const T pmax = max(px, max(py, pz));
  const T apart = T(nx - 2) * T(ny * nz * cc) + T(1);
  const bool skip_pads =
      pmax < T(kPadPos / 4) &&
      T(2) * (pmax + T(2 * kPadStep)) <= T(kPadStep) * apart;
  const Geo geo{gx, gy, gz, nx, ny, nz, cc, tiles, t / ny, t % ny, cz,
                px, py, pz, skip_pads};
  const int lane = threadIdx.x;

  for (int rp = 0; rp < tiles; ++rp) {
    const int j = rp * cell_walk::kTile + lane;
    const int row = cell * cc + j;
    Cand<T> own = {T(0), T(0), T(0), T(0)};
    if (j < cc) own = {gx[row], gy[row], gz[row], T(0)};
    const bool live = j < cc && (!skip_pads || own.x < T(kPadPos / 2));
    T acc[3] = {T(0), T(0), T(0)};
    if (__any_sync(0xffffffffu, live))
      cell_walk::walk(geo, own, live, 13 * tiles + rp, lj1, lj2, cutsq, sm,
                      acc);
    if (j < cc) {  // a pad row gets its zero
      fx[row] = acc[0];
      fy[row] = acc[1];
      fz[row] = acc[2];
    }
  }
}

template <typename T>
int launch(const void* gx, const void* gy, const void* gz, const void* prd,
           void* fx, void* fy, void* fz, int nx, int ny, int nz, int cc,
           double lj1, double lj2, double cutsq, void* stream) {
  const cell_walk::Launch L =
      cell_walk::launch_shape<T, SortedGrid<T>>(nx * ny * nz);
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
  return cell_walk::report_shape<SortedGrid<float>, SortedGrid<double>>(
      ncell, f64, out);
}
