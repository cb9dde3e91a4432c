// The sorted cell-major layout as the cell_walk.cuh kernels read it
// (sm_90a): lj_cell_force.cu (K1-K3's port) and eam_cell.cu (K4/K5's).
//
// Layout: per-row planes x, y, z (and for some kernels a fourth per-row
// value w) are [ncells, cc] rows, cell id (cx*ny + cy)*nz + cz. The full
// 27-cell stencil with no Newton halving: one warp per cell walks its 27
// neighbour blocks, positions shifted by +-prd where the offset wraps
// across the box (no minimum image), and each lane writes its row's sum
// once: deterministic, no atomics.
//
// Pads. The sorted layout has no validity channel: a pad row holds the
// position sentinel PAD_POS + row * PAD_STEP on the space diagonal
// (ops/sortedforce.py; kPadPos and kPadStep below), and its premise is
// that every pair with a pad fails the cutoff by distance. Under it the
// twin adds nothing for a pad candidate and sums nothing into a pad row,
// so skipping pad candidates and writing zero into pad rows gives the
// twin's result. A row is a pad when its x >= PAD_POS / 2. The premise
// holds, in every frame the stencil shifts a candidate into, when
//   (a) cutsq < PAD_STEP^2 (the wrappers raise otherwise): in a frame
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
// checks (b) and (c) itself (`pads_apart`) and, where either fails,
// treats every row as live and walks every candidate, as the twin does.
// Pads may sit anywhere among the live rows: no packing is assumed.
//
// r2 is formed with explicitly rounded multiplies and adds (no fused
// multiply-add), as the plain PyTorch versions round it, so kernel and
// twin make the same cutoff decisions.

#pragma once

#include "cell_walk.cuh"

namespace sorted_grid {

using cell_stencil::Rn;
using cell_stencil::wrap_dim;
using cell_walk::Cand;

// ops/sortedforce.py's PAD_POS and PAD_STEP (a CPU test holds them equal)
constexpr double kPadPos = 1.0e8;
constexpr double kPadStep = 16.0;

// Conditions (b) and (c) above: whether pads can be told by position.
template <typename T>
__device__ __forceinline__ bool pads_apart(T px, T py, T pz, int nx, int ny,
                                           int nz, int cc) {
  const T pmax = max(px, max(py, pz));
  const T apart = T(nx - 2) * T(ny * nz * cc) + T(1);
  return pmax < T(kPadPos / 4) &&
         T(2) * (pmax + T(2 * kPadStep)) <= T(kPadStep) * apart;
}

// the per-row input planes: x, y, z, and w where P = 4
template <typename T> struct Planes {
  const T *x, *y, *z, *w;
};

// The walk's geometry (cell_walk.cuh `G`) on the sorted layout: P = 3
// stages x, y, z plane by plane; P = 4 stages packed (x, y, z, w) records.
template <typename T, int P> struct SortedGrid {
  static_assert(P == 3 || P == 4, "x, y, z and at most one more plane");
  Planes<T> g;
  int nx, ny, nz, cc, tiles;
  int cx, cy, cz;
  T px, py, pz;
  bool skip_pads;

  // a neighbour block: its first row and the shift across the box
  struct Entry {
    int base;
    T shx, shy, shz;
  };
  static constexpr int kPlanes = P;
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
    cell_walk::copy_async(raw + lane, g.x + e.base + j);
    cell_walk::copy_async(raw + cell_walk::kTile + lane, g.y + e.base + j);
    cell_walk::copy_async(raw + 2 * cell_walk::kTile + lane,
                          g.z + e.base + j);
    if constexpr (P == 4)
      cell_walk::copy_async(raw + 3 * cell_walk::kTile + lane,
                            g.w + e.base + j);
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
    T w = T(0);
    if constexpr (P == 4) w = raw[3 * cell_walk::kTile + lane];
    *c = {x + e.shx, raw[cell_walk::kTile + lane] + e.shy,
          raw[2 * cell_walk::kTile + lane] + e.shz, w};
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

// The body of a sorted-layout kernel: this warp's cell, its row passes
// (32 rows each) through the walk with `body`, and store(row, acc) for
// every row of the cell (a pad row skipped by position gets acc = 0).
// Launched with cell_walk::launch_shape<T, SortedGrid<T, P>>(ncells).
template <typename T, int P, typename B, typename Store>
__device__ __forceinline__ void walk_rows(const Planes<T>& g,
                                          const T* __restrict__ prd, int nx,
                                          int ny, int nz, int cc, T cutsq,
                                          const B& body, Store store) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Geo = SortedGrid<T, P>;
  const int cell = blockIdx.x * cell_walk::kWarpsPerBlock + threadIdx.y;
  if (cell >= nx * ny * nz) return;  // the whole warp
  const auto sm = cell_walk::warp_smem<T, Geo>(smem_raw);

  const int cz = cell % nz, t = cell / nz;
  const int tiles = (cc + cell_walk::kTile - 1) / cell_walk::kTile;
  const T px = prd[0], py = prd[1], pz = prd[2];
  const bool skip_pads = pads_apart(px, py, pz, nx, ny, nz, cc);
  const Geo geo{g,  nx, ny, nz, cc, tiles, t / ny, t % ny, cz,
                px, py, pz, skip_pads};
  const int lane = threadIdx.x;

  for (int rp = 0; rp < tiles; ++rp) {
    const int j = rp * cell_walk::kTile + lane;
    const int row = cell * cc + j;
    Cand<T> own = {T(0), T(0), T(0), T(0)};
    if (j < cc) {
      own = {g.x[row], g.y[row], g.z[row], T(0)};
      if constexpr (P == 4) own.w = g.w[row];
    }
    const bool live = j < cc && (!skip_pads || own.x < T(kPadPos / 2));
    T acc[B::kAcc] = {};
    if (__any_sync(0xffffffffu, live))
      cell_walk::walk(geo, body, own, live, 13 * tiles + rp, cutsq, sm, acc);
    if (j < cc) store(row, acc);
  }
}

}  // namespace sorted_grid
