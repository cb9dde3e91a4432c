// The Newton-half column passes of the profiling scripts, for Hopper
// (sm_90a): lj/cut over the half stencil of the column layout
// [nx*ny, nz, cc] (the sorted cell-major rows, cell (cx*ny + cy)*nz + cz),
// in the variants that split the half kernel's cost.
//
// Replaces the Pallas prototypes
//   P5  benchmarks/prof/prof_kernel_iso.py:99 (kernel make_kernel(mode)
//       :11-92), five modes: full, batched, redonly, noreverse, noassembly;
//   P8  benchmarks/prof/prof_kernel_writeonce.py:120 (kernel _wo_kernel
//       :31-107): forward sums plus the reactions written once per column as
//       5 (dx, dy) target blocks, rc [nx*ny, 3, nz, 5*cc];
//   P2  benchmarks/prof/prof_halfv2.py:151 (kernel make_v2 :44-161): K1's
//       id-free forces, exact or approximate reciprocal;
//   P11 benchmarks/prof/prof_zchunk.py:68 (bodies fwd_kern :121-141 and
//       fused_kern :149-168): forward-only passes, with ids and id-free;
//   P3  benchmarks/prof/prof_kernel_cc32.py:182 (t2_call :181-189, kernel
//       t2_kernel :90-177): P5 full's forces and reactions with the mask
//       own_i < cand_i && own_i >= 0 (:153-156), so a padding row takes no
//       pair whatever its position. The TPU body stages its 14 blocks as
//       128-lane tiles of four, the last tile filled with -1.0 (:136-142):
//       lane alignment only, lanes that never pass the mask, with no
//       counterpart here;
// as instances of one template (`column_half_kernel`): a mask (`Mask`), a
// reciprocal (exact, or rcp.approx plus one Newton step) and where the
// reactions land (`Land`), each pass numbered as
// prof/column_half_kernels.SPECS numbers it (`launch` below).
//
// What bounds it on this card: issue slots and latency, as K8's walk
// (lj_plane_half.cu, the same function as P5 full on the same buffer), not
// bytes: the bound of the 32k pass is 0.000462 ms of bytes (inputs read
// once, outputs written once). The first design gave each column one block
// with `zb` warp rows, staged each of the 14 blocks for every row with two
// block-wide barriers, walked every candidate slot at every lane (pads and
// far candidates included), added each reaction with three shared atomics
// per pair into an accumulator per warp row or per column, and wrote those
// sums to a buffer (13 x 3 x cc per cell, or rc) that a second launch
// folded. On K8's function the walk, with reactions by global reductions
// and no buffer or fold, took 0.3x that design (PERF.md section 6).
//
// Design: cell_walk.cuh's walk over `ColumnGrid`, a sibling of
// sorted_grid::HalfGrid on the same layout: one warp per cell and no
// block-wide barrier; cp.async stages the next batch while the warp
// computes this one; only live candidates within the cutoff of the
// bounding box of the warp's own rows are packed, as (x, y, z, w) records;
// pass 1 forms each lane's mask, pass 2 runs the body over each lane's
// own list. The reactions -fij land with global reductions (red.global.add,
// four-wide in f32 where the output is interleaved), where the old design's
// shared atomics, per-cell buffer and fold were:
//   kRow     (P5 full, P3, noassembly): on the candidate's row, into an
//            output that holds zeros on entry, with each row's forward sum
//            landed the same way at the end (K8's scheme): no buffer, no
//            fold;
//   kOwnRow  (P5 redonly): the same, the own cell's (entry 0) only;
//   kTarget  (P5 batched, P2): into the candidate's (dx, dy) target block
//            and z of this column's reaction blocks, then `target_fold`
//            gathers the 5 source columns into the forward sums. Its layout
//            is internal: [nx*ny, nz, 5, cc] rows, interleaved (x, y, z, -)
//            in f32 where kFourWideTargets (four-wide reductions), three
//            planes otherwise;
//   kScriptTarget (P8): the same blocks in the script's rc layout
//            [nx*ny, 3, nz, 5*cc], one reduction per component, no fold:
//            the caller folds rc with torch.roll;
//   kNone    (P5 noreverse, P11): forward sums only, each row written once.
// So the sums land in an order that varies from run to run, and every
// output that takes reductions must hold zeros on entry (the wrappers
// allocate it zeroed; that fill is part of each pass's device time).
//
// Where the template has to take care:
//   - The entry of a kept candidate. A target pass needs each kept
//     candidate's stencil entry s (its target block kTargetOf[s] and its z)
//     and the candidate's row alone does not name it: at nx = 2 or ny = 2
//     the offsets (1, -1) and (1, 1) reach the same column but are
//     different target blocks. So the pack step keeps, beside each kept
//     record, its landing index computed from its entry (`Entry::land`,
//     `row` below) in place of the row: the row (kRow), the row or -1
//     (kOwnRow: entries s > 0 are not landed), or its slot in the target
//     blocks.
//   - The id-free pair rule after compaction (P2, P11 fused). Records carry
//     no id, so w carries the candidate's slot in its cell for entry 0 and
//     cc beyond it, the own row's w its slot, and `other` is w_own < w_cand
//     (P2's slot order; the compaction keeps each record's own slot). Both
//     masks need 0 < r2: `dist` turns r2 = 0 into +inf, so the cutoff test
//     drops it, which also drops a coincident distinct pair, as the twins
//     do; P11 fused takes the own cell's pairs in both orders and drops
//     the self pair by r2 alone. r2 is clamped at 0.25 before the
//     reciprocal in the id-free bodies, as in the scripts.
//   - P5 noassembly (`kUnstaged`) times the pass without the staging: the
//     candidates are never read. A NaN stage fails `near_box` and every
//     r2 test, so a pruned walk would keep nothing, give zeros where the
//     twin gives NaN, and time no pair at all. So this instance copies
//     nothing, takes every slot as kept with a NaN record and its row from
//     the geometry (there is no validity channel to read), and sets full
//     masks in place of pass 1 (G::kFullMasks); pass 2 then runs the body
//     over the NaN stage, and every forward sum and reaction is NaN. All
//     lanes then take the same slot at each step, so their landings are
//     rotated within the tile (`Reactions`, Rotate), or the 32 reductions
//     of a step would all hit one row.
//   - `zb`, the scripts' z chunk: here the warps (cells) of one block,
//     consecutive cells being consecutive z of one column. It sets the
//     occupancy, never the result. The passes whose entry points ask for
//     a z chunk (P2 at 2 and 4, P11 at nz, 4, 2 and 1) are compiled for
//     those values, 3 and 12 being nz of the 6- and 20-cell melts, each
//     under launch bounds of its own; every other pass runs four cells a
//     block (cell_walk.cuh's kWarpsPerBlock). Any other value is refused.
//   - Pads are told by position and skipped where the box keeps them out
//     of every cutoff (sorted_grid.cuh, conditions (a)-(c)); where it does
//     not, every row and candidate is walked and the mask decides, as in
//     the twins. P3's own_id >= 0 takes a pad own row out of the walk.
// r2 is formed with explicitly rounded products and sums, as the plain
// twin forms it; the exact reciprocal is an IEEE divide.

#include <math.h>

#include "sorted_grid.cuh"

namespace {

using cell_stencil::kHalf;
using cell_stencil::wrap_dim;
using cell_walk::Cand;
using cell_walk::kTile;

constexpr int kEntries = cell_stencil::kHalfBlocks;
// reaction targets: the distinct (dx, dy) of the half stencil, in the order
// of prof_kernel_writeonce.py's _TARGETS (:27), and each entry's target
constexpr int kTargets = 5;
__constant__ int kTargetXY[kTargets][2] = {
    {0, 0}, {0, 1}, {1, -1}, {1, 0}, {1, 1}};
__constant__ int kTargetOf[kEntries] = {0, 0, 1, 1, 1, 2, 2, 2,
                                        3, 3, 3, 4, 4, 4};

// the folded target passes' reaction blocks: interleaved, one four-wide
// reduction per reaction in f32 (false: three planes, one per component)
constexpr bool kFourWideTargets = true;

enum Mask { kIds, kIdsLive, kSlot, kDist, kUnstaged };
enum Land { kNone, kRow, kOwnRow, kTarget, kScriptTarget };

template <typename T> struct Args {
  const T* gx;
  const T* gy;
  const T* gz;
  const T* gi;
  const T* prd;
  T* out;  // kRow, kOwnRow: Landing<T, true> over the rows; else [3, rows]
  T* rc;   // kTarget: [nx*ny*nz*5*cc] rows (Landing<T, kFourWideTargets>);
           // kScriptTarget: [nx*ny, 3, nz, 5*cc]
  int nx, ny, nz, cc;
  T idcap, lj1, lj2, cutsq;
};

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 1/x: exact, or the hardware approximation (f64: seeded from the f32 one)
// refined by one Newton step, y (2 - x y), as the scripts' approx bodies
template <typename T, bool Approx>
__device__ __forceinline__ T recip(T x) {
  if constexpr (Approx) {
    const T y = static_cast<T>(rcp_approx(static_cast<float>(x)));
    return y * (T(2) - x * y);
  } else {
    return T(1) / x;
  }
}

// The lj/cut body of the walk (cell_walk.cuh's LjBody with the scripts'
// reciprocal, and r2 clamped at 0.25 in the id-free bodies).
template <typename T, bool Approx, bool Clamp> struct Body {
  static constexpr int kAcc = 3;
  static constexpr int kPairs = 2;
  T lj1, lj2;
  __device__ T term(const Cand<T>&, const Cand<T>&, T r2) const {
    const T r2inv = recip<T, Approx>(Clamp ? fmax(r2, T(0.25)) : r2);
    const T r6inv = r2inv * r2inv * r2inv;
    return r6inv * (lj1 * r6inv - lj2) * r2inv;
  }
  static __device__ T part(const T (&d)[3], T fpair, int a) {
    return d[a] * fpair;
  }
};

// Where sums land: entry i of `out`, which holds zeros on entry. Four:
// interleaved (x, y, z, -) in f32, one four-wide reduction (sm_90's float4
// atomicAdd); otherwise, and in f64, three components `stride` apart, one
// reduction each.
template <typename T, bool Four> struct Landing {
  T* out;
  int stride;

  __device__ void add(int i, T x, T y, T z) const {
    if constexpr (Four && sizeof(T) == 4) {
      atomicAdd(reinterpret_cast<float4*>(out) + i,
                make_float4(x, y, z, 0.0f));
    } else {
      atomicAdd(out + i, x);
      atomicAdd(out + stride + i, y);
      atomicAdd(out + 2 * stride + i, z);
    }
  }
};

// The reactions: each pair's -fij at the kept candidate's landing index
// (Drop: an index of -1 is not landed). Rotate (the unstaged instance,
// where every lane takes every kept slot of a tile in the same order):
// lane L lands the reaction of slot s at the tile's slot (s + L) mod n, so
// the warp's reductions of one step hit n rows and not one (the old
// design's lanes were rotated alike); every value is NaN there, so which
// row takes which pair's NaN does not change the result.
template <typename T, bool Four, bool Drop, bool Rotate = false>
struct Reactions : Landing<T, Four> {
  static constexpr bool kOn = true;

  template <typename B, typename S>
  __device__ void pair(const S& sm, int slot, const T (&d)[3], T f) const {
    int i;
    if constexpr (Rotate) {
      const int base = slot & ~(kTile - 1);
      const int n = sm.bounds()[slot / kTile];
      i = sm.rows()[base + (slot - base + int(threadIdx.x)) % n];
    } else {
      i = sm.rows()[slot];
    }
    if (Drop && i < 0) return;
    this->add(i, -B::part(d, f, 0), -B::part(d, f, 1), -B::part(d, f, 2));
  }
};

// The walk's geometry (cell_walk.cuh `G`) for the column passes: the half
// stencil of sorted_grid::HalfGrid on the same layout, with the record's w,
// the pair rule and the landing index of each mask and reaction scheme.
template <typename T, Mask M, Land L>
struct ColumnGrid : sorted_grid::SortedGrid<T, 4> {
  using Base = sorted_grid::SortedGrid<T, 4>;
  static constexpr bool kIdMask = M == kIds || M == kIdsLive;
  T idcap;
  int col;  // this warp's column, cx * ny + cy

  struct Entry : Base::Entry {
    int s;     // the stencil entry
    int land;  // the landing index of its first slot (-1: not landed)
  };
  static constexpr int kEntries = cell_stencil::kHalfBlocks;
  static constexpr int kBatch = 7;
  static constexpr bool kRows = L != kNone;
  static constexpr bool kFullMasks = M == kUnstaged;

  __device__ Entry entry(int s) const {
    Entry e;
    const int wx = wrap_dim(this->cx + kHalf[s][0], this->nx, this->px,
                            &e.shx);
    const int wy = wrap_dim(this->cy + kHalf[s][1], this->ny, this->py,
                            &e.shy);
    const int wz = wrap_dim(this->cz + kHalf[s][2], this->nz, this->pz,
                            &e.shz);
    e.base = ((wx * this->ny + wy) * this->nz + wz) * this->cc;
    e.s = s;
    if constexpr (L == kOwnRow) {
      e.land = s == 0 ? e.base : -1;
    } else if constexpr (L == kTarget) {
      e.land = ((col * this->nz + wz) * kTargets + kTargetOf[s]) * this->cc;
    } else if constexpr (L == kScriptTarget) {
      e.land = ((col * 3 * this->nz + wz) * kTargets + kTargetOf[s]) *
               this->cc;
    } else {
      e.land = e.base;
    }
    return e;
  }

  __device__ Entry fetch(const Entry& m, int s) const {
    Entry e;
    e.base = __shfl_sync(0xffffffffu, m.base, s);
    e.shx = __shfl_sync(0xffffffffu, m.shx, s);
    e.shy = __shfl_sync(0xffffffffu, m.shy, s);
    e.shz = __shfl_sync(0xffffffffu, m.shz, s);
    e.s = __shfl_sync(0xffffffffu, m.s, s);
    if constexpr (L == kOwnRow || L == kTarget || L == kScriptTarget) {
      e.land = __shfl_sync(0xffffffffu, m.land, s);
    } else {
      e.land = e.base;
    }
    return e;
  }

  // positions, and the ids where the mask reads them; nothing unstaged
  __device__ void issue_a(const Entry& e, int k, int lane, T* raw) const {
    if constexpr (M != kUnstaged) {
      const int j = k * kTile + lane;
      if (j >= this->cc) return;
      cell_walk::copy_async(raw + lane, this->g.x + e.base + j);
      cell_walk::copy_async(raw + kTile + lane, this->g.y + e.base + j);
      cell_walk::copy_async(raw + 2 * kTile + lane, this->g.z + e.base + j);
      if constexpr (kIdMask)
        cell_walk::copy_async(raw + 3 * kTile + lane, this->g.w + e.base + j);
    }
  }

  // The record: shifted across the box as the twin shifts it; w the id
  // (offset by idcap beyond the own cell, -1 stays -1), or the slot in the
  // own cell (cc beyond it); unstaged, NaN and kept wherever a slot is.
  __device__ bool pack(const Entry& e, int k, int lane, const T* raw,
                       Cand<T>* c) const {
    const int j = k * kTile + lane;
    if (j >= this->cc) {
      *c = {T(0), T(0), T(0), T(0)};
      return false;
    }
    if constexpr (M == kUnstaged) {
      *c = {T(NAN), T(NAN), T(NAN), T(NAN)};
      return true;
    } else {
      const T x = raw[lane];
      T w = T(0);
      if constexpr (kIdMask) {
        w = raw[3 * kTile + lane];
        if (e.s > 0) w = w >= T(0) ? w + idcap : T(-1);
      } else if constexpr (M == kSlot) {
        w = e.s == 0 ? T(j) : T(this->cc);
      }
      *c = {x + e.shx, raw[kTile + lane] + e.shy,
            raw[2 * kTile + lane] + e.shz, w};
      return !this->skip_pads || x < T(sorted_grid::kPadPos / 2);
    }
  }

  __device__ bool near(const cell_walk::Box<T>& b, const Cand<T>& c,
                       T near_cutsq) const {
    if constexpr (M == kUnstaged) {
      return true;
    } else {
      return cell_walk::near_box(b, c, near_cutsq);
    }
  }

  // r2 as the twin rounds it; the id-free masks drop r2 = 0 through the
  // cutoff test
  __device__ T dist(const Cand<T>& o, const Cand<T>& c, T& dx, T& dy,
                    T& dz) const {
    const T r2 = Base::dist(o, c, dx, dy, dz);
    if constexpr (M == kSlot || M == kDist) {
      return r2 > T(0) ? r2 : T(INFINITY);
    } else {
      return r2;
    }
  }

  // the pair rule: ids, or the own cell's slot order
  __device__ bool other(const Cand<T>& o, const Cand<T>& c) const {
    if constexpr (kIdMask || M == kSlot) {
      return o.w < c.w;
    } else {
      return true;
    }
  }

  // the landing index of candidate `lane` of tile k
  __device__ int row(const Entry& e, int k, int lane) const {
    if constexpr (L == kOwnRow) {
      return e.land < 0 ? -1 : e.land + k * kTile + lane;
    } else {
      return e.land + k * kTile + lane;
    }
  }
};

template <typename T, Mask M, bool Approx, Land L, int W>
__global__ void __launch_bounds__(kTile * W)
    column_half_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Geo = ColumnGrid<T, M, L>;
  const int ncell = a.nx * a.ny * a.nz;
  const int cell = blockIdx.x * W + threadIdx.y;
  if (cell >= ncell) return;  // the whole warp
  const auto sm = cell_walk::warp_smem<T, Geo>(smem_raw);

  const int cz = cell % a.nz, col = cell / a.nz;
  const int tiles = (a.cc + kTile - 1) / kTile;
  const T px = a.prd[0], py = a.prd[1], pz = a.prd[2];
  const bool skip_pads =
      M != kUnstaged &&
      sorted_grid::pads_apart(px, py, pz, a.nx, a.ny, a.nz, a.cc);
  const Geo geo{{{a.gx, a.gy, a.gz, a.gi}, a.nx, a.ny, a.nz, a.cc, tiles,
                 col / a.ny, col % a.ny, cz, px, py, pz, skip_pads},
                a.idcap, col};
  const Body<T, Approx, M == kSlot || M == kDist> body{a.lj1, a.lj2};
  const int rows = ncell * a.cc;
  const Landing<T, true> sums{a.out, rows};
  const int lane = threadIdx.x;

  for (int rp = 0; rp < tiles; ++rp) {
    const int j = rp * kTile + lane;
    const int row = cell * a.cc + j;
    Cand<T> own = {T(0), T(0), T(0), T(0)};
    if (j < a.cc) {
      own = {a.gx[row], a.gy[row], a.gz[row], T(0)};
      if constexpr (Geo::kIdMask) {
        own.w = a.gi[row];
      } else if constexpr (M == kSlot) {
        own.w = T(j);
      }
    }
    bool live =
        j < a.cc && (!skip_pads || own.x < T(sorted_grid::kPadPos / 2));
    if constexpr (M == kIdsLive) live = live && own.w >= T(0);
    T acc[3] = {T(0), T(0), T(0)};
    const bool any = __any_sync(0xffffffffu, live);
    if constexpr (L == kNone) {
      if (any) cell_walk::walk(geo, body, own, live, -1, a.cutsq, sm, acc);
    } else if constexpr (L == kRow || L == kOwnRow) {
      const Reactions<T, true, L == kOwnRow, M == kUnstaged> react{
          {a.out, rows}};
      if (any)
        cell_walk::walk(geo, body, own, live, -1, a.cutsq, sm, acc, react);
    } else if constexpr (L == kTarget) {
      const Reactions<T, kFourWideTargets, false> react{
          {a.rc, rows * kTargets}};
      if (any)
        cell_walk::walk(geo, body, own, live, -1, a.cutsq, sm, acc, react);
    } else {
      const Reactions<T, false, false> react{
          {a.rc, a.nz * kTargets * a.cc}};
      if (any)
        cell_walk::walk(geo, body, own, live, -1, a.cutsq, sm, acc, react);
    }
    if constexpr (L == kRow || L == kOwnRow) {
      if (live) sums.add(row, acc[0], acc[1], acc[2]);
    } else if (j < a.cc) {
      a.out[row] = acc[0];
      a.out[rows + row] = acc[1];
      a.out[2 * rows + row] = acc[2];
    }
  }
}

// out[c][row] += the 5 target blocks aimed at row's cell: block t of the
// column at (tx, ty) - TARGETS[t] (periodic), z already aligned by the
// pass. A gather, one thread per row, no atomics.
template <typename T>
__global__ void target_fold(const T* __restrict__ rc, T* __restrict__ out,
                            int nx, int ny, int nz, int cc) {
  const int rows = nx * ny * nz * cc;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int lane = row % cc, cell = row / cc;
  const int tz = cell % nz, t = cell / nz;
  const int ty = t % ny, tx = t / ny;
  const int n = rows * kTargets;
  T a0 = T(0), a1 = T(0), a2 = T(0);
  for (int k = 0; k < kTargets; ++k) {
    const int sx = (tx - kTargetXY[k][0] + nx) % nx;
    const int sy = (ty - kTargetXY[k][1] + ny) % ny;
    const int i = (((sx * ny + sy) * nz + tz) * kTargets + k) * cc + lane;
    if constexpr (kFourWideTargets && sizeof(T) == 4) {
      const float4 v = reinterpret_cast<const float4*>(rc)[i];
      a0 += v.x;
      a1 += v.y;
      a2 += v.z;
    } else {
      a0 += rc[i];
      a1 += rc[n + i];
      a2 += rc[2 * n + i];
    }
  }
  out[row] += a0;
  out[rows + row] += a1;
  out[2 * rows + row] += a2;
}

constexpr int kFoldThreads = 256;

template <typename T, Mask M, bool Approx, Land L, int W>
int launch_pass(const Args<T>& a, cudaStream_t st) {
  using Geo = ColumnGrid<T, M, L>;
  const int ncell = a.nx * a.ny * a.nz;
  const size_t smem = size_t(W) * cell_walk::SmemOf<T, Geo>::kBytes;
  void (*kernel)(Args<T>) = column_half_kernel<T, M, Approx, L, W>;
  static bool opted_in = false;  // above 48 KB, once per instance
  if (smem > 48 * 1024 && !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  kernel<<<dim3((ncell + W - 1) / W), dim3(kTile, W), smem, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || L != kTarget) return static_cast<int>(err);
  const int rows = ncell * a.cc;
  target_fold<T><<<(rows + kFoldThreads - 1) / kFoldThreads, kFoldThreads,
                   0, st>>>(a.rc, a.out, a.nx, a.ny, a.nz, a.cc);
  return static_cast<int>(cudaGetLastError());
}

// the passes that take a z chunk: one instance per value their entry
// points ask for (prof/column_half_kernels.ZB): 2 and 4, and with All also
// 1, 3 and 12
template <typename T, Mask M, bool Approx, Land L, bool All>
int launch_chunked(const Args<T>& a, int w, cudaStream_t st) {
  switch (w) {
    case 2:
      return launch_pass<T, M, Approx, L, 2>(a, st);
    case 4:
      return launch_pass<T, M, Approx, L, 4>(a, st);
  }
  if constexpr (All) {
    switch (w) {
      case 1:
        return launch_pass<T, M, Approx, L, 1>(a, st);
      case 3:
        return launch_pass<T, M, Approx, L, 3>(a, st);
      case 12:
        return launch_pass<T, M, Approx, L, 12>(a, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, Mask M, bool Approx, Land L>
int launch_fixed(const Args<T>& a, int w, cudaStream_t st) {
  if (w != cell_walk::kWarpsPerBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_pass<T, M, Approx, L, cell_walk::kWarpsPerBlock>(a, st);
}

// the passes, numbered as prof/column_half_kernels.SPECS numbers them; w
// cells a block
template <typename T>
int launch(int pass, const Args<T>& a, int w, cudaStream_t st) {
  switch (pass) {
    case 0:  // P5 full
      return launch_fixed<T, kIds, false, kRow>(a, w, st);
    case 1:  // P5 batched
      return launch_fixed<T, kIds, false, kTarget>(a, w, st);
    case 2:  // P5 redonly
      return launch_fixed<T, kIds, false, kOwnRow>(a, w, st);
    case 3:  // P5 noreverse, P11 fwd (w: P11's z chunks)
      return launch_chunked<T, kIds, false, kNone, true>(a, w, st);
    case 4:  // P5 noassembly
      return launch_fixed<T, kUnstaged, false, kRow>(a, w, st);
    case 5:  // P2, exact reciprocal (w: 2 or 4)
      return launch_chunked<T, kSlot, false, kTarget, false>(a, w, st);
    case 6:  // P2, approximate reciprocal (w: 2 or 4)
      return launch_chunked<T, kSlot, true, kTarget, false>(a, w, st);
    case 7:  // P11 fused (w: P11's z chunks)
      return launch_chunked<T, kDist, true, kNone, true>(a, w, st);
    case 8:  // P3 (prof_kernel_cc32.py T2): full with own_i >= 0
      return launch_fixed<T, kIdsLive, false, kRow>(a, w, st);
    case 9:  // P8
      return launch_fixed<T, kIds, false, kScriptTarget>(a, w, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). Launch pass `pass` with `w`
// cells a block (and the fold where the pass has one) on `stream`, do not
// synchronise; return cudaGetLastError() after the launches (0 = success;
// a (pass, w) not compiled is cudaErrorInvalidValue). `out`: passes 0, 2,
// 4 and 8 add into it, which must hold zeros ([rows, 4] interleaved in f32,
// [3, rows] in f64); the others write [3, rows]. `rc`: pass 1, 5 and 6's
// reaction blocks, nx*ny*nz*5*cc rows (4 values a row in f32, 3 planes in
// f64), and pass 9's rc [nx*ny, 3, nz, 5*cc]: zeros on entry; unused
// otherwise. `gi` is unused by the id-free passes (5, 6, 7) and pass 4.
#define LJ_COLUMN_HALF_ENTRY(NAME, T)                                        \
  extern "C" int NAME(int pass, int w, const void* gx, const void* gy,      \
                      const void* gz, const void* gi, const void* prd,      \
                      void* out, void* rc, int nx, int ny, int nz, int cc,  \
                      double idcap, double lj1, double lj2, double cutsq,   \
                      void* stream) {                                       \
    const Args<T> a{static_cast<const T*>(gx), static_cast<const T*>(gy),   \
                    static_cast<const T*>(gz), static_cast<const T*>(gi),   \
                    static_cast<const T*>(prd), static_cast<T*>(out),       \
                    static_cast<T*>(rc), nx, ny, nz, cc,                    \
                    static_cast<T>(idcap), static_cast<T>(lj1),             \
                    static_cast<T>(lj2), static_cast<T>(cutsq)};            \
    return launch<T>(pass, a, w, static_cast<cudaStream_t>(stream));        \
  }

LJ_COLUMN_HALF_ENTRY(lj_column_half_f32, float)
LJ_COLUMN_HALF_ENTRY(lj_column_half_f64, double)
