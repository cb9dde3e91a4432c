// The candidate walk of the port's sorted and dense cell kernels (sm_90a):
// lj_cell_force.cu, eam_cell.cu, lj_plane_half.cu, lj_column_half.cu and
// lj_column_full.cu's K7 and P6 (the sorted layout, sorted_grid.cuh) and
// lj_cell_dense.cu (list mode "cell").
//
// Unit of work: one warp owns up to 32 rows of one cell (a row pass) and
// walks that cell's stencil entries on its own (G::kEntries neighbour
// blocks: the 27 of the full stencil, or the 14 of the half stencil in
// lj_plane_half.cu), with no block-wide barrier; a cell with more rows
// runs its further row passes in the same warp. A neighbour block's
// candidates are cut into tiles of 32 (tiles = cc / 32 rounded up), so a
// walk is kEntries * tiles tiles in stencil order. The warp stages
// G::kBatch tiles at a time: their positions are copied
// asynchronously (cp.async) while it computes the batch before, then each
// tile's kept candidates are packed in walk order into shared memory: the
// live ones (not pads or empty lanes) that may lie within the cutoff of
// the bounding box of the warp's own rows (a conservative test with a
// rounding margin: `near_box`, and the minimum-image form in
// lj_cell_dense.cu). Then, with two passes (G::kTwoPass):
//   pass 1: each lane forms r2 for each kept candidate and keeps those
//           inside the cutoff as bits of one 32-bit mask per tile (in
//           shared memory, one word per lane);
//   pass 2: each lane runs the pair body over the set bits of its own
//           masks, in walk order, B::kPairs pairs an iteration (two give
//           two independent chains through the body), so the warp pays
//           for its longest in-cutoff list instead of the body at every
//           candidate where any lane is inside the cutoff;
// or with one pass the body sits inside the candidate loop. Pass 2
// recomputes the displacement and r2 with the same rounded operations as
// pass 1, so the body sees the bits the cutoff test saw (but in a framed
// tile, below). Candidates are
// staged as three planes (x, y, z) or, where they carry a fourth word (the
// atom index, or EAM's fp), as packed (x, y, z, w) records: one 16-byte
// shared load in f32.
//
// Reactions (Newton-half passes): with a reaction policy `R` whose kOn is
// true, the pack step keeps each kept candidate's row beside its record
// (the geometry's kRows; in lj_column_half.cu, a landing index computed
// from the candidate's stencil entry) and pass 2 hands every pair to
// R::pair, which lands the reaction there (lj_plane_half.cu,
// lj_column_half.cu). NoReactions compiles that out.
//
// Frames (lj_cell_force.cu, sorted_grid::FramedGrid): a geometry with
// kHalfFrames decides each pair of a full-stencil walk in the frame in
// which the Newton-half kernels form it, so that both rows of a pair take
// the cutoff decision the half stencil takes once for the pair. An entry
// whose first nonzero offset is negative (a mirrored entry) holds
// candidates whose half-stencil frame is the candidate's own: where it
// wraps, its records are staged unshifted, pass 1 forms r2 from the own
// row moved by -shift, d = (own - shift) - cand (and the prune tests the
// moved rows' box), and then the records are shifted as the plain walk
// stages them, so pass 2 is the plain one: there the body sees r2 formed
// in the candidate's frame, up to an ulp of the box length apart from the
// decided one (the lj body reads no cutoff). A batch with no such tile
// runs the plain passes, and a cell with no such entry pays nothing.
//
// The pair body `B` is a template parameter (LjBody below; eam_cell.cu's
// two bodies):
//   static constexpr int kAcc;     accumulators per row (3: a force; 1)
//   static constexpr int kPairs;   pairs an iteration of pass 2 (1 or 2)
//   E term(const Cand<T>& own, const Cand<T>& c, T r2);  the pair's term
//       (E is T, or a struct of several values that part reads)
//   static T part(const T (&d)[3], E term, int a);  its share of acc[a]
//       (d = own - c)

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "cell_stencil.cuh"

namespace cell_walk {

using cell_stencil::Rn;

constexpr int kBatch = 9;        // tiles per batch in f32 of the full
                                 // stencil: one x-plane at cc <= 32
constexpr int kTile = 32;        // candidates per tile, rows per row pass
constexpr int kWarpsPerBlock = 4;

// the kernels' launch bounds: one block of kWarpsPerBlock warps
#define CELL_WALK_BOUNDS __launch_bounds__(128)

// the unit roundoff of T
template <typename T> struct Unit;
template <> struct Unit<float> {
  static constexpr float kRoundoff = 0x1p-24f;
};
template <> struct Unit<double> {
  static constexpr double kRoundoff = 0x1p-53;
};

// a staged candidate (or an own row): position and one 32-bit word
template <typename T> struct Cand { T x, y, z, w; };

// the bits of an int carried in the w slot (no arithmetic touches them)
__device__ __forceinline__ float int_bits(int i, float) {
  return __int_as_float(i);
}
__device__ __forceinline__ double int_bits(int i, double) {
  return __longlong_as_double(static_cast<long long>(i));
}
__device__ __forceinline__ int bits_int(float v) { return __float_as_int(v); }
__device__ __forceinline__ int bits_int(double v) {
  return static_cast<int>(__double_as_longlong(v));
}

// Shared memory of one warp: the batch's kept candidates, its raw planes
// (the asynchronous copies land there, P planes per tile), one mask word
// per (tile, lane), the tiles' candidate counts and, with Rows, each kept
// candidate's row. A batch is Batch tiles in f32, a third of that in f64
// (the same bytes). With P = 3 the candidates are three planes x, y, z
// (one 4- or 8-byte shared load per component); with P = 4 packed (x, y,
// z, w) records (one 16-byte load in f32, two in f64).
template <typename T, int P, int Batch, bool Rows> struct WarpSmem {
  static constexpr bool kPacked = P == 4;
  static constexpr int kTiles =
      sizeof(T) == 4 ? Batch : (Batch + 2) / 3;
  static constexpr int kSlots = kTiles * kTile;
  static constexpr size_t kStage = size_t(P) * kSlots * sizeof(T);
  static constexpr size_t kRaw = kStage;
  static constexpr size_t kMasks = size_t(kSlots) * 4;
  static constexpr size_t kBounds = ((kTiles * 4 + 15) / 16) * 16;
  static constexpr size_t kRows = Rows ? size_t(kSlots) * 4 : 0;
  static constexpr size_t kBytes = kStage + kRaw + kMasks + kBounds + kRows;
  static_assert(kWarpsPerBlock * kBytes <= 48 * 1024,
                "a block's shared memory stays within the default 48 KB");

  unsigned char* base;
  __device__ T* stage() const { return reinterpret_cast<T*>(base); }
  __device__ T* raw() const { return reinterpret_cast<T*>(base + kStage); }
  __device__ unsigned* masks() const {
    return reinterpret_cast<unsigned*>(base + kStage + kRaw);
  }
  __device__ int* bounds() const {
    return reinterpret_cast<int*>(base + kStage + kRaw + kMasks);
  }
  __device__ int* rows() const {
    return reinterpret_cast<int*>(base + kStage + kRaw + kMasks + kBounds);
  }

  __device__ void put(int i, const Cand<T>& c) const {
    T* p = stage();
    if constexpr (kPacked && sizeof(T) == 4) {
      reinterpret_cast<float4*>(p)[i] = make_float4(c.x, c.y, c.z, c.w);
    } else if constexpr (kPacked) {
      reinterpret_cast<double2*>(p)[2 * i] = make_double2(c.x, c.y);
      reinterpret_cast<double2*>(p)[2 * i + 1] = make_double2(c.z, c.w);
    } else {
      p[i] = c.x;
      p[kSlots + i] = c.y;
      p[2 * kSlots + i] = c.z;
    }
  }
  __device__ Cand<T> get(int i) const {
    const T* p = stage();
    if constexpr (kPacked && sizeof(T) == 4) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      return {v.x, v.y, v.z, v.w};
    } else if constexpr (kPacked) {
      const double2 a = reinterpret_cast<const double2*>(p)[2 * i];
      const double2 b = reinterpret_cast<const double2*>(p)[2 * i + 1];
      return {a.x, a.y, b.x, b.y};
    } else {
      return {p[i], p[kSlots + i], p[2 * kSlots + i], T(0)};
    }
  }
};

template <typename T, typename G>
using SmemOf = WarpSmem<T, G::kPlanes, G::kBatch, G::kRows>;

// this warp's shared memory (the block's warps sit side by side)
template <typename T, typename G>
__device__ __forceinline__ SmemOf<T, G> warp_smem(unsigned char* smem) {
  return {smem + size_t(threadIdx.y) * SmemOf<T, G>::kBytes};
}

// the lj/cut body, as every lj kernel of the port writes it; 1/r2 is an
// IEEE divide (nvcc's default -prec-div=true)
template <typename T>
__device__ __forceinline__ T lj_fpair(T r2, T lj1, T lj2) {
  const T r2inv = T(1) / r2;
  const T r6inv = r2inv * r2inv * r2inv;
  return r6inv * (lj1 * r6inv - lj2) * r2inv;
}

// the lj/cut pair body of the walk: the force d * fpair
template <typename T> struct LjBody {
  static constexpr int kAcc = 3;
  static constexpr int kPairs = 2;
  T lj1, lj2;
  __device__ T term(const Cand<T>&, const Cand<T>&, T r2) const {
    return lj_fpair(r2, lj1, lj2);
  }
  static __device__ T part(const T (&d)[3], T fpair, int a) {
    return d[a] * fpair;
  }
};

// The own rows' bounding box (over the live lanes of the warp).
template <typename T> struct Box {
  T lo[3], hi[3];
};

template <typename T>
__device__ __forceinline__ Box<T> own_box(const Cand<T>& own, bool live) {
  const T inf = T(INFINITY);
  Box<T> b = {{live ? own.x : inf, live ? own.y : inf, live ? own.z : inf},
              {live ? own.x : -inf, live ? own.y : -inf, live ? own.z : -inf}};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      b.lo[a] = min(b.lo[a], __shfl_xor_sync(0xffffffffu, b.lo[a], off));
      b.hi[a] = max(b.hi[a], __shfl_xor_sync(0xffffffffu, b.hi[a], off));
    }
  }
  return b;
}

// Whether candidate c may lie within the cutoff of some point of the box,
// in one frame (no minimum image): the squared gap S between c and the box,
// each operation rounded, against cutsq (1 + 2^-12). Exact: if S exceeds
// that, every own row i of the box has r2(i, c) >= cutsq as the kernels
// round r2, so the plain twin rejects the pair too. Proof: with gap g_a >= 0
// per axis, S <= (sum g_a^2)(1 + u)^5 (one rounding in the gap, its square
// and two sums; u the unit roundoff), and for a row o in the box
// |o_a - c_a| >= g_a, so the rounded r2 >= (sum g_a^2)(1 - u)^5; hence
// r2 >= S (1 - u)^5 / (1 + u)^5 > cutsq (1 + 2^-12 - u)(1 - 10.1 u) >
// cutsq for u <= 2^-24.
template <typename T>
__device__ __forceinline__ bool near_box(const Box<T>& b, const Cand<T>& c,
                                         T near_cutsq) {
  const T cs[3] = {c.x, c.y, c.z};
  T s = T(0);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T g = max(max(b.lo[a] - cs[a], cs[a] - b.hi[a]), T(0));
    s = Rn<T>::add(s, Rn<T>::mul(g, g));
  }
  return s <= near_cutsq;
}

// near_box for the own rows moved by -t (a framed tile, HalfFrames below):
// rounding is monotonic, so the moved rows lie in [lo - t, hi - t], each
// bound rounded (their box exactly: lo and hi are rows), and the proof
// above holds in that frame
template <typename T>
__device__ __forceinline__ bool near_moved_box(const Box<T>& b,
                                               const T (&t)[3],
                                               const Cand<T>& c,
                                               T near_cutsq) {
  const T cs[3] = {c.x, c.y, c.z};
  T s = T(0);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T g = max(max((b.lo[a] - t[a]) - cs[a], cs[a] - (b.hi[a] - t[a])),
                    T(0));
    s = Rn<T>::add(s, Rn<T>::mul(g, g));
  }
  return s <= near_cutsq;
}

// asynchronous 4- or 8-byte copy from device to shared memory (cp.async:
// no register holds the value, so a batch's loads fly while the warp
// computes the previous one)
template <typename V>
__device__ __forceinline__ void copy_async(V* dst, const V* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(V)));
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The walk of one row pass. `G` supplies the geometry of one kernel:
//   int cc, tiles;                   rows per cell, tiles per block
//   static constexpr int kEntries;   stencil entries (27, or 14: half)
//   static constexpr int kBatch;     tiles per batch in f32
//   static constexpr bool kRows;     keep each kept candidate's row (for
//                                    R)
//   static constexpr int kPlanes;    raw and staged planes (3: x, y, z;
//                                    4: and the atom index, packed)
//   static constexpr bool kTwoPass;  the body in pass 2, or in the loop
//   struct Entry;                    what a tile needs of its stencil entry
//   Entry entry(int s);              stencil entry s (lane s computes it)
//   Entry fetch(const Entry& mine, int s);   lane s's entry, to every lane
//   static constexpr bool kIndexFirst;       issue_a's copies must land
//                                    before issue_b reads them
//   void issue_a(e, k, lane, T* raw), issue_b(e, k, lane, T* raw);
//       the asynchronous copies of candidate `lane` of tile k into the
//       tile's raw planes raw[c * kTile + lane], c < kPlanes
//   bool pack(e, k, lane, const T* raw, Cand<T>* c);  the record from the
//       raw planes, and whether it is a live candidate
//   bool near(const Box<T>&, const Cand<T>&, T near_cutsq);  may it be
//       within the cutoff of the own rows (conservative: see near_box)
//   T dist(const Cand<T>& own, const Cand<T>& c, T& dx, T& dy, T& dz);
//       the displacement own - c and r2, rounded as the plain twin
//   bool other(const Cand<T>& own, const Cand<T>& c);  not the self pair
//       (or, in a Newton-half pass, the pair rule)
//   int row(e, k, lane);             candidate `lane` of tile k's row (read
//                                    only where R is on), or whatever index
//                                    R lands its reaction at
//   static constexpr bool kFullMasks;        optional (FullMasks below):
//                                    every kept candidate is a pair
// `self_tile`: the tile whose candidate at this lane is the row itself
// (masked by its packed position), or -1 where `other` tells the self
// pair. Every lane of the warp calls it; lanes whose row is not `live`
// stage but add nothing.
//
// The reaction policy `R` (NoReactions, or lj_plane_half.cu's):
//   static constexpr bool kOn;
//   template <typename B> void pair(sm, int slot, const T (&d)[3], T f);
//       a pair of pass 2 with the kept candidate at `slot`, whose row is
//       sm.rows()[slot]
struct NoReactions {
  static constexpr bool kOn = false;
};

// G::kFullMasks, where a geometry has it (lj_column_half.cu's unstaged
// instance): pass 1 takes every kept candidate of a tile, forming no r2;
// false for a geometry without the member
template <typename G, typename = void>
struct FullMasks : std::false_type {};
template <typename G>
struct FullMasks<G, std::void_t<decltype(G::kFullMasks)>>
    : std::bool_constant<G::kFullMasks> {};

// G::kHalfFrames, where a geometry has it (sorted_grid::FramedGrid, a
// full stencil in the 27-entry order of SortedGrid, whose Entry holds the
// shifts shx, shy, shz): entries 0-12 (first nonzero offset negative) that
// wrap are decided in the frame of the Newton-half stencil (above); false
// for a geometry without the member
template <typename G, typename = void>
struct HalfFrames : std::false_type {};
template <typename G>
struct HalfFrames<G, std::void_t<decltype(G::kHalfFrames)>>
    : std::bool_constant<G::kHalfFrames> {};
constexpr int kMirrored = 13;  // entries 0-12 of the full stencil's 27

// G::kGroupEntries, where a geometry has it (sorted_grid::IdGrid's third
// parameter, P6 k2): pass 2 sums each group of that many consecutive
// stencil entries on its own and adds the group's sum into the row's total
// when the walk leaves the group, in walk order (as k2 adds its (dx, dy)
// columns); 0 for a geometry without the member (one running sum: Groups
// below compiles to nothing)
template <typename G, typename = void>
struct GroupEntries : std::integral_constant<int, 0> {};
template <typename G>
struct GroupEntries<G, std::void_t<decltype(G::kGroupEntries)>>
    : std::integral_constant<int, G::kGroupEntries> {};

// A row's sums with groups: acc holds the current group's sum, `total` the
// groups' before it. Before a pair of walk tile t at or past `next`, the
// first tile of the next group (tile t belongs to entry t / tiles), acc
// goes into the total; `finish` adds the last group's.
template <typename T, int N, bool On> struct Groups {
  __device__ void finish(T (&)[N]) const {}
};
template <typename T, int N> struct Groups<T, N, true> {
  T total[N];
  int span, next;  // tiles per group; the first tile past the current group
  __device__ void at(int t, T (&acc)[N]) {
    if (t < next) return;
#pragma unroll
    for (int a = 0; a < N; ++a) {
      total[a] += acc[a];
      acc[a] = T(0);
    }
    do next += span;
    while (t >= next);
  }
  __device__ void finish(T (&acc)[N]) const {
#pragma unroll
    for (int a = 0; a < N; ++a) acc[a] = total[a] + acc[a];
  }
};

template <typename T, typename G>
__device__ __forceinline__ void issue_batch(const G& geo,
                                            const typename G::Entry& mine,
                                            int t0, int nb, T* raw) {
  const int lane = threadIdx.x;
  int s = t0 / geo.tiles, k = t0 - s * geo.tiles;
  for (int g = 0; g < nb; ++g) {
    geo.issue_a(geo.fetch(mine, s), k, lane, raw + g * G::kPlanes * kTile);
    if (++k == geo.tiles) k = 0, ++s;
  }
  if (G::kIndexFirst) {
    copy_commit();
    copy_wait_all();
    __syncwarp();
    s = t0 / geo.tiles, k = t0 - s * geo.tiles;
    for (int g = 0; g < nb; ++g) {
      geo.issue_b(geo.fetch(mine, s), k, lane, raw + g * G::kPlanes * kTile);
      if (++k == geo.tiles) k = 0, ++s;
    }
  }
  copy_commit();
}

// The axes (bit a: axis a) in which tile g of a batch is framed: 3 bits a
// tile in `frames`; a framed tile's entry shifts axis a by sh[a] (one
// value per axis for all the wrapped mirrored entries of a cell).
__device__ __forceinline__ unsigned tile_frames(unsigned frames, int g) {
  return frames >> (3 * g) & 7u;
}

// Pass 1 of a batch: the in-cutoff candidates of each tile, as a mask per
// lane. With Framed, a framed tile holds a wrapped mirrored entry's
// unshifted records, and its r2 is formed from the own row moved by -sh
// in its framed axes.
template <bool Framed, typename T, typename G>
__device__ __forceinline__ void pass_masks(const G& geo, const Cand<T>& own,
                                           const T (&sh)[3], unsigned frames,
                                           int t0, int nb, int self_tile,
                                           unsigned self_bit, T cutsq,
                                           const SmemOf<T, G>& sm) {
  const int lane = threadIdx.x;
  const int* bounds = sm.bounds();
  unsigned* masks = sm.masks();
  for (int g = 0; g < nb; ++g) {
    const int base = g * kTile;
    const int n = bounds[g];
    unsigned m = 0;
    if constexpr (FullMasks<G>::value) {
      m = n == kTile ? ~0u : (1u << n) - 1u;
    } else {
      Cand<T> o = own;
      if constexpr (Framed) {
        const unsigned bits = tile_frames(frames, g);
        if (bits & 1u) o.x = own.x - sh[0];
        if (bits & 2u) o.y = own.y - sh[1];
        if (bits & 4u) o.z = own.z - sh[2];
      }
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const Cand<T> c = sm.get(base + j);
        T dx, dy, dz;
        const T r2 = geo.dist(o, c, dx, dy, dz);
        if (r2 < cutsq && geo.other(o, c)) m |= 1u << j;
      }
    }
    if (t0 + g == self_tile) m &= ~self_bit;
    masks[base + lane] = m;
  }
}

// The framed tiles' records shifted into the candidate's frame, as the
// plain walk stages them, for pass 2 (every lane of the warp, each its
// slot of every tile: a slot past the tile's count is never read).
template <typename T, typename G>
__device__ __forceinline__ void restage(const T (&sh)[3], unsigned frames,
                                        const SmemOf<T, G>& sm) {
  const int lane = threadIdx.x;
#pragma unroll
  for (int g = 0; g < SmemOf<T, G>::kTiles; ++g) {
    const unsigned bits = tile_frames(frames, g);
    if (bits == 0) continue;  // warp-uniform; 0 past the batch's tiles
    Cand<T> c = sm.get(g * kTile + lane);
    if (bits & 1u) c.x += sh[0];
    if (bits & 2u) c.y += sh[1];
    if (bits & 4u) c.z += sh[2];
    sm.put(g * kTile + lane, c);
  }
}

// Pass 2 of a batch, for a live row: the body over this lane's own list,
// in walk order.
template <typename T, typename G, typename B, typename R>
__device__ __forceinline__ void pass_pairs(const G& geo, const B& body,
                                           const Cand<T>& own, int nb,
                                           const SmemOf<T, G>& sm,
                                           T (&acc)[B::kAcc],
                                           const R& react) {
  const int lane = threadIdx.x;
  const unsigned* masks = sm.masks();
  int g = 0;
  unsigned m = masks[lane];
  if constexpr (B::kPairs == 1) {
    for (;;) {
      while (m == 0 && ++g < nb) m = masks[g * kTile + lane];
      if (m == 0) break;
      const int s1 = g * kTile + __ffs(m) - 1;
      const Cand<T> c = sm.get(s1);
      m &= m - 1;
      T d[3];
      const T r = geo.dist(own, c, d[0], d[1], d[2]);
      const auto f = body.term(own, c, r);
#pragma unroll
      for (int a = 0; a < B::kAcc; ++a) acc[a] += B::part(d, f, a);
      if constexpr (R::kOn) react.template pair<B>(sm, s1, d, f);
    }
  } else {
    // two pairs an iteration: two independent chains through the body
    for (;;) {
      while (m == 0 && ++g < nb) m = masks[g * kTile + lane];
      if (m == 0) break;
      const int s1 = g * kTile + __ffs(m) - 1;
      m &= m - 1;
      while (m == 0 && ++g < nb) m = masks[g * kTile + lane];
      const bool two = m != 0;
      const int s2 = two ? g * kTile + __ffs(m) - 1 : s1;
      m &= m - 1;
      const Cand<T> c1 = sm.get(s1), c2 = sm.get(s2);
      T d1[3], d2[3];
      const T r1 = geo.dist(own, c1, d1[0], d1[1], d1[2]);
      const T r2 = geo.dist(own, c2, d2[0], d2[1], d2[2]);
      const auto f1 = body.term(own, c1, r1), f2 = body.term(own, c2, r2);
#pragma unroll
      for (int a = 0; a < B::kAcc; ++a) {
        acc[a] += B::part(d1, f1, a);
        if (two) acc[a] += B::part(d2, f2, a);
      }
      if constexpr (R::kOn) {
        react.template pair<B>(sm, s1, d1, f1);
        if (two) react.template pair<B>(sm, s2, d2, f2);
      }
    }
  }
}

// Pass 2 of a batch with group sums (GroupEntries > 0), for a live row:
// pass_pairs' two chains, each pair's term added into the current group's
// sum after `groups` has closed the groups the walk left. Where the second
// pair's tile (past the batch when there is none) is still in the current
// group, so is the first: one test an iteration.
template <typename T, typename G, typename B, typename Gs>
__device__ __forceinline__ void pass_pairs_grouped(const G& geo, const B& body,
                                                   const Cand<T>& own, int t0,
                                                   int nb,
                                                   const SmemOf<T, G>& sm,
                                                   T (&acc)[B::kAcc],
                                                   Gs& groups) {
  const int lane = threadIdx.x;
  const unsigned* masks = sm.masks();
  int g = 0;
  unsigned m = masks[lane];
  for (;;) {
    while (m == 0 && ++g < nb) m = masks[g * kTile + lane];
    if (m == 0) break;
    const int g1 = g;
    const int s1 = g * kTile + __ffs(m) - 1;
    m &= m - 1;
    while (m == 0 && ++g < nb) m = masks[g * kTile + lane];
    const bool two = m != 0;
    const int s2 = two ? g * kTile + __ffs(m) - 1 : s1;
    m &= m - 1;
    const Cand<T> c1 = sm.get(s1), c2 = sm.get(s2);
    T d1[3], d2[3];
    const T r1 = geo.dist(own, c1, d1[0], d1[1], d1[2]);
    const T r2 = geo.dist(own, c2, d2[0], d2[1], d2[2]);
    const auto f1 = body.term(own, c1, r1), f2 = body.term(own, c2, r2);
    if (t0 + g < groups.next) {
#pragma unroll
      for (int a = 0; a < B::kAcc; ++a) {
        acc[a] += B::part(d1, f1, a);
        if (two) acc[a] += B::part(d2, f2, a);
      }
      continue;
    }
    groups.at(t0 + g1, acc);
#pragma unroll
    for (int a = 0; a < B::kAcc; ++a) acc[a] += B::part(d1, f1, a);
    if (two) {
      groups.at(t0 + g, acc);
#pragma unroll
      for (int a = 0; a < B::kAcc; ++a) acc[a] += B::part(d2, f2, a);
    }
  }
}

// Pass 1 and pass 2 (or the one pass) of a batch, for a live row.
template <typename T, typename G, typename B, typename R>
__device__ __forceinline__ void batch_passes(const G& geo, const B& body,
                                             const Cand<T>& own, int t0,
                                             int nb, int self_tile,
                                             unsigned self_bit, T cutsq,
                                             const SmemOf<T, G>& sm,
                                             T (&acc)[B::kAcc],
                                             const R& react) {
  if constexpr (G::kTwoPass) {
    const T none[3] = {T(0), T(0), T(0)};
    pass_masks<false>(geo, own, none, 0u, t0, nb, self_tile, self_bit, cutsq,
                      sm);
    pass_pairs(geo, body, own, nb, sm, acc, react);
  } else {
    static_assert(!R::kOn, "reactions need the two-pass walk");
    // one pass: the body inside the candidate loop, taken by the warp
    // wherever any lane is inside the cutoff
    const int* bounds = sm.bounds();
    for (int g = 0; g < nb; ++g) {
      const int n = bounds[g];
      const unsigned self = (t0 + g == self_tile) ? self_bit : 0u;
      for (int j = 0; j < n; ++j) {
        const Cand<T> c = sm.get(g * kTile + j);
        T dx, dy, dz;
        const T r2 = geo.dist(own, c, dx, dy, dz);
        if (r2 < cutsq && !(self >> j & 1u) && geo.other(own, c)) {
          const T d[3] = {dx, dy, dz};
          const auto f = body.term(own, c, r2);
#pragma unroll
          for (int a = 0; a < B::kAcc; ++a) acc[a] += B::part(d, f, a);
        }
      }
    }
  }
}

// The pack step of a batch (walk below): each tile's kept candidates,
// compacted in walk order; the self pair's packed bit. With Framed, a tile
// of a wrapped mirrored entry (bit s of `framed`) is staged unshifted and
// pruned against the own rows' box moved by -shift; its axes go into
// `frames` (3 bits a tile) and its shifts into sh. With Rows, each kept
// candidate's row beside its record (a reaction policy's landing).
template <bool Framed, bool Rows, typename T, typename G>
__device__ __forceinline__ void pack_batch(
    const G& geo, const typename G::Entry& mine, const Box<T>& box,
    unsigned framed, int t0, int nb, int self_tile, T near_cutsq, T* raw,
    const SmemOf<T, G>& sm, unsigned* self_bit, unsigned* frames,
    T (&sh)[3]) {
  const int lane = threadIdx.x;
  int* bounds = sm.bounds();
  int s = t0 / geo.tiles, k = t0 - s * geo.tiles;
  for (int g = 0; g < nb; ++g) {
    typename G::Entry e = geo.fetch(mine, s);
    bool moved = false;
    T t[3] = {T(0), T(0), T(0)};
    if constexpr (Framed) {
      if (framed >> s & 1u) {  // warp-uniform: staged unshifted
        moved = true;
        t[0] = e.shx, t[1] = e.shy, t[2] = e.shz;
        unsigned bits = 0;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          if (t[a] != T(0)) {
            bits |= 1u << a;
            sh[a] = t[a];
          }
        }
        *frames |= bits << (3 * g);
        e.shx = e.shy = e.shz = T(0);
      }
    }
    Cand<T> c;
    const bool keep =
        geo.pack(e, k, lane, raw + g * G::kPlanes * kTile, &c) &&
        (moved ? near_moved_box(box, t, c, near_cutsq)
               : geo.near(box, c, near_cutsq));
    const unsigned kept = __ballot_sync(0xffffffffu, keep);
    const int pos = __popc(kept & ((1u << lane) - 1u));
    if (keep) sm.put(g * kTile + pos, c);
    if constexpr (Rows) {
      if (keep) sm.rows()[g * kTile + pos] = geo.row(e, k, lane);
    }
    if (t0 + g == self_tile) *self_bit = 1u << pos;
    if (lane == 0) bounds[g] = __popc(kept);
    if (++k == geo.tiles) k = 0, ++s;
  }
}

template <typename T, typename G, typename B, typename R = NoReactions>
__device__ __forceinline__ void walk(const G& geo, const B& body,
                                     const Cand<T>& own, bool live,
                                     int self_tile, T cutsq,
                                     const SmemOf<T, G>& sm,
                                     T (&acc)[B::kAcc],
                                     const R& react = R{}) {
  constexpr int kB = SmemOf<T, G>::kTiles;
  constexpr bool kFrames = HalfFrames<G>::value;
  static_assert(!kFrames || (G::kTwoPass && !R::kOn && 3 * kB <= 32),
                "frames decide in pass 1 and leave pass 2 plain; 3 frame "
                "bits a tile in a word");
  constexpr int kGroup = GroupEntries<G>::value;
  static_assert(kGroup == 0 || (G::kTwoPass && !R::kOn && !kFrames),
                "group sums are kept in a plain pass 2 without reactions");
  const int lane = threadIdx.x;
  const int ntiles = G::kEntries * geo.tiles;
  T* raw = sm.raw();
  const typename G::Entry mine = geo.entry(min(lane, G::kEntries - 1));
  const Box<T> box = own_box(own, live);
  // the wrapped mirrored entries (warp-uniform; bit s: entry s), decided
  // in the Newton-half frame
  unsigned framed = 0;
  if constexpr (kFrames)
    framed = __ballot_sync(0xffffffffu,
                           lane < kMirrored &&
                               (mine.shx != T(0) || mine.shy != T(0) ||
                                mine.shz != T(0)));
  const T near_cutsq = cutsq * (T(1) + T(1.0 / 4096));
  Groups<T, B::kAcc, (kGroup > 0)> groups;
  if constexpr (kGroup > 0)
    groups = {{}, kGroup * geo.tiles, kGroup * geo.tiles};
  issue_batch(geo, mine, 0, min(kB, ntiles), raw);
  for (int t0 = 0; t0 < ntiles; t0 += kB) {
    const int nb = min(kB, ntiles - t0);
    copy_wait_all();
    __syncwarp();  // every lane's copies have landed
    // pack: the batch's kept candidates, compacted in walk order; a batch
    // with a framed tile (kFrames only) runs its own copy of the loop, so
    // the others pay nothing for frames
    unsigned self_bit = 0, frames = 0;
    T sh[3] = {T(0), T(0), T(0)};  // a framed batch's shift per axis
    bool framed_batch = false;
    if constexpr (kFrames) {
      const int s0 = t0 / geo.tiles, s1 = (t0 + nb - 1) / geo.tiles;
      framed_batch = framed >> s0 & ((2u << (s1 - s0)) - 1u);
    }
    if (framed_batch)  // warp-uniform
      pack_batch<kFrames, R::kOn>(geo, mine, box, framed, t0, nb, self_tile,
                                  near_cutsq, raw, sm, &self_bit, &frames,
                                  sh);
    else
      pack_batch<false, R::kOn>(geo, mine, box, framed, t0, nb, self_tile,
                                near_cutsq, raw, sm, &self_bit, &frames, sh);
    __syncwarp();  // records written, raw planes read
    if (t0 + kB < ntiles)  // the next batch's copies fly meanwhile
      issue_batch(geo, mine, t0 + kB, min(kB, ntiles - t0 - kB), raw);
    if constexpr (kFrames) {
      if (frames != 0) {  // warp-uniform
        if (live)
          pass_masks<true>(geo, own, sh, frames, t0, nb, self_tile, self_bit,
                           cutsq, sm);
        __syncwarp();  // the unshifted records read
        restage<T, G>(sh, frames, sm);  // by every lane
        __syncwarp();
        if (live) pass_pairs(geo, body, own, nb, sm, acc, react);
        continue;
      }
    }
    if constexpr (kGroup > 0) {
      if (live) {
        const T none[3] = {T(0), T(0), T(0)};
        pass_masks<false>(geo, own, none, 0u, t0, nb, self_tile, self_bit,
                          cutsq, sm);
        pass_pairs_grouped(geo, body, own, t0, nb, sm, acc, groups);
      }
      continue;
    }
    if (!live) continue;
    batch_passes(geo, body, own, t0, nb, self_tile, self_bit, cutsq, sm, acc,
                 react);
  }
  if (live) groups.finish(acc);
}

// Launch geometry: one warp per cell, kWarpsPerBlock cells a block.
struct Launch {
  dim3 grid, block;
  size_t smem;
};

template <typename T, typename G>
inline Launch launch_shape(int cells) {
  return {dim3((cells + kWarpsPerBlock - 1) / kWarpsPerBlock),
          dim3(kTile, kWarpsPerBlock),
          size_t(kWarpsPerBlock) * SmemOf<T, G>::kBytes};
}

// The launch of a kernel on `ncell` cells as C reports it: out[0] blocks,
// out[1] x out[2] threads per block, out[3] dynamic shared memory bytes.
template <typename G32, typename G64>
inline int report_shape(int ncell, int f64, int* out) {
  const Launch L = f64 ? launch_shape<double, G64>(ncell)
                       : launch_shape<float, G32>(ncell);
  out[0] = static_cast<int>(L.grid.x);
  out[1] = static_cast<int>(L.block.x);
  out[2] = static_cast<int>(L.block.y);
  out[3] = static_cast<int>(L.smem);
  return 0;
}

}  // namespace cell_walk
