// The candidate walk of the port's sorted and dense cell kernels (sm_90a):
// lj_cell_force.cu and eam_cell.cu (the sorted layout, sorted_grid.cuh) and
// lj_cell_dense.cu (list mode "cell"). The other cell kernels keep
// cell_stencil.cuh's `sweep`.
//
// Unit of work: one warp owns up to 32 rows of one cell (a row pass) and
// walks that cell's 27 neighbour blocks on its own, with no block-wide
// barrier; a cell with more rows runs its further row passes in the same
// warp. A neighbour block's candidates are cut into tiles of 32 (tiles =
// cc / 32 rounded up), so a walk is 27 * tiles tiles in stencil order. The
// warp stages kBatch tiles at a time: their positions are copied
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
// pass 1, so the body sees the bits the cutoff test saw. Candidates are
// staged as three planes (x, y, z) or, where they carry a fourth word (the
// atom index, or EAM's fp), as packed (x, y, z, w) records: one 16-byte
// shared load in f32.
//
// The pair body `B` is a template parameter (LjBody below; eam_cell.cu's
// two bodies):
//   static constexpr int kAcc;     accumulators per row (3: a force; 1)
//   static constexpr int kPairs;   pairs an iteration of pass 2 (1 or 2)
//   T term(const Cand<T>& own, const Cand<T>& c, T r2);  the pair's term
//   static T part(const T (&d)[3], T term, int a);  its share of acc[a]
//       (d = own - c)

#pragma once

#include <cuda_runtime.h>

#include "cell_stencil.cuh"

namespace cell_walk {

using cell_stencil::Rn;

constexpr int kBatch = 9;        // tiles per batch in f32: one x-plane of
                                 // the stencil at cc <= 32
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
// per (tile, lane) and the tiles' candidate counts. A batch is kBatch
// tiles in f32, a third of that in f64 (the same bytes). With P = 3 the
// candidates are three planes x, y, z (one 4- or 8-byte shared load per
// component); with P = 4 packed (x, y, z, w) records (one 16-byte load in
// f32, two in f64).
template <typename T, int P> struct WarpSmem {
  static constexpr bool kPacked = P == 4;
  static constexpr int kTiles =
      sizeof(T) == 4 ? kBatch : (kBatch + 2) / 3;
  static constexpr int kSlots = kTiles * kTile;
  static constexpr size_t kStage = size_t(P) * kSlots * sizeof(T);
  static constexpr size_t kRaw = kStage;
  static constexpr size_t kMasks = size_t(kSlots) * 4;
  static constexpr size_t kBounds = ((kTiles * 4 + 15) / 16) * 16;
  static constexpr size_t kBytes = kStage + kRaw + kMasks + kBounds;
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
using SmemOf = WarpSmem<T, G::kPlanes>;

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
// `self_tile`: the tile whose candidate at this lane is the row itself
// (masked by its packed position), or -1 where `other` tells the self
// pair. Every lane of the warp calls it; lanes whose row is not `live`
// stage but add nothing.
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

template <typename T, typename G, typename B>
__device__ __forceinline__ void walk(const G& geo, const B& body,
                                     const Cand<T>& own, bool live,
                                     int self_tile, T cutsq,
                                     const SmemOf<T, G>& sm,
                                     T (&acc)[B::kAcc]) {
  constexpr int kB = SmemOf<T, G>::kTiles;
  const int lane = threadIdx.x;
  const int ntiles = 27 * geo.tiles;
  T* raw = sm.raw();
  int* bounds = sm.bounds();
  const typename G::Entry mine = geo.entry(min(lane, 26));
  const Box<T> box = own_box(own, live);
  const T near_cutsq = cutsq * (T(1) + T(1.0 / 4096));
  issue_batch(geo, mine, 0, min(kB, ntiles), raw);
  for (int t0 = 0; t0 < ntiles; t0 += kB) {
    const int nb = min(kB, ntiles - t0);
    copy_wait_all();
    __syncwarp();  // every lane's copies have landed
    // pack: the batch's kept candidates, compacted in walk order
    unsigned self_bit = 0;
    int s = t0 / geo.tiles, k = t0 - s * geo.tiles;
    for (int g = 0; g < nb; ++g) {
      Cand<T> c;
      const bool keep =
          geo.pack(geo.fetch(mine, s), k, lane, raw + g * G::kPlanes * kTile,
                   &c) &&
          geo.near(box, c, near_cutsq);
      const unsigned kept = __ballot_sync(0xffffffffu, keep);
      const int pos = __popc(kept & ((1u << lane) - 1u));
      if (keep) sm.put(g * kTile + pos, c);
      if (t0 + g == self_tile) self_bit = 1u << pos;
      if (lane == 0) bounds[g] = __popc(kept);
      if (++k == geo.tiles) k = 0, ++s;
    }
    __syncwarp();  // records written, raw planes read
    if (t0 + kB < ntiles)  // the next batch's copies fly meanwhile
      issue_batch(geo, mine, t0 + kB, min(kB, ntiles - t0 - kB), raw);
    if (!live) continue;
    if constexpr (G::kTwoPass) {
      // pass 1: the in-cutoff candidates of each tile, as a mask per lane
      unsigned* masks = sm.masks();
      for (int g = 0; g < nb; ++g) {
        const int base = g * kTile;
        const int n = bounds[g];
        unsigned m = 0;
#pragma unroll 4
        for (int j = 0; j < n; ++j) {
          const Cand<T> c = sm.get(base + j);
          T dx, dy, dz;
          const T r2 = geo.dist(own, c, dx, dy, dz);
          if (r2 < cutsq && geo.other(own, c)) m |= 1u << j;
        }
        if (t0 + g == self_tile) m &= ~self_bit;
        masks[base + lane] = m;
      }
      // pass 2: the body over this lane's own list, in walk order
      int g = 0;
      unsigned m = masks[lane];
      if constexpr (B::kPairs == 1) {
        for (;;) {
          while (m == 0 && ++g < nb) m = masks[g * kTile + lane];
          if (m == 0) break;
          const Cand<T> c = sm.get(g * kTile + __ffs(m) - 1);
          m &= m - 1;
          T d[3];
          const T r = geo.dist(own, c, d[0], d[1], d[2]);
          const T f = body.term(own, c, r);
#pragma unroll
          for (int a = 0; a < B::kAcc; ++a) acc[a] += B::part(d, f, a);
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
          const T f1 = body.term(own, c1, r1), f2 = body.term(own, c2, r2);
#pragma unroll
          for (int a = 0; a < B::kAcc; ++a) {
            acc[a] += B::part(d1, f1, a);
            if (two) acc[a] += B::part(d2, f2, a);
          }
        }
      }
    } else {
      // one pass: the body inside the candidate loop, taken by the warp
      // wherever any lane is inside the cutoff
      for (int g = 0; g < nb; ++g) {
        const int n = bounds[g];
        const unsigned self = (t0 + g == self_tile) ? self_bit : 0u;
        for (int j = 0; j < n; ++j) {
          const Cand<T> c = sm.get(g * kTile + j);
          T dx, dy, dz;
          const T r2 = geo.dist(own, c, dx, dy, dz);
          if (r2 < cutsq && !(self >> j & 1u) && geo.other(own, c)) {
            const T d[3] = {dx, dy, dz};
            const T f = body.term(own, c, r2);
#pragma unroll
            for (int a = 0; a < B::kAcc; ++a) acc[a] += B::part(d, f, a);
          }
        }
      }
    }
  }
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
