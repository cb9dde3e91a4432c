// lj/cut force-only pass over dense cell buckets (list mode "cell"), for
// Hopper (sm_90a).
//
// Replaces the JAX package's K6 together with its glue:
//   K6 cell_force_pallas  lammps_kokkos_port_tpu/ops/pallas_pair.py:100-131
//      (kernel _pair_kernel :66-96, pallas_call :117)
//   glue compute_force    pallas_pair.py:851-930 (gather of own and
//      candidate rows, the kernel, the dropping scatter to atom order)
// The JAX package sends grids of up to 300k rows to K1 instead (TPU VMEM
// tiling, :876); this kernel serves every grid size.
//
// Layout: the state stays in atom order. buckets [ncells+1, cc] hold atom
// rows (cap = empty lane), stencil [ncells, 27] the neighbour cell ids
// (ncells = none, across a non-periodic face), x and f are [cap, 3].
//
// What bounds it on this card: issue slots and latency (the bound of the
// 1M-cell pass is 0.0112 ms of bytes). The first design (2.19 ms at the
// 1M-cell grid in f32 on an H100, about 40 issue slots per warp and
// stencil candidate at 132 SMs x 4 schedulers x 1.75 GHz) gave each cell
// cc rounded up to a warp threads: at cc 36 two warps, the second holding
// lanes 32-35, almost never live (cells hold about 20 atoms) but staging
// and synchronising 27 times; the live warp walked all 27 * cc candidates,
// each with a minimum image (4 rounded operations per axis) and the pair
// body inside the loop.
//
// Design (cell_walk.cuh), measured against the first design and against
// variants of itself in PERF.md section 6: one warp per cell; a cell with
// more than 32 atoms runs its further rows in a second row pass of the
// same warp. The atom indices, then the positions, copied with cp.async a
// batch ahead; only filled lanes within the cutoff of the warp's own rows'
// bounding box under the minimum image are staged (see `near`), as packed
// records (x, y, z and the atom index in the fourth word: one 16-byte
// shared load in f32); one pass, the body inside the candidate loop: the
// second pass would recompute the minimum image of every in-cutoff pair,
// which cost more here than the divergent body saves. A warp per 32
// bucket lanes (the first design's shape) and three warps sharing one
// cell's walk were both slower. At the 1M-cell deck grid it takes about
// 1.28 ms on an H100, about 24 issue slots per warp and stencil candidate
// on the same reckoning. An empty lane is staged with NaN coordinates,
// so its r2 is NaN and fails the cutoff wherever it is walked; the self
// pair is the candidate with the own atom's index, as K6
// masks it; a dead stencil cell has no live candidate. No packing of the
// buckets is assumed. Each atom sits in exactly one bucket, so its lane
// writes f[atom] once: no atomics, deterministic; atoms in no bucket keep
// the wrapper's zeros, as the JAX scatter's mode="drop" leaves them.
//
// The minimum image d - prd*rint(d*(1/prd)) and r2 are formed with
// explicitly rounded multiplies and adds (no fused multiply-add), rint
// rounds half to even as jnp.round / torch.round do, and 1/prd and 1/r2
// are IEEE divides: the cutoff decisions are bit-identical to the plain
// PyTorch version's; only the order of the force sums differs.

#include <cmath>

#include "cell_walk.cuh"

namespace {

using cell_stencil::Rn;
using cell_walk::Cand;

template <typename T> __device__ __forceinline__ T round_even(T v);
template <> __device__ __forceinline__ float round_even(float v) {
  return rintf(v);
}
template <> __device__ __forceinline__ double round_even(double v) {
  return rint(v);
}

// d - p * rint(d * ip), each operation rounded on its own
template <typename T>
__device__ __forceinline__ T min_image(T d, T p, T ip) {
  return Rn<T>::add(d, -Rn<T>::mul(p, round_even(Rn<T>::mul(d, ip))));
}

template <typename T> struct DenseCells {
  const int* buckets;
  const int* stencil;
  const T* x;
  int ntot, cc, tiles, cap, cell;
  T px, py, pz, ix, iy, iz;

  // a stencil entry: the neighbour cell (ntot: none)
  struct Entry {
    int nc;
  };
  static constexpr int kEntries = 27;
  static constexpr int kBatch = cell_walk::kBatch;
  static constexpr bool kRows = false;
  // the atom indices land before the positions are copied by them
  static constexpr int kPlanes = 4;
  static constexpr bool kTwoPass = false;
  static constexpr bool kIndexFirst = true;

  __device__ Entry entry(int s) const { return {stencil[cell * 27 + s]}; }

  __device__ Entry fetch(const Entry& m, int s) const {
    return {__shfl_sync(0xffffffffu, m.nc, s)};
  }

  // the atom index sits in the fourth raw plane (its first four bytes)
  static __device__ int* index_slot(T* raw, int lane) {
    return reinterpret_cast<int*>(raw + 3 * cell_walk::kTile + lane);
  }

  __device__ void issue_a(const Entry& e, int k, int lane, T* raw) const {
    const int j = k * cell_walk::kTile + lane;
    if (e.nc < ntot && j < cc)
      cell_walk::copy_async(index_slot(raw, lane), buckets + e.nc * cc + j);
    else
      *index_slot(raw, lane) = cap;
  }

  __device__ void issue_b(const Entry&, int, int lane, T* raw) const {
    const int idx = *index_slot(raw, lane);
    if (idx >= cap) return;
    cell_walk::copy_async(raw + lane, x + 3 * idx);
    cell_walk::copy_async(raw + cell_walk::kTile + lane, x + 3 * idx + 1);
    cell_walk::copy_async(raw + 2 * cell_walk::kTile + lane, x + 3 * idx + 2);
  }

  // an empty lane becomes NaN coordinates: its r2 is NaN and fails the
  // cutoff wherever it is walked
  __device__ bool pack(const Entry&, int, int lane, const T* raw,
                       Cand<T>* c) const {
    const int idx = *index_slot(const_cast<T*>(raw), lane);
    if (idx >= cap) {
      const T nan = T(NAN);
      *c = {nan, nan, nan, cell_walk::int_bits(cap, T(0))};
      return false;
    }
    *c = {raw[lane], raw[cell_walk::kTile + lane],
          raw[2 * cell_walk::kTile + lane], cell_walk::int_bits(idx, T(0))};
    return true;
  }

  // Whether candidate c may lie within the cutoff of an own row, under the
  // minimum image: per axis the gap g between the box [lo, hi] of the own
  // rows and the nearest of three images of c (the one nearest the box's
  // centre and one box length either side), less E = 32 u p, squared and
  // summed into S; c is dropped when S > cutsq (1 + 2^-12). Exact: with
  // hi - lo < p / 2 the image of c nearest any own row o is one of the
  // three, so |o - c - j p| >= g for every image j; with every coordinate
  // within 2 p of the origin the kernel's rounded minimum image of o - c
  // differs from its exact value by at most 9 u p (|rint| <= 4) and the
  // gap computed here from the exact one by at most 11 u p, so each
  // |dx| >= max(g - E, 0) and the rounded r2 >= S (1 - u)^3 / (1 + u)^5 >
  // cutsq. An axis where either condition fails is not used (its gap
  // counts as 0).
  __device__ bool near(const cell_walk::Box<T>& b, const Cand<T>& c,
                       T near_cutsq) const {
    const T cs[3] = {c.x, c.y, c.z}, ps[3] = {px, py, pz},
            is[3] = {ix, iy, iz};
    T s = T(0);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const T lo = b.lo[a], hi = b.hi[a], p = ps[a];
      T h = T(0);
      if (T(2) * (hi - lo) < p &&
          max(max(fabs(lo), fabs(hi)), fabs(cs[a])) <= T(2) * p) {
        const T q = cs[a] - p * round_even((cs[a] - (lo + hi) * T(0.5)) *
                                           is[a]);
        const T g = min(gap(lo, hi, q), min(gap(lo, hi, q + p),
                                            gap(lo, hi, q - p)));
        h = max(g - T(32) * cell_walk::Unit<T>::kRoundoff * p, T(0));
      }
      s = Rn<T>::add(s, Rn<T>::mul(h, h));
    }
    return s <= near_cutsq;
  }

  static __device__ T gap(T lo, T hi, T q) {
    return max(max(lo - q, q - hi), T(0));
  }

  __device__ T dist(const Cand<T>& o, const Cand<T>& c, T& dx, T& dy,
                    T& dz) const {
    dx = min_image(o.x - c.x, px, ix);
    dy = min_image(o.y - c.y, py, iy);
    dz = min_image(o.z - c.z, pz, iz);
    return Rn<T>::add(Rn<T>::add(Rn<T>::mul(dx, dx), Rn<T>::mul(dy, dy)),
                      Rn<T>::mul(dz, dz));
  }

  // the self pair by atom index, in whichever stencil entry it appears
  __device__ bool other(const Cand<T>& o, const Cand<T>& c) const {
    return cell_walk::bits_int(c.w) != cell_walk::bits_int(o.w);
  }
};

template <typename T>
__global__ void CELL_WALK_BOUNDS lj_cell_dense_kernel(
    const int* __restrict__ buckets, const int* __restrict__ stencil,
    const T* __restrict__ x, const T* __restrict__ prd, T* __restrict__ f,
    int ntot, int cc, int cap, T lj1, T lj2, T cutsq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Geo = DenseCells<T>;
  const int cell = blockIdx.x * cell_walk::kWarpsPerBlock + threadIdx.y;
  if (cell >= ntot) return;  // the whole warp
  const auto sm = cell_walk::warp_smem<T, Geo>(smem_raw);

  const int tiles = (cc + cell_walk::kTile - 1) / cell_walk::kTile;
  const T px = prd[0], py = prd[1], pz = prd[2];
  const Geo geo{buckets, stencil, x, ntot, cc, tiles, cap, cell,
                px, py, pz, T(1) / px, T(1) / py, T(1) / pz};
  const int lane = threadIdx.x;

  for (int rp = 0; rp < tiles; ++rp) {
    const int j = rp * cell_walk::kTile + lane;
    const int me = j < cc ? buckets[cell * cc + j] : cap;
    const bool live = me < cap;
    Cand<T> own = {T(0), T(0), T(0), cell_walk::int_bits(me, T(0))};
    if (live) {
      own.x = x[3 * me];
      own.y = x[3 * me + 1];
      own.z = x[3 * me + 2];
    }
    T acc[3] = {T(0), T(0), T(0)};
    if (__any_sync(0xffffffffu, live))
      cell_walk::walk(geo, cell_walk::LjBody<T>{lj1, lj2}, own, live, -1,
                      cutsq, sm, acc);
    if (live) {
      f[3 * me] = acc[0];
      f[3 * me + 1] = acc[1];
      f[3 * me + 2] = acc[2];
    }
  }
}

template <typename T>
int launch(const void* buckets, const void* stencil, const void* x,
           const void* prd, void* f, int ntot, int cc, int cap, double lj1,
           double lj2, double cutsq, void* stream) {
  const cell_walk::Launch L =
      cell_walk::launch_shape<T, DenseCells<T>>(ntot);
  lj_cell_dense_kernel<T><<<L.grid, L.block, L.smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(buckets), static_cast<const int*>(stencil),
      static_cast<const T*>(x), static_cast<const T*>(prd),
      static_cast<T*>(f), ntot, cc, cap, static_cast<T>(lj1),
      static_cast<T>(lj2), static_cast<T>(cutsq));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Launch on `stream`, do not
// synchronise; return cudaGetLastError() after the launch (0 = success).
// f must hold zeros on entry: only bucketed atoms are written.
extern "C" int lj_cell_dense_f32(const void* buckets, const void* stencil,
                                 const void* x, const void* prd, void* f,
                                 int ntot, int cc, int cap, double lj1,
                                 double lj2, double cutsq, void* stream) {
  return launch<float>(buckets, stencil, x, prd, f, ntot, cc, cap, lj1, lj2,
                       cutsq, stream);
}

extern "C" int lj_cell_dense_f64(const void* buckets, const void* stencil,
                                 const void* x, const void* prd, void* f,
                                 int ntot, int cc, int cap, double lj1,
                                 double lj2, double cutsq, void* stream) {
  return launch<double>(buckets, stencil, x, prd, f, ntot, cc, cap, lj1, lj2,
                        cutsq, stream);
}

// The launch the kernel makes on `ncell` cells: out[0] blocks, out[1] x
// out[2] threads per block, out[3] dynamic shared memory bytes.
extern "C" int lj_cell_dense_shape(int ncell, int f64, int* out) {
  return cell_walk::report_shape<DenseCells<float>, DenseCells<double>>(
      ncell, f64, out);
}
