// SNAP (one element) and ZBL on the sorted cell-major layout, for Hopper
// (sm_90a): the three passes of the SNAP force (ui, yi, deidrj), their
// tally instances for thermo rows, and the ZBL pair pass, all over the
// short lists of tersoff_cell.cu's tersoff_short_kernel.
//
// Replaces no Pallas kernel: the JAX package takes SNAP's forces as
// jax.grad of its energy (lammps_kokkos_port_tpu/models/pair_snap.py) and
// ZBL's as a pair term of its neighbour-matrix engine, both compiled by
// XLA. These follow LAMMPS's SNAP (src/ML-SNAP/sna.cpp: compute_uarray,
// compute_duarray, compute_deidrj) and Kokkos's split of it into a U pass,
// a Y pass and a fused dE/dr pass (src/KOKKOS/pair_snap_kokkos_impl.h).
//
// Every kernel launches over blocks of kRowsPerBlock rows of the layout and
// first collects the block's valid rows (mask != 0) in order: the layout's
// pad rows (42% of the 128,000-atom deck's rows at cell_cap 24) cost one
// read of the mask. U, Y (the [rows, nhalf, 2] planes) hold the half of each U_j: the
// rows mb <= j/2, every ma, in (j, mb, ma) order (nhalf = 155 at twojmax
// 8); the rest follows from U[j-mb][j-ma] = (-1)^(ma+mb) conj(U[mb][ma]).
//
// snap_ui_kernel: a warp per valid row. For each pair of its list within
//   rcut, the warp runs the recursion level by level (VMK 4.8.2, the rows
//   mb <= j/2 of U_j from U_{j-1}, its lanes over the level's entries; the
//   row j/2 of U_{j-1} is read through the symmetry; the middle row's
//   right part and middle entry as LAMMPS's copy makes them) and adds
//   sfac(r) wj U_j into the row's U, which each lane keeps for its entries
//   in shared memory. No atomics. Bound: operations, about 12 a half entry
//   a pair (a complex product and add for each of the two terms).
//
// snap_yi_kernel: Y = dE/dU on the half, by the style's Y table (the
//   partial derivatives of the trilinear bispectrum, beta and the fold to
//   the half in its coefficients; models/pair_snap.y_table): entry e adds
//   coef_e op(U_a) op(U_b) to Y[out_e]. A block takes its valid rows four
//   at a time: their full U (285 entries each at twojmax 8) in shared
//   memory, its 128 threads over contiguous chunks of the table (sorted by
//   output, about 40,000 entries), each entry read once for the four rows;
//   a thread's partial sums go to Y in shared memory by one atomic add at
//   each change of output. Bound: operations (a complex product and a
//   complex multiply-add an entry, 14 a row and entry).
//
// snap_deidrj_kernel: a warp per valid row, its Y (the half) in shared
//   memory. For each pair of its list within rcut, the recursion of U and
//   of dU/dr (three components, compute_duarray), then dE/dr = sum over
//   the half of Re[conj(Y) (dsfac u r_hat + sfac du)] with the lanes over
//   the entries and a warp sum; f_i += dE/dr, f_j -= dE/dr by float64 (or
//   float32) atomics in the zeroed output. Bound: operations, about 100 a
//   half entry a pair.
//
// The tally instances (snap_yi_tally_kernel, snap_deidrj_tally_kernel)
// also write, for thermo rows, each row's energy E_0 + 1/3 sum Re[conj(Y)
// U] (every term of the bispectrum is trilinear in U: Euler's theorem)
// and each row's pairs' virial -d (x) dE/dr (LAMMPS's ev_tally_xyz with
// delx = x_i - x_j). zbl_pair_kernel / zbl_pair_tally_kernel: a thread per
// valid row over its list (LAMMPS's pair_zbl.cpp compute: every ordered
// pair within the outer cutoff onto its own row; the tally halves each
// ordered pair's energy and virial). Bound: operations.
//
// Displacements are minimum images (the box spans at least 3 cells of the
// cutoff and skin). The kernels read the state's [rows, 3] positions and
// its mask as they are.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kJMax = 8;                             // largest twojmax
constexpr int kHalfMax = 155;                        // nhalf at kJMax
constexpr int kFullMax = 285;                        // sum (j+1)^2
constexpr int kLevelMax = (kJMax / 2 + 1) * (kJMax + 1);  // 45
constexpr int kRowsPerBlock = 128;
constexpr int kThreads = 128;                        // every kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;                            // yi: rows at once

template <typename T> struct Cx {
  T re, im;
};

template <typename T>
__device__ __forceinline__ Cx<T> cmul(Cx<T> a, Cx<T> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

// conj(a) b
template <typename T>
__device__ __forceinline__ Cx<T> cjmul(Cx<T> a, Cx<T> b) {
  return {a.re * b.re + a.im * b.im, a.re * b.im - a.im * b.re};
}

// The style's numbers in T (models/pair_snap.PairSNAP.kernel_params), and
// sqrt(p / q) for the recursion (SNA::init_rootpqarray).
template <typename T> struct Snap {
  int twojmax, switchflag;
  T cutsq, rcut, rfac0, rmin0, wj, wself, eshift;
  T rootpq[kJMax + 1][kJMax + 1];
};

// entries of the half of U_j, and where U_j's half starts
__device__ __forceinline__ int level_size(int j) {
  return (j / 2 + 1) * (j + 1);
}

// (j, mb, ma) of a half index
__device__ __forceinline__ void half_jm(int h, int* j, int* mb, int* ma) {
  int jj = 0;
  while (h >= level_size(jj)) h -= level_size(jj++);
  *j = jj;
  *mb = h / (jj + 1);
  *ma = h % (jj + 1);
}

// x[b] - x[a] as the minimum image
template <typename T>
__device__ __forceinline__ void disp(const T* __restrict__ x, int a, int b,
                                     const T (&prd)[3], const T (&inv)[3],
                                     T (&d)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T v = x[3 * b + c] - x[3 * a + c];
    d[c] = v - prd[c] * rint(v * inv[c]);
  }
}

// The valid rows of [row0, row0 + kRowsPerBlock), in order, into `list`;
// returns their count. Every thread of the block calls it.
__device__ int collect_valid(const int* __restrict__ mask, int rows,
                             int row0, int* list) {
  __shared__ unsigned bits[kRowsPerBlock / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < kRowsPerBlock / 32; c += kWarps) {
    const int r = row0 + 32 * c + lane;
    const unsigned b = __ballot_sync(kFull, r < rows && mask[r] != 0);
    if (lane == 0) bits[c] = b;
  }
  __syncthreads();
  int total = 0;
  for (int c = 0; c < kRowsPerBlock / 32; ++c) {
    if (c == warp && (bits[c] >> lane & 1u))
      list[total + __popc(bits[c] & ((1u << lane) - 1u))] =
          row0 + 32 * c + lane;
    total += __popc(bits[c]);
  }
  __syncthreads();
  return total;
}

// The pair geometry of compute_ui / compute_duidrj: the Cayley-Klein a, b
// of d = x_j - x_i, the switch sfac wj and its derivative dsfac wj, and
// (with da != nullptr) da/dr, db/dr and r_hat.
template <typename T> struct Geom {
  Cx<T> a, b;
  T sfac, dsfac;
  Cx<T> da[3], db[3];
  T uhat[3];
};

template <typename T>
__device__ __forceinline__ void geometry(const T (&d)[3], T rsq,
                                         const Snap<T>& p, bool derivs,
                                         Geom<T>* g) {
  const T r = sqrt(rsq);
  const T rscale0 = p.rfac0 * T(3.14159265358979323846) / (p.rcut - p.rmin0);
  const T theta0 = (r - p.rmin0) * rscale0;
  T sn, cs;
  if constexpr (sizeof(T) == 4)
    sincosf(theta0, &sn, &cs);
  else
    sincos(theta0, &sn, &cs);
  const T z0 = r * cs / sn;
  const T r0inv = T(1) / sqrt(rsq + z0 * z0);
  g->a = {r0inv * z0, -r0inv * d[2]};
  g->b = {r0inv * d[1], -r0inv * d[0]};
  T sfac = T(1), dsfac = T(0);
  if (p.switchflag && r > p.rmin0) {
    const T rcutfac = T(3.14159265358979323846) / (p.rcut - p.rmin0);
    T s2, c2;
    if constexpr (sizeof(T) == 4)
      sincosf((r - p.rmin0) * rcutfac, &s2, &c2);
    else
      sincos((r - p.rmin0) * rcutfac, &s2, &c2);
    sfac = T(0.5) * (c2 + T(1));
    dsfac = T(-0.5) * s2 * rcutfac;
  }
  g->sfac = sfac * p.wj;
  g->dsfac = dsfac * p.wj;
  if (!derivs) return;
  const T rinv = T(1) / r;
  const T dz0dr = z0 * rinv - (r * rscale0) * (rsq + z0 * z0) / rsq;
  const T dr0invdr = -r0inv * r0inv * r0inv * (r + z0 * dz0dr);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T u = d[k] * rinv;
    const T dr0inv = dr0invdr * u;
    const T dz0 = dz0dr * u;
    g->uhat[k] = u;
    g->da[k] = {dz0 * r0inv + z0 * dr0inv, -d[2] * dr0inv};
    g->db[k] = {d[1] * dr0inv, -d[0] * dr0inv};
  }
  g->da[2].im += -r0inv;
  g->db[0].im += -r0inv;
  g->db[1].re += r0inv;
}

// U_jp[mb][ma] from the half of level jp kept in `lev` (row mb > jp/2
// through the symmetry)
template <typename T>
__device__ __forceinline__ Cx<T> level_at(const Cx<T>* lev, int jp, int mb,
                                          int ma) {
  if (2 * mb <= jp) return lev[mb * (jp + 1) + ma];
  const Cx<T> v = lev[(jp - mb) * (jp + 1) + (jp - ma)];
  return ((ma + mb) & 1) ? Cx<T>{-v.re, v.im} : Cx<T>{v.re, -v.im};
}

// One level's recursion step for the entry e of the half of U_j (and with
// Derivs its three dU/dr components): cur[e] from the level j-1 in prev.
template <typename T, bool Derivs>
__device__ __forceinline__ void recur(const Snap<T>& p, const Geom<T>& g,
                                      int j, int e, const Cx<T>* prev,
                                      const Cx<T>* dprev, Cx<T>* cur,
                                      Cx<T>* dcur) {
  const int mb = e / (j + 1), ma = e % (j + 1);
  Cx<T> u = {T(0), T(0)};
  Cx<T> du[3] = {};
  if (ma < j) {
    const T c1 = p.rootpq[j - ma][j - mb];
    const Cx<T> up = level_at(prev, j - 1, mb, ma);
    const Cx<T> t = cjmul(g.a, up);
    u.re += c1 * t.re;
    u.im += c1 * t.im;
    if constexpr (Derivs) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const Cx<T> dup = level_at(dprev + k * kLevelMax, j - 1, mb, ma);
        const Cx<T> s1 = cjmul(g.da[k], up), s2 = cjmul(g.a, dup);
        du[k].re += c1 * (s1.re + s2.re);
        du[k].im += c1 * (s1.im + s2.im);
      }
    }
  }
  if (ma > 0) {
    const T c2 = p.rootpq[ma][j - mb];
    const Cx<T> up = level_at(prev, j - 1, mb, ma - 1);
    const Cx<T> t = cjmul(g.b, up);
    u.re -= c2 * t.re;
    u.im -= c2 * t.im;
    if constexpr (Derivs) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const Cx<T> dup = level_at(dprev + k * kLevelMax, j - 1, mb, ma - 1);
        const Cx<T> s1 = cjmul(g.db[k], up), s2 = cjmul(g.b, dup);
        du[k].re -= c2 * (s1.re + s2.re);
        du[k].im -= c2 * (s1.im + s2.im);
      }
    }
  }
  cur[e] = u;
  if constexpr (Derivs) {
#pragma unroll
    for (int k = 0; k < 3; ++k) dcur[k * kLevelMax + e] = du[k];
  }
}

// LAMMPS's copy on the middle row (mb = j/2, j even) of a level: its
// right part the mirror of its left, its middle entry conjugated. `buf`
// holds `n` planes of kLevelMax entries.
template <typename T>
__device__ __forceinline__ void middle_fix(Cx<T>* buf, int n, int j,
                                           int lane) {
  const int mb = j / 2;
  for (int t = lane; t < n * (mb + 1); t += 32) {
    const int k = t / (mb + 1), ma = mb + t % (mb + 1);
    Cx<T>* row = buf + k * kLevelMax + mb * (j + 1);
    const Cx<T> v = row[j - ma];
    row[ma] = ((ma + mb) & 1) ? Cx<T>{-v.re, v.im} : Cx<T>{v.re, -v.im};
  }
}

template <typename T> struct UiShared {
  Cx<T> lev[2][kLevelMax];
  Cx<T> acc[kHalfMax];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    snap_ui_kernel(const T* __restrict__ x, const int* __restrict__ mask,
                   const T* __restrict__ prd_in,
                   const int* __restrict__ shortl,
                   const int* __restrict__ nshort, T* __restrict__ ulist,
                   int rows, int S, const __grid_constant__ Snap<T> p) {
  __shared__ int list[kRowsPerBlock];
  __shared__ UiShared<T> sh[kWarps];
  const int n = collect_valid(mask, rows, blockIdx.x * kRowsPerBlock, list);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  UiShared<T>& s = sh[warp];
  const T prd[3] = {prd_in[0], prd_in[1], prd_in[2]};
  const T inv[3] = {T(1) / prd[0], T(1) / prd[1], T(1) / prd[2]};
  int nh = 0;
  for (int j = 0; j <= p.twojmax; ++j) nh += level_size(j);

  for (int q = warp; q < n; q += kWarps) {
    const int i = list[q];
    for (int h = lane; h < nh; h += 32) {  // the self term
      int j, mb, ma;
      half_jm(h, &j, &mb, &ma);
      s.acc[h] = {ma == mb ? p.wself : T(0), T(0)};
    }
    const int ni = nshort[i];
    for (int jj = 0; jj < ni; ++jj) {
      T d[3];
      disp(x, i, shortl[static_cast<size_t>(i) * S + jj], prd, inv, d);
      const T rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
      if (rsq >= p.cutsq || rsq <= T(1e-20)) continue;  // warp-uniform
      Geom<T> g;
      geometry(d, rsq, p, false, &g);
      __syncwarp();
      if (lane == 0) {
        s.lev[0][0] = {T(1), T(0)};
        s.acc[0].re += g.sfac;
      }
      int off = 1;
      for (int j = 1; j <= p.twojmax; ++j) {
        __syncwarp();
        const int nj = level_size(j);
        const Cx<T>* prev = s.lev[(j - 1) & 1];
        Cx<T>* cur = s.lev[j & 1];
        for (int e = lane; e < nj; e += 32)
          recur<T, false>(p, g, j, e, prev, nullptr, cur, nullptr);
        __syncwarp();
        if ((j & 1) == 0) {
          middle_fix(cur, 1, j, lane);
          __syncwarp();
        }
        for (int e = lane; e < nj; e += 32) {
          s.acc[off + e].re += g.sfac * cur[e].re;
          s.acc[off + e].im += g.sfac * cur[e].im;
        }
        off += nj;
      }
    }
    __syncwarp();
    Cx<T>* out = reinterpret_cast<Cx<T>*>(ulist) + static_cast<size_t>(i) * nh;
    for (int h = lane; h < nh; h += 32) out[h] = s.acc[h];
    __syncwarp();
  }
}

// the full index of (j, mb, ma)
__device__ __forceinline__ int full_index(int j, int mb, int ma) {
  return j * (j + 1) * (2 * j + 1) / 6 + mb * (j + 1) + ma;
}

template <typename T> struct YiShared {
  Cx<T> u[kGroup][kFullMax];
  Cx<T> y[kGroup][kHalfMax];
};

template <typename T, bool Tally>
__device__ __forceinline__ void yi_body(
    const int* __restrict__ mask, const T* __restrict__ ulist_in,
    const int* __restrict__ entries, const T* __restrict__ coef,
    T* __restrict__ ylist_out, T* __restrict__ energy, int rows, int E,
    const Snap<T>& p) {
  __shared__ int list[kRowsPerBlock];
  __shared__ YiShared<T> sh;
  const int n = collect_valid(mask, rows, blockIdx.x * kRowsPerBlock, list);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Cx<T>* ulist = reinterpret_cast<const Cx<T>*>(ulist_in);
  Cx<T>* ylist = reinterpret_cast<Cx<T>*>(ylist_out);
  int nh = 0;
  for (int j = 0; j <= p.twojmax; ++j) nh += level_size(j);
  const int nfull = full_index(p.twojmax + 1, 0, 0);
  const int per = (E + kThreads - 1) / kThreads;
  const int e0 = min(E, tid * per), e1 = min(E, e0 + per);

  for (int g0 = 0; g0 < n; g0 += kGroup) {
    const int na = min(kGroup, n - g0);
    // the group's full U from the half, and Y zeroed
    for (int t = tid; t < na * nfull; t += kThreads) {
      const int q = t / nfull;
      int u = t % nfull, j = 0;
      while (u >= (j + 1) * (j + 1)) u -= (j + 1) * (j + 1), ++j;
      int mb = u / (j + 1), ma = u % (j + 1);
      const bool mirrored = 2 * mb > j;
      if (mirrored) mb = j - mb, ma = j - ma;
      int h = mb * (j + 1) + ma;
      for (int k = 0; k < j; ++k) h += level_size(k);
      Cx<T> v = ulist[static_cast<size_t>(list[g0 + q]) * nh + h];
      if (mirrored)
        v = ((ma + mb) & 1) ? Cx<T>{-v.re, v.im} : Cx<T>{v.re, -v.im};
      sh.u[q][t % nfull] = v;
    }
    for (int t = tid; t < kGroup * kHalfMax; t += kThreads)
      sh.y[t / kHalfMax][t % kHalfMax] = {T(0), T(0)};
    __syncthreads();

    // the table: this thread's chunk, partial sums flushed at each change
    // of output
    Cx<T> acc[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) acc[q] = {T(0), T(0)};
    int cur = e0 < e1 ? (entries[e0] >> 20) : 0;
    for (int e = e0; e < e1; ++e) {
      const int w = entries[e];
      const int out = w >> 20;
      if (out != cur) {
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          if (q < na) {
            atomicAdd(&sh.y[q][cur].re, acc[q].re);
            atomicAdd(&sh.y[q][cur].im, acc[q].im);
          }
          acc[q] = {T(0), T(0)};
        }
        cur = out;
      }
      const int a = w & 511, b = (w >> 9) & 511;
      const bool ca = (w >> 18) & 1, cb = (w >> 19) & 1;
      const T c = coef[e];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        if (q < na) {
          Cx<T> ua = sh.u[q][a], ub = sh.u[q][b];
          if (ca) ua.im = -ua.im;
          if (cb) ub.im = -ub.im;
          const Cx<T> t = cmul(ua, ub);
          acc[q].re += c * t.re;
          acc[q].im += c * t.im;
        }
      }
    }
    if (e0 < e1) {
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        if (q < na) {
          atomicAdd(&sh.y[q][cur].re, acc[q].re);
          atomicAdd(&sh.y[q][cur].im, acc[q].im);
        }
      }
    }
    __syncthreads();

    for (int t = tid; t < na * nh; t += kThreads) {
      const int q = t / nh, h = t % nh;
      ylist[static_cast<size_t>(list[g0 + q]) * nh + h] = sh.y[q][h];
    }
    if constexpr (Tally) {  // a warp a row: E_0 + 1/3 sum Re[conj(Y) U]
      if (warp < na) {
        T sum = T(0);
        for (int h = lane; h < nh; h += 32) {
          int j, mb, ma;
          half_jm(h, &j, &mb, &ma);
          const Cx<T> u = sh.u[warp][full_index(j, mb, ma)];
          const Cx<T> y = sh.y[warp][h];
          sum += y.re * u.re + y.im * u.im;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
        if (lane == 0) energy[list[g0 + warp]] = p.eshift + sum / T(3);
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    snap_yi_kernel(const int* __restrict__ mask, const T* __restrict__ ulist,
                   const int* __restrict__ entries,
                   const T* __restrict__ coef, T* __restrict__ ylist,
                   int rows, int E, const __grid_constant__ Snap<T> p) {
  yi_body<T, false>(mask, ulist, entries, coef, ylist, nullptr, rows, E, p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    snap_yi_tally_kernel(const int* __restrict__ mask,
                         const T* __restrict__ ulist,
                         const int* __restrict__ entries,
                         const T* __restrict__ coef, T* __restrict__ ylist,
                         T* __restrict__ energy, int rows, int E,
                         const __grid_constant__ Snap<T> p) {
  yi_body<T, true>(mask, ulist, entries, coef, ylist, energy, rows, E, p);
}

template <typename T> struct DeShared {
  Cx<T> lev[2][kLevelMax];
  Cx<T> dlev[2][3 * kLevelMax];
  Cx<T> y[kHalfMax];
};

template <typename T, bool Tally>
__device__ __forceinline__ void deidrj_body(
    const T* __restrict__ x, const int* __restrict__ mask,
    const T* __restrict__ prd_in, const int* __restrict__ shortl,
    const int* __restrict__ nshort, const T* __restrict__ ylist_in,
    T* __restrict__ f, T* __restrict__ vir, int rows, int S,
    const Snap<T>& p) {
  __shared__ int list[kRowsPerBlock];
  __shared__ DeShared<T> sh[kWarps];
  const int n = collect_valid(mask, rows, blockIdx.x * kRowsPerBlock, list);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  DeShared<T>& s = sh[warp];
  const Cx<T>* ylist = reinterpret_cast<const Cx<T>*>(ylist_in);
  const T prd[3] = {prd_in[0], prd_in[1], prd_in[2]};
  const T inv[3] = {T(1) / prd[0], T(1) / prd[1], T(1) / prd[2]};
  int nh = 0;
  for (int j = 0; j <= p.twojmax; ++j) nh += level_size(j);

  for (int q = warp; q < n; q += kWarps) {
    const int i = list[q];
    __syncwarp();
    for (int h = lane; h < nh; h += 32)
      s.y[h] = ylist[static_cast<size_t>(i) * nh + h];
    T fi[3] = {T(0), T(0), T(0)};
    T v[6] = {};
    const int ni = nshort[i];
    for (int jj = 0; jj < ni; ++jj) {
      const int k = shortl[static_cast<size_t>(i) * S + jj];
      T d[3];
      disp(x, i, k, prd, inv, d);
      const T rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
      if (rsq >= p.cutsq || rsq <= T(1e-20)) continue;  // warp-uniform
      Geom<T> g;
      geometry(d, rsq, p, true, &g);
      __syncwarp();
      T dedr[3] = {T(0), T(0), T(0)};
      if (lane == 0) {  // j = 0: u = 1, du = 0
        s.lev[0][0] = {T(1), T(0)};
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          s.dlev[0][c * kLevelMax] = {T(0), T(0)};
          dedr[c] += s.y[0].re * g.dsfac * g.uhat[c];
        }
      }
      int off = 1;
      for (int j = 1; j <= p.twojmax; ++j) {
        __syncwarp();
        const int nj = level_size(j);
        const int pb = (j - 1) & 1, cb = j & 1;
        for (int e = lane; e < nj; e += 32)
          recur<T, true>(p, g, j, e, s.lev[pb], s.dlev[pb], s.lev[cb],
                         s.dlev[cb]);
        __syncwarp();
        if ((j & 1) == 0) {
          middle_fix(s.lev[cb], 1, j, lane);
          middle_fix(s.dlev[cb], 3, j, lane);
          __syncwarp();
        }
        for (int e = lane; e < nj; e += 32) {
          const Cx<T> u = s.lev[cb][e], y = s.y[off + e];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const Cx<T> du = s.dlev[cb][c * kLevelMax + e];
            const T dre = g.dsfac * u.re * g.uhat[c] + g.sfac * du.re;
            const T dim = g.dsfac * u.im * g.uhat[c] + g.sfac * du.im;
            dedr[c] += y.re * dre + y.im * dim;
          }
        }
        off += nj;
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          dedr[c] += __shfl_xor_sync(kFull, dedr[c], o);
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          fi[c] += dedr[c];
          atomicAdd(f + 3 * k + c, -dedr[c]);
        }
        if constexpr (Tally) {  // ev_tally_xyz, delx = -d
          v[0] -= d[0] * dedr[0];
          v[1] -= d[1] * dedr[1];
          v[2] -= d[2] * dedr[2];
          v[3] -= d[0] * dedr[1];
          v[4] -= d[0] * dedr[2];
          v[5] -= d[1] * dedr[2];
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) atomicAdd(f + 3 * i + c, fi[c]);
      if constexpr (Tally) {
#pragma unroll
        for (int c = 0; c < 6; ++c)
          vir[static_cast<size_t>(c) * rows + i] += v[c];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    snap_deidrj_kernel(const T* __restrict__ x, const int* __restrict__ mask,
                       const T* __restrict__ prd,
                       const int* __restrict__ shortl,
                       const int* __restrict__ nshort,
                       const T* __restrict__ ylist, T* __restrict__ f,
                       int rows, int S, const __grid_constant__ Snap<T> p) {
  deidrj_body<T, false>(x, mask, prd, shortl, nshort, ylist, f, nullptr,
                        rows, S, p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    snap_deidrj_tally_kernel(const T* __restrict__ x,
                             const int* __restrict__ mask,
                             const T* __restrict__ prd,
                             const int* __restrict__ shortl,
                             const int* __restrict__ nshort,
                             const T* __restrict__ ylist, T* __restrict__ f,
                             T* __restrict__ vir, int rows, int S,
                             const __grid_constant__ Snap<T> p) {
  deidrj_body<T, true>(x, mask, prd, shortl, nshort, ylist, f, vir, rows, S,
                       p);
}

// ---- ZBL ----------------------------------------------------------------

// models/pair_zbl.PairZBL.kernel_params, and the screening coefficients
template <typename T> struct Zbl {
  T cut_inner, cutsq, da[4], zze, sw[5];
};

template <typename T, bool Tally>
__device__ __forceinline__ void zbl_body(
    const T* __restrict__ x, const int* __restrict__ mask,
    const T* __restrict__ prd_in, const int* __restrict__ shortl,
    const int* __restrict__ nshort, T* __restrict__ f, T* __restrict__ tally,
    int rows, int S, const Zbl<T>& p) {
  __shared__ int list[kRowsPerBlock];
  const int n = collect_valid(mask, rows, blockIdx.x * kRowsPerBlock, list);
  const T prd[3] = {prd_in[0], prd_in[1], prd_in[2]};
  const T inv[3] = {T(1) / prd[0], T(1) / prd[1], T(1) / prd[2]};
  const T cs[4] = {T(0.02817), T(0.28022), T(0.50986), T(0.18175)};
  for (int q = threadIdx.x; q < n; q += kThreads) {
    const int i = list[q];
    const int ni = nshort[i];
    T fi[3] = {T(0), T(0), T(0)};
    T e = T(0), v[6] = {};
    for (int jj = 0; jj < ni; ++jj) {
      T d[3];
      disp(x, i, shortl[static_cast<size_t>(i) * S + jj], prd, inv, d);
      const T rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
      if (rsq >= p.cutsq) continue;
      const T r = sqrt(rsq), rinv = T(1) / r;
      T sum = T(0), sump = T(0);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const T ex = cs[k] * exp(-p.da[k] * r);
        sum += ex;
        sump -= p.da[k] * ex;
      }
      T dedr = p.zze * (sump - sum * rinv) * rinv;
      const T t = r - p.cut_inner;
      const bool outer = rsq > p.cut_inner * p.cut_inner;
      if (outer) dedr += t * t * (p.sw[0] + p.sw[1] * t);
      const T fpair = -dedr * rinv;
#pragma unroll
      for (int c = 0; c < 3; ++c) fi[c] -= d[c] * fpair;  // delx = -d
      if constexpr (Tally) {
        T ep = p.zze * sum * rinv + p.sw[4];
        if (outer) ep += t * t * t * (p.sw[2] + p.sw[3] * t);
        e += T(0.5) * ep;
        const T hf = T(0.5) * fpair;
        v[0] += d[0] * d[0] * hf;
        v[1] += d[1] * d[1] * hf;
        v[2] += d[2] * d[2] * hf;
        v[3] += d[0] * d[1] * hf;
        v[4] += d[0] * d[2] * hf;
        v[5] += d[1] * d[2] * hf;
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) f[3 * i + c] = fi[c];
    if constexpr (Tally) {
      tally[i] = e;
#pragma unroll
      for (int c = 0; c < 6; ++c)
        tally[static_cast<size_t>(c + 1) * rows + i] = v[c];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    zbl_pair_kernel(const T* __restrict__ x, const int* __restrict__ mask,
                    const T* __restrict__ prd, const int* __restrict__ shortl,
                    const int* __restrict__ nshort, T* __restrict__ f,
                    int rows, int S, const __grid_constant__ Zbl<T> p) {
  zbl_body<T, false>(x, mask, prd, shortl, nshort, f, nullptr, rows, S, p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    zbl_pair_tally_kernel(const T* __restrict__ x,
                          const int* __restrict__ mask,
                          const T* __restrict__ prd,
                          const int* __restrict__ shortl,
                          const int* __restrict__ nshort, T* __restrict__ f,
                          T* __restrict__ tally, int rows, int S,
                          const __grid_constant__ Zbl<T> p) {
  zbl_body<T, true>(x, mask, prd, shortl, nshort, f, tally, rows, S, p);
}

// ---- host launchers -----------------------------------------------------

// par: twojmax, rcut^2, rcut, rfac0, rmin0, wj, wself, switchflag, E_0
template <typename T> Snap<T> make_snap(const double* v) {
  Snap<T> p;
  p.twojmax = static_cast<int>(v[0]);
  p.cutsq = T(v[1]);
  p.rcut = T(v[2]);
  p.rfac0 = T(v[3]);
  p.rmin0 = T(v[4]);
  p.wj = T(v[5]);
  p.wself = T(v[6]);
  p.switchflag = static_cast<int>(v[7]);
  p.eshift = T(v[8]);
  for (int a = 0; a <= kJMax; ++a)
    for (int b = 0; b <= kJMax; ++b)
      p.rootpq[a][b] = b == 0 ? T(0) : T(sqrt(double(a) / double(b)));
  return p;
}

int blocks_for(int rows) { return (rows + kRowsPerBlock - 1) / kRowsPerBlock; }

int check_twojmax(const double* par) {
  const int t = static_cast<int>(par[0]);
  return (t < 0 || t > kJMax) ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

template <typename T>
int launch_ui(const void* x, const void* mask, const void* prd,
              const void* shortl, const void* nshort, void* ulist, int rows,
              int S, const double* par, void* stream) {
  if (check_twojmax(par)) return check_twojmax(par);
  snap_ui_kernel<T><<<blocks_for(rows), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int*>(mask),
      static_cast<const T*>(prd), static_cast<const int*>(shortl),
      static_cast<const int*>(nshort), static_cast<T*>(ulist), rows, S,
      make_snap<T>(par));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_yi(const void* mask, const void* ulist, const void* entries,
              const void* coef, void* ylist, void* energy, int rows, int E,
              const double* par, void* stream) {
  if (check_twojmax(par)) return check_twojmax(par);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Snap<T> p = make_snap<T>(par);
  if (energy == nullptr)
    snap_yi_kernel<T><<<blocks_for(rows), kThreads, 0, st>>>(
        static_cast<const int*>(mask), static_cast<const T*>(ulist),
        static_cast<const int*>(entries), static_cast<const T*>(coef),
        static_cast<T*>(ylist), rows, E, p);
  else
    snap_yi_tally_kernel<T><<<blocks_for(rows), kThreads, 0, st>>>(
        static_cast<const int*>(mask), static_cast<const T*>(ulist),
        static_cast<const int*>(entries), static_cast<const T*>(coef),
        static_cast<T*>(ylist), static_cast<T*>(energy), rows, E, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_deidrj(const void* x, const void* mask, const void* prd,
                  const void* shortl, const void* nshort, const void* ylist,
                  void* f, void* vir, int rows, int S, const double* par,
                  void* stream) {
  if (check_twojmax(par)) return check_twojmax(par);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Snap<T> p = make_snap<T>(par);
  if (vir == nullptr)
    snap_deidrj_kernel<T><<<blocks_for(rows), kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const int*>(mask),
        static_cast<const T*>(prd), static_cast<const int*>(shortl),
        static_cast<const int*>(nshort), static_cast<const T*>(ylist),
        static_cast<T*>(f), rows, S, p);
  else
    snap_deidrj_tally_kernel<T><<<blocks_for(rows), kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const int*>(mask),
        static_cast<const T*>(prd), static_cast<const int*>(shortl),
        static_cast<const int*>(nshort), static_cast<const T*>(ylist),
        static_cast<T*>(f), static_cast<T*>(vir), rows, S, p);
  return static_cast<int>(cudaGetLastError());
}

// par: cut_inner, cut_global^2, d1a-d4a, zze, sw1-sw5
template <typename T>
int launch_zbl(const void* x, const void* mask, const void* prd,
               const void* shortl, const void* nshort, void* f, void* tally,
               int rows, int S, const double* par, void* stream) {
  Zbl<T> p;
  p.cut_inner = T(par[0]);
  p.cutsq = T(par[1]);
  for (int k = 0; k < 4; ++k) p.da[k] = T(par[2 + k]);
  p.zze = T(par[6]);
  for (int k = 0; k < 5; ++k) p.sw[k] = T(par[7 + k]);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tally == nullptr)
    zbl_pair_kernel<T><<<blocks_for(rows), kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const int*>(mask),
        static_cast<const T*>(prd), static_cast<const int*>(shortl),
        static_cast<const int*>(nshort), static_cast<T*>(f), rows, S, p);
  else
    zbl_pair_tally_kernel<T><<<blocks_for(rows), kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const int*>(mask),
        static_cast<const T*>(prd), static_cast<const int*>(shortl),
        static_cast<const int*>(nshort), static_cast<T*>(f),
        static_cast<T*>(tally), rows, S, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C entry points (ctypes, ops/snap_kernels.py). Pointers: x [rows, 3]
// and prd [3] of the dtype; mask int32 [rows]; shortl int32 [rows, S];
// nshort int32 [rows]; ulist, ylist [rows, nhalf, 2] of the dtype; entries
// int32 [E] and coef [E] of the dtype (the Y table); energy [rows] or null;
// f [rows, 3] (zeroed by the caller for deidrj); vir [6, rows] (zeroed) or
// null; tally [7, rows] or null; par: host doubles (see the launchers).
#define SNAP_ENTRY(name, T)                                                   \
  extern "C" int snap_ui_##name(const void* x, const void* mask,            \
                                const void* prd, const void* shortl,        \
                                const void* nshort, void* ulist, int rows,  \
                                int S, const double* par, void* stream) {   \
    return launch_ui<T>(x, mask, prd, shortl, nshort, ulist, rows, S, par,  \
                        stream);                                            \
  }                                                                         \
  extern "C" int snap_yi_##name(const void* mask, const void* ulist,        \
                                const void* entries, const void* coef,      \
                                void* ylist, void* energy, int rows, int E, \
                                const double* par, void* stream) {          \
    return launch_yi<T>(mask, ulist, entries, coef, ylist, energy, rows, E, \
                        par, stream);                                       \
  }                                                                         \
  extern "C" int snap_deidrj_##name(                                        \
      const void* x, const void* mask, const void* prd, const void* shortl, \
      const void* nshort, const void* ylist, void* f, void* vir, int rows,  \
      int S, const double* par, void* stream) {                             \
    return launch_deidrj<T>(x, mask, prd, shortl, nshort, ylist, f, vir,    \
                            rows, S, par, stream);                          \
  }                                                                         \
  extern "C" int zbl_pair_##name(const void* x, const void* mask,           \
                                 const void* prd, const void* shortl,       \
                                 const void* nshort, void* f, void* tally,  \
                                 int rows, int S, const double* par,        \
                                 void* stream) {                            \
    return launch_zbl<T>(x, mask, prd, shortl, nshort, f, tally, rows, S,   \
                         par, stream);                                      \
  }

SNAP_ENTRY(f32, float)
SNAP_ENTRY(f64, double)
