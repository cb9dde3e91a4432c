// Tersoff (one element) on the sorted cell-major layout, for Hopper
// (sm_90a): the short list and the three-body force pass.
//
// Replaces no Pallas kernel: the JAX package takes Tersoff's forces as
// jax.grad of one energy over its [N, K, K] neighbour matrix
// (lammps_kokkos_port_tpu/models/pair_tersoff.py), which XLA compiles. These
// follow LAMMPS's analytic forces instead (src/MANYBODY/pair_tersoff.cpp:
// repulsive, zeta, force_zeta, attractive, ters_zetaterm_d, costheta_d,
// ters_bij, ters_bij_d), and Kokkos's split into a short-list kernel and a
// force kernel (src/KOKKOS/pair_tersoff_kokkos.cpp).
//
// tersoff_short_kernel: each valid row's neighbours within R + D (cutsq),
//   found on the 27-cell stencil, in walk order (entry s = 0..26 of the
//   stencil with dz innermost, then slot), into a [rows, S] table of row
//   indices and a count per row (0 on invalid rows). A row with more than
//   S neighbours keeps the first S, sets the layout's sticky overflow flag
//   and raises `need` to its count (atomicMax): the host grows S and
//   re-runs the segment. Unit of work: one warp per cell, its lanes over
//   the candidates (27 * cc slots, 32 at a time, read once each), its own
//   valid rows taken one after the other: at Si's density a cell of the
//   4.2 A grid holds about four atoms in 16 slots, so a lane per own row
//   (the cell_walk.cuh unit) would leave about 28 of 32 lanes idle, while
//   a lane per candidate keeps them all loading. The live candidates (not
//   pads, not rows with mask 0: about 72% of the slots are pads) are packed
//   in walk order into batches of 32 in shared memory before the own rows
//   test them. Each own row's hits are appended by a ballot:
//   deterministic, no atomics but the overflow.
//   Bound: the candidate reads (27 * cc slots of x and the mask a cell,
//   the pads' x skipped), about 10 KB a cell from L1 and L2.
//
// tersoff_force_kernel: the forces. Unit of work: one thread per ordered
//   pair (i, j) of the short lists: a block scans the counts of 512 rows
//   (4 a thread), and its 128 threads take the block's pairs in turn (about
//   580 at Si's density: five rounds, 91% of the lanes busy; a thread per
//   row would idle the pad rows' lanes, 72% of the layout). A thread
//   computes zeta_ij over i's other neighbours k, b_ij and db/dzeta, then
//   the chain rule over the same k: the repulsive force onto i (its
//   reverse pair gives j's), the attractive pair force onto i and j, and
//   each triplet's onto i, j and k. Forces on j and k land by float64 (or
//   float32) atomics in the [rows, 3] output, which the wrapper zeroes;
//   i's are summed in registers and added once. Atomics, not a gather: a
//   gather would evaluate each triplet's derivative twice (once from the
//   j side, once from the k side). Bound: operations (each triplet's zeta
//   term and its derivative, with exp, sin, cos, sqrt and a divide), about
//   12 ordered triplets an atom.
//
// tersoff_force_tally_kernel: the same pass for thermo rows, under its own
//   name, which also adds each pair's energy and virial into row i of a
//   [7, rows] tally (pe, then xx, yy, zz, xy, xz, yz as LAMMPS's ev_tally
//   and v_tally3 form them), by atomics; the wrapper sums the valid rows in
//   float64. The step's kernel keeps its registers and its name.
//
// Displacements are minimum images (the box spans at least 3 cells of R +
// D + skin, so the in-cutoff image is the nearest). The kernels read the
// state's [rows, 3] positions and its mask as they are: no planar copy.

#include <cuda_runtime.h>

#include "cell_stencil.cuh"

namespace {

using cell_stencil::Rn;
using cell_stencil::wrap_dim;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kShortWarps = 4;     // cells (warps) a block of the short list
constexpr int kForceThreads = 128;  // threads a block of the force pass
constexpr int kForceRows = 512;     // rows a block of the force pass scans
constexpr int kRowsPerThread = kForceRows / kForceThreads;

// The style's numbers in T, and what LAMMPS derives from them (setup of
// pair_tersoff.cpp: c1-c4, the thresholds of ters_bij's branches).
template <typename T> struct Ters {
  T gamma, lam3, c2, d2, c2_d2, h, n, beta, lam2, bigb, bigr, bigd, lam1,
      biga;
  T c1, c2t, c3, c4, inv_2n, cutsq;
  int m3;  // m == 3: the cube in the exponent
};

template <typename T> __device__ __forceinline__ T cube(T v) {
  return v * v * v;
}

// fc(r) and fc'(r) (ters_fc, ters_fc_d)
template <typename T>
__device__ __forceinline__ void ters_fc(T r, const Ters<T>& p, T* fc,
                                        T* dfc) {
  if (r < p.bigr - p.bigd) {
    *fc = T(1);
    *dfc = T(0);
    return;
  }
  if (r > p.bigr + p.bigd) {
    *fc = T(0);
    *dfc = T(0);
    return;
  }
  const T arg = T(1.57079632679489661923) * (r - p.bigr) / p.bigd;
  T s, c;
  if constexpr (sizeof(T) == 4)
    sincosf(arg, &s, &c);
  else
    sincos(arg, &s, &c);
  *fc = T(0.5) * (T(1) - s);
  *dfc = -(T(0.78539816339744830962) / p.bigd) * c;
}

// exp((lam3 (rij - rik))^m), LAMMPS's clip: 1e30 above 69.0776, 0 below
// -69.0776; and its derivative in rij
template <typename T>
__device__ __forceinline__ T ters_ex(T rij, T rik, const Ters<T>& p, T* der) {
  const T dr = rij - rik;
  const T arg = p.m3 ? cube(p.lam3 * dr) : p.lam3 * dr;
  T ex;
  if (arg > T(69.0776))
    ex = T(1.e30);
  else if (arg < T(-69.0776))
    ex = T(0);
  else
    ex = exp(arg);
  if (der != nullptr)
    *der = p.m3 ? T(3) * cube(p.lam3) * dr * dr * ex : p.lam3 * ex;
  return ex;
}

// g(cos theta) and g'(cos theta) (ters_gijk, ters_gijk_d)
template <typename T>
__device__ __forceinline__ T ters_g(T cost, const Ters<T>& p, T* der) {
  const T hcth = p.h - cost;
  const T den = T(1) / (p.d2 + hcth * hcth);
  if (der != nullptr) *der = p.gamma * (T(-2) * p.c2 * hcth) * den * den;
  return p.gamma * (T(1) + p.c2_d2 - p.c2 * den);
}

// b(zeta) (ters_bij)
template <typename T>
__device__ __forceinline__ T ters_bij(T zeta, const Ters<T>& p) {
  const T tmp = p.beta * zeta;
  if (tmp > p.c1) return T(1) / sqrt(tmp);
  if (tmp > p.c2t)
    return (T(1) - pow(tmp, -p.n) * p.inv_2n) / sqrt(tmp);
  if (tmp < p.c4) return T(1);
  if (tmp < p.c3) return T(1) - pow(tmp, p.n) * p.inv_2n;
  return pow(T(1) + pow(tmp, p.n), -p.inv_2n);
}

// db/dzeta (ters_bij_d)
template <typename T>
__device__ __forceinline__ T ters_bij_d(T zeta, const Ters<T>& p) {
  const T tmp = p.beta * zeta;
  if (tmp > p.c1) return p.beta * T(-0.5) * pow(tmp, T(-1.5));
  if (tmp > p.c2t)
    return p.beta * (T(-0.5) * pow(tmp, T(-1.5)) *
                     (T(1) - (T(1) + p.inv_2n) * pow(tmp, -p.n)));
  if (tmp < p.c4) return T(0);
  if (tmp < p.c3) return T(-0.5) * p.beta * pow(tmp, p.n - T(1));
  const T tmp_n = pow(tmp, p.n);
  return T(-0.5) * pow(T(1) + tmp_n, T(-1) - p.inv_2n) * tmp_n / zeta;
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

template <typename T>
__device__ __forceinline__ T dot3(const T (&a)[3], const T (&b)[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// ---- the short list -----------------------------------------------------

// one warp's staged live candidates, in walk order: up to 63 (fewer than 32
// left over and a tile's 32)
template <typename T> struct ShortStage {
  T x[2 * 32], y[2 * 32], z[2 * 32];
  int row[2 * 32];
};

template <typename T>
__global__ void __launch_bounds__(kShortWarps * 32)
    tersoff_short_kernel(const T* __restrict__ x, const int* __restrict__ mask,
                         const T* __restrict__ prd, int* __restrict__ shortl,
                         int* __restrict__ nshort, int* __restrict__ need,
                         bool* __restrict__ overflow, int nx, int ny, int nz,
                         int cc, int S, T cutsq) {
  __shared__ ShortStage<T> stages[kShortWarps];
  ShortStage<T>& sg = stages[threadIdx.y];
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  const int cell = blockIdx.x * kShortWarps + threadIdx.y;
  if (cell >= nx * ny * nz) return;  // the whole warp
  const int cz = cell % nz, t = cell / nz, cy = t % ny, cx = t / ny;
  const T px = prd[0], py = prd[1], pz = prd[2];
  const int ncand = 27 * cc;
  for (int r0 = 0; r0 < cc; r0 += 32) {
    const int j = r0 + lane;
    const int own_row = cell * cc + j;
    const bool live = j < cc && mask[own_row] != 0;
    T ox = T(0), oy = T(0), oz = T(0);
    if (live) {
      ox = x[3 * own_row];
      oy = x[3 * own_row + 1];
      oz = x[3 * own_row + 2];
    }
    const unsigned owners = __ballot_sync(kFull, live);
    int cnt = 0;  // the count of this lane's own row

    // one candidate a lane (cv: a live one) against every own row: each
    // own row's hits appended in lane order
    auto test = [&](bool cv, int crow, T qx, T qy, T qz) {
      unsigned m = owners;
      while (m != 0u) {
        const int o = __ffs(m) - 1;
        m &= m - 1u;
        const T ax = __shfl_sync(kFull, ox, o);
        const T ay = __shfl_sync(kFull, oy, o);
        const T az = __shfl_sync(kFull, oz, o);
        const int before = __shfl_sync(kFull, cnt, o);
        const int orow = cell * cc + r0 + o;
        bool hit = false;
        if (cv && crow != orow) {
          const T dx = Rn<T>::add(ax, -qx), dy = Rn<T>::add(ay, -qy),
                  dz = Rn<T>::add(az, -qz);
          const T r2 = Rn<T>::add(
              Rn<T>::add(Rn<T>::mul(dx, dx), Rn<T>::mul(dy, dy)),
              Rn<T>::mul(dz, dz));
          hit = r2 < cutsq;
        }
        const unsigned hits = __ballot_sync(kFull, hit);
        if (hit) {
          const int pos = before + __popc(hits & below);
          if (pos < S) shortl[static_cast<size_t>(orow) * S + pos] = crow;
        }
        if (lane == o) cnt += __popc(hits);
      }
    };

    int fill = 0;  // staged live candidates
    for (int q0 = 0; owners != 0u && q0 < ncand; q0 += 32) {
      const int q = q0 + lane;
      bool cv = false;
      int crow = -1;
      T qx = T(0), qy = T(0), qz = T(0);
      if (q < ncand) {
        const int s = q / cc, k = q - s * cc;
        T shx, shy, shz;
        const int wx = wrap_dim(cx + s / 9 - 1, nx, px, &shx);
        const int wy = wrap_dim(cy + (s / 3) % 3 - 1, ny, py, &shy);
        const int wz = wrap_dim(cz + s % 3 - 1, nz, pz, &shz);
        crow = ((wx * ny + wy) * nz + wz) * cc + k;
        cv = mask[crow] != 0;
        if (cv) {  // shifted as the plain twin shifts it
          qx = Rn<T>::add(x[3 * crow], shx);
          qy = Rn<T>::add(x[3 * crow + 1], shy);
          qz = Rn<T>::add(x[3 * crow + 2], shz);
        }
      }
      const unsigned staged = __ballot_sync(kFull, cv);
      if (cv) {
        const int pos = fill + __popc(staged & below);
        sg.x[pos] = qx;
        sg.y[pos] = qy;
        sg.z[pos] = qz;
        sg.row[pos] = crow;
      }
      fill += __popc(staged);
      const bool last = q0 + 32 >= ncand;
      while (fill >= 32 || (last && fill > 0)) {  // warp-uniform
        __syncwarp();
        const int take = min(fill, 32);
        const bool mine = lane < take;
        const bool carry = lane + 32 < fill;
        T bx = T(0), by = T(0), bz = T(0), kx = T(0), ky = T(0), kz = T(0);
        int brow = -1, krow = -1;
        if (mine) {
          bx = sg.x[lane], by = sg.y[lane], bz = sg.z[lane];
          brow = sg.row[lane];
        }
        if (carry) {
          kx = sg.x[lane + 32], ky = sg.y[lane + 32], kz = sg.z[lane + 32];
          krow = sg.row[lane + 32];
        }
        __syncwarp();
        if (carry) {  // the rest, to the front, in order
          sg.x[lane] = kx, sg.y[lane] = ky, sg.z[lane] = kz;
          sg.row[lane] = krow;
        }
        fill -= take;
        test(mine, brow, bx, by, bz);
      }
    }
    if (j < cc) {
      nshort[own_row] = min(cnt, S);
      if (cnt > S) {
        atomicMax(need, cnt);
        *overflow = true;
      }
    }
  }
}

// ---- the force pass -----------------------------------------------------

template <typename T>
__device__ __forceinline__ void add3(T* __restrict__ f, int row,
                                     const T (&v)[3]) {
  atomicAdd(f + 3 * row, v[0]);
  atomicAdd(f + 3 * row + 1, v[1]);
  atomicAdd(f + 3 * row + 2, v[2]);
}

// the virial of a pair term, r (x) f with f = d * fpair: (xx, yy, zz, xy,
// xz, yz)
template <typename T>
__device__ __forceinline__ void vir_pair(T (&v)[6], const T (&d)[3],
                                         T fpair) {
  v[0] += d[0] * d[0] * fpair;
  v[1] += d[1] * d[1] * fpair;
  v[2] += d[2] * d[2] * fpair;
  v[3] += d[0] * d[1] * fpair;
  v[4] += d[0] * d[2] * fpair;
  v[5] += d[1] * d[2] * fpair;
}

template <typename T, bool Tally>
__device__ __forceinline__ void force_body(
    const T* __restrict__ x, const int* __restrict__ shortl,
    const int* __restrict__ nshort, const T* __restrict__ prd_in,
    T* __restrict__ f, T* __restrict__ tally, int rows, int S,
    const Ters<T>& p) {
  __shared__ int start[kForceRows + 1];
  __shared__ int warp_total[kForceThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = blockIdx.x * kForceRows;

  // exclusive starts of the block's rows' pairs
  int cnt[kRowsPerThread];
  int sum = 0;
#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a) {
    const int r = base + tid * kRowsPerThread + a;
    cnt[a] = r < rows ? nshort[r] : 0;
    sum += cnt[a];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int run = incl - sum, total = 0;
#pragma unroll
  for (int w = 0; w < kForceThreads / 32; ++w) {
    if (w < warp) run += warp_total[w];
    total += warp_total[w];
  }
#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a) {
    start[tid * kRowsPerThread + a] = run;
    run += cnt[a];
  }
  if (tid == 0) start[kForceRows] = total;
  __syncthreads();

  const T prd[3] = {prd_in[0], prd_in[1], prd_in[2]};
  const T inv[3] = {T(1) / prd[0], T(1) / prd[1], T(1) / prd[2]};

  // the pair (i, j) of slot jj of the block's row r
  auto pair = [&](int r, int jj) {
    const int i = base + r;
    const int ni = start[r + 1] - start[r];
    const int* __restrict__ li = shortl + static_cast<size_t>(i) * S;
    const int j = li[jj];

    T d1[3];  // x_j - x_i
    disp(x, i, j, prd, inv, d1);
    const T rsq1 = dot3(d1, d1);
    if (rsq1 >= p.cutsq) return;
    const T r1 = sqrt(rsq1), r1inv = T(1) / r1;
    T fc1, dfc1;
    ters_fc(r1, p, &fc1, &dfc1);

    // repulsive: the whole force onto i (the pair (j, i) gives j's)
    const T erep = exp(-p.lam1 * r1);
    const T frep = -p.biga * erep * (dfc1 - fc1 * p.lam1) * r1inv;
    T fi[3] = {-d1[0] * frep, -d1[1] * frep, -d1[2] * frep};
    T e = T(0), v[6] = {};
    if constexpr (Tally) {
      e = T(0.5) * fc1 * p.biga * erep;
      vir_pair(v, d1, T(0.5) * frep);
    }

    // zeta_ij over i's other neighbours
    T zeta = T(0);
    for (int kk = 0; kk < ni; ++kk) {
      if (kk == jj) continue;
      T d2[3];
      disp(x, i, li[kk], prd, inv, d2);
      const T rsq2 = dot3(d2, d2);
      if (rsq2 >= p.cutsq) continue;
      const T r2 = sqrt(rsq2);
      T fc2, dfc2;
      ters_fc(r2, p, &fc2, &dfc2);
      const T cost = dot3(d1, d2) / (r1 * r2);
      zeta += fc2 * ters_g(cost, p, static_cast<T*>(nullptr)) *
              ters_ex(r1, r2, p, static_cast<T*>(nullptr));
    }

    // force_zeta: the attractive pair force
    const T eatt = p.bigb * exp(-p.lam2 * r1);
    const T fa = -eatt * fc1;
    const T fa_d = eatt * (p.lam2 * fc1 - dfc1);
    const T bij = ters_bij(zeta, p);
    const T fforce = T(0.5) * bij * fa_d * r1inv;
    const T prefactor = T(-0.5) * fa * ters_bij_d(zeta, p);
    T fj[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      fi[c] += d1[c] * fforce;
      fj[c] = -d1[c] * fforce;
    }
    if constexpr (Tally) {
      e += T(0.5) * bij * fa;
      vir_pair(v, d1, -fforce);
    }

    // attractive: each triplet's forces on i, j and k (ters_zetaterm_d)
    const T rij_hat[3] = {d1[0] * r1inv, d1[1] * r1inv, d1[2] * r1inv};
    for (int kk = 0; kk < ni; ++kk) {
      if (kk == jj) continue;
      const int k = li[kk];
      T d2[3];
      disp(x, i, k, prd, inv, d2);
      const T rsq2 = dot3(d2, d2);
      if (rsq2 >= p.cutsq) continue;
      const T r2 = sqrt(rsq2), r2inv = T(1) / r2;
      const T rik_hat[3] = {d2[0] * r2inv, d2[1] * r2inv, d2[2] * r2inv};
      T fc2, dfc2, gd, exd;
      ters_fc(r2, p, &fc2, &dfc2);
      const T ex = ters_ex(r1, r2, p, &exd);
      const T cost = dot3(rij_hat, rik_hat);
      const T g = ters_g(cost, p, &gd);
      // costheta_d
      T dcj[3], dck[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        dcj[c] = (rik_hat[c] - cost * rij_hat[c]) * r1inv;
        dck[c] = (rij_hat[c] - cost * rik_hat[c]) * r2inv;
      }
      const T a_fc = -dfc2 * g * ex;      // on rik_hat, for i
      const T a_g = fc2 * gd * ex;        // on dcos
      const T a_ex = fc2 * g * exd;       // on (rik_hat - rij_hat), for i
      T dri[3], drj[3], drk[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        dri[c] = prefactor * (a_fc * rik_hat[c] - a_g * (dcj[c] + dck[c]) +
                              a_ex * (rik_hat[c] - rij_hat[c]));
        drj[c] = prefactor * (a_g * dcj[c] + a_ex * rij_hat[c]);
        drk[c] = prefactor * (-a_fc * rik_hat[c] + a_g * dck[c] -
                              a_ex * rik_hat[c]);
        fi[c] += dri[c];
        fj[c] += drj[c];
      }
      add3(f, k, drk);
      if constexpr (Tally) {  // v_tally3(i, j, k, fj, fk, drij, drik)
        v[0] += d1[0] * drj[0] + d2[0] * drk[0];
        v[1] += d1[1] * drj[1] + d2[1] * drk[1];
        v[2] += d1[2] * drj[2] + d2[2] * drk[2];
        v[3] += d1[0] * drj[1] + d2[0] * drk[1];
        v[4] += d1[0] * drj[2] + d2[0] * drk[2];
        v[5] += d1[1] * drj[2] + d2[1] * drk[2];
      }
    }
    add3(f, i, fi);
    add3(f, j, fj);
    if constexpr (Tally) {
      atomicAdd(tally + i, e);
#pragma unroll
      for (int c = 0; c < 6; ++c)
        atomicAdd(tally + static_cast<size_t>(c + 1) * rows + i, v[c]);
    }
  };

  for (int pr = tid; pr < total; pr += kForceThreads) {
    // the row of pair pr: the last row whose start is <= pr
    int r = 0;
#pragma unroll
    for (int step = kForceRows / 2; step > 0; step >>= 1)
      if (start[r + step] <= pr) r += step;
    pair(r, pr - start[r]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kForceThreads)
    tersoff_force_kernel(const T* __restrict__ x,
                         const int* __restrict__ shortl,
                         const int* __restrict__ nshort,
                         const T* __restrict__ prd, T* __restrict__ f,
                         int rows, int S, const __grid_constant__ Ters<T> p) {
  force_body<T, false>(x, shortl, nshort, prd, f, nullptr, rows, S, p);
}

template <typename T>
__global__ void __launch_bounds__(kForceThreads)
    tersoff_force_tally_kernel(const T* __restrict__ x,
                               const int* __restrict__ shortl,
                               const int* __restrict__ nshort,
                               const T* __restrict__ prd, T* __restrict__ f,
                               T* __restrict__ tally, int rows, int S,
                               const __grid_constant__ Ters<T> p) {
  force_body<T, true>(x, shortl, nshort, prd, f, tally, rows, S, p);
}

// The parameters in T from the FIELDS order of models/pair_tersoff.py (m,
// gamma, lam3, c, d, h, n, beta, lam2, B, R, D, lam1, A), with LAMMPS's
// derived constants computed in double.
template <typename T> Ters<T> make_params(const double* v) {
  const double n = v[6];
  const double c1 = pow(2.0 * n * 1.0e-16, -1.0 / n);
  const double c2 = pow(2.0 * n * 1.0e-8, -1.0 / n);
  const double cut = v[10] + v[11];
  Ters<T> p;
  p.gamma = T(v[1]);
  p.lam3 = T(v[2]);
  p.c2 = T(v[3] * v[3]);
  p.d2 = T(v[4] * v[4]);
  p.c2_d2 = T(v[3] * v[3] / (v[4] * v[4]));
  p.h = T(v[5]);
  p.n = T(n);
  p.beta = T(v[7]);
  p.lam2 = T(v[8]);
  p.bigb = T(v[9]);
  p.bigr = T(v[10]);
  p.bigd = T(v[11]);
  p.lam1 = T(v[12]);
  p.biga = T(v[13]);
  p.c1 = T(c1);
  p.c2t = T(c2);
  p.c3 = T(1.0 / c2);
  p.c4 = T(1.0 / c1);
  p.inv_2n = T(1.0 / (2.0 * n));
  p.cutsq = T(cut * cut);
  p.m3 = v[0] == 3.0;
  return p;
}

template <typename T>
int launch_short(const void* x, const void* mask, const void* prd,
                 void* shortl, void* nshort, void* need, void* overflow,
                 int nx, int ny, int nz, int cc, int S, double cutsq,
                 void* stream) {
  const int ncell = nx * ny * nz;
  const dim3 grid((ncell + kShortWarps - 1) / kShortWarps);
  const dim3 block(32, kShortWarps);
  tersoff_short_kernel<T><<<grid, block, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int*>(mask),
      static_cast<const T*>(prd), static_cast<int*>(shortl),
      static_cast<int*>(nshort), static_cast<int*>(need),
      static_cast<bool*>(overflow), nx, ny, nz, cc, S, T(cutsq));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_force(const void* x, const void* shortl, const void* nshort,
                 const void* prd, void* f, void* tally, int rows, int S,
                 const double* par, void* stream) {
  const Ters<T> p = make_params<T>(par);
  const dim3 grid((rows + kForceRows - 1) / kForceRows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tally == nullptr)
    tersoff_force_kernel<T><<<grid, kForceThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const int*>(shortl),
        static_cast<const int*>(nshort), static_cast<const T*>(prd),
        static_cast<T*>(f), rows, S, p);
  else
    tersoff_force_tally_kernel<T><<<grid, kForceThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const int*>(shortl),
        static_cast<const int*>(nshort), static_cast<const T*>(prd),
        static_cast<T*>(f), static_cast<T*>(tally), rows, S, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C entry points (ctypes, ops/tersoff_kernels.py). Pointers: x [rows, 3]
// and prd [3] of the dtype; mask int32 [rows]; shortl int32 [rows, S];
// nshort int32 [rows]; need int32 [1]; overflow bool [1]; f [rows, 3] and
// tally [7, rows] of the dtype, zeroed by the caller; par: the 14 numbers of
// models/pair_tersoff.FIELDS (host memory).
extern "C" int tersoff_short_f32(const void* x, const void* mask,
                                 const void* prd, void* shortl, void* nshort,
                                 void* need, void* overflow, int nx, int ny,
                                 int nz, int cc, int S, double cutsq,
                                 void* stream) {
  return launch_short<float>(x, mask, prd, shortl, nshort, need, overflow, nx,
                             ny, nz, cc, S, cutsq, stream);
}

extern "C" int tersoff_short_f64(const void* x, const void* mask,
                                 const void* prd, void* shortl, void* nshort,
                                 void* need, void* overflow, int nx, int ny,
                                 int nz, int cc, int S, double cutsq,
                                 void* stream) {
  return launch_short<double>(x, mask, prd, shortl, nshort, need, overflow,
                              nx, ny, nz, cc, S, cutsq, stream);
}

extern "C" int tersoff_force_f32(const void* x, const void* shortl,
                                 const void* nshort, const void* prd, void* f,
                                 int rows, int S, const double* par,
                                 void* stream) {
  return launch_force<float>(x, shortl, nshort, prd, f, nullptr, rows, S, par,
                             stream);
}

extern "C" int tersoff_force_f64(const void* x, const void* shortl,
                                 const void* nshort, const void* prd, void* f,
                                 int rows, int S, const double* par,
                                 void* stream) {
  return launch_force<double>(x, shortl, nshort, prd, f, nullptr, rows, S,
                              par, stream);
}

extern "C" int tersoff_force_tally_f32(const void* x, const void* shortl,
                                       const void* nshort, const void* prd,
                                       void* f, void* tally, int rows, int S,
                                       const double* par, void* stream) {
  return launch_force<float>(x, shortl, nshort, prd, f, tally, rows, S, par,
                             stream);
}

extern "C" int tersoff_force_tally_f64(const void* x, const void* shortl,
                                       const void* nshort, const void* prd,
                                       void* f, void* tally, int rows, int S,
                                       const double* par, void* stream) {
  return launch_force<double>(x, shortl, nshort, prd, f, tally, rows, S, par,
                              stream);
}
