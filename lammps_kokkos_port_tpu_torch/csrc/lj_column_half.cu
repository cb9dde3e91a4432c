// The Newton-half column passes of the profiling scripts, for Hopper
// (sm_90a): lj/cut over the half stencil of the column layout
// [nx*ny, nz, cc], in the variants that split the half kernel's cost.
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
//       fused_kern :149-168): forward-only passes, with ids and id-free.
// as instances of one template: a mask (float ids offset by idcap; the
// self block's slot order and 0 < r2; 0 < r2 only), a reciprocal (exact,
// or rcp.approx plus one Newton step) and a reaction output (none; the own
// block's only; 13 blocks per cell, K8's scheme; 5 target blocks per
// column, P8's layout). `Stage = false` (P5 noassembly) never reads the
// candidates: it fills the stage with NaN by stores and walks it, so every
// output is NaN, as unstaged scratch reads in the TPU body's interpret mode.
//
// The hazard: the TPU bodies add reactions into other columns (`fx[ncol] +=`)
// and are race-free only because the TPU grid runs in order. CUDA blocks
// run concurrently, so no block writes another block's output here and no
// global atomic is used:
//   - one block per column (cx, cy), blockDim = (cc rounded up to a warp,
//     w): w warp rows each own one z cell at a time and walk the column in
//     ceil(nz / w) rounds. w is the scripts' `zb` (P2, P11: the z cells of
//     one column a program takes at a time); on this card it sets how many
//     of a column's cells are in flight at once, so it changes occupancy and
//     not results. P5 and P8 take w = nz (at most 1024 threads);
//   - for each of the 14 blocks of the half stencil a warp row stages its
//     cell's candidate block in shared memory (x, y shifted by +-prd where
//     the column wraps, z where the cell wraps, the id offset by idcap for
//     blocks s > 0), and thread i walks the cc candidates rotated by its
//     lane (j = i + k mod cc), so a warp's shared atomics never share an
//     address within a step;
//   - reactions -fij go by shared-memory atomics (native in f32 and f64)
//     into: per warp row react[3][cc] (own: the own block's are added to the
//     own rows, the other 13 dropped; cell: the other 13 are written once to
//     rbuf[cell][s-1][3][cc] and cell_stencil.cuh's half_fold gathers them,
//     K8's scheme); or the column's racc[3][nz][5][cc], grouped by (dx, dy)
//     target and z before they leave the block, written once to
//     rc[col][3][nz][5 cc] (the JAX rc layout), which target_fold then
//     gathers over the 5 source columns (P5 batched, P2), or which the
//     caller folds with torch.roll (P8, as the script does in XLA).
// The forward sums add dx * fpair for every candidate, fpair = 0 outside
// the mask, as the TPU's select form does (and NaN * 0 is NaN).
//
// Cost: 14 cc candidates per row, half the pairs of the 27-cell kernels;
// the arithmetic and the staging bind (latency at the 32k grid, PERF.md).
// r2 is formed with explicitly rounded products and sums, as the plain twin
// forms it.

#include <math.h>

#include "cell_stencil.cuh"

namespace {

using cell_stencil::kHalf;
using cell_stencil::Rn;
using cell_stencil::wrap_dim;

constexpr int kBlocks = cell_stencil::kHalfBlocks;
// reaction targets: the distinct (dx, dy) of the half stencil, in the order
// of prof_kernel_writeonce.py's _TARGETS (:27), and each block's target
constexpr int kTargets = 5;
__constant__ int kTargetXY[kTargets][2] = {
    {0, 0}, {0, 1}, {1, -1}, {1, 0}, {1, 1}};
__constant__ int kTargetOf[kBlocks] = {0, 0, 1, 1, 1, 2, 2, 2,
                                       3, 3, 3, 4, 4, 4};

enum Mask { kIds, kSlot, kDist };
enum React { kNone, kOwn, kCell, kTarget };

template <typename T> struct Args {
  const T* gx;
  const T* gy;
  const T* gz;
  const T* gi;
  const T* prd;
  T* fx;
  T* fy;
  T* fz;
  T* rbuf;  // cell: [ncells][13][3][cc]; target: rc [nx*ny][3][nz][5 cc]
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

template <typename T, Mask M, bool Approx, React R, bool Stage>
__device__ __forceinline__ void column_half(const Args<T>& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kNch = M == kIds ? 4 : 3;  // staged x, y, z (, id)
  constexpr bool kRowReact = R == kOwn || R == kCell;
  const int nz = a.nz, cc = a.cc;
  const int racc_n = R == kTarget ? 3 * nz * kTargets * cc : 0;
  T* racc = reinterpret_cast<T*>(smem_raw);
  T* stage = racc + racc_n + threadIdx.y * (kNch + (kRowReact ? 3 : 0)) * cc;
  T* react = stage + kNch * cc;

  const int col = blockIdx.x;
  const int cx = col / a.ny, cy = col % a.ny;
  const int lane = threadIdx.x;
  const int tid = threadIdx.y * blockDim.x + lane;
  const int nthreads = blockDim.x * blockDim.y;
  const T px = a.prd[0], py = a.prd[1], pz = a.prd[2];
  // ordered before the first atomic by the first block's barriers
  for (int k = tid; k < racc_n; k += nthreads) racc[k] = T(0);

  for (int z0 = 0; z0 < nz; z0 += blockDim.y) {
    const int cz = z0 + threadIdx.y;
    const bool cell_live = cz < nz;
    const bool row_live = cell_live && lane < cc;
    const int cell = col * nz + cz;
    const int row = cell * cc + lane;
    T ox = T(0), oy = T(0), oz = T(0), oid = T(0);
    if (row_live) {
      ox = a.gx[row];
      oy = a.gy[row];
      oz = a.gz[row];
      if (M == kIds) oid = a.gi[row];
    }
    T ax = T(0), ay = T(0), az = T(0);

    for (int s = 0; s < kBlocks; ++s) {
      T shx, shy, shz;
      const int wx = wrap_dim(cx + kHalf[s][0], a.nx, px, &shx);
      const int wy = wrap_dim(cy + kHalf[s][1], a.ny, py, &shy);
      const int wz = wrap_dim(cz + kHalf[s][2], nz, pz, &shz);
      const int nbase = ((wx * a.ny + wy) * nz + wz) * cc;
      __syncthreads();  // the previous block's stage and reactions are read
      if (cell_live) {
        for (int j = lane; j < cc; j += blockDim.x) {
          if (Stage) {
            stage[j] = a.gx[nbase + j] + shx;
            stage[cc + j] = a.gy[nbase + j] + shy;
            stage[2 * cc + j] = a.gz[nbase + j] + shz;
            if (M == kIds) {
              const T id = a.gi[nbase + j];
              stage[3 * cc + j] =
                  (s == 0) ? id : (id >= T(0) ? id + a.idcap : T(-1));
            }
          } else {
#pragma unroll
            for (int c = 0; c < kNch; ++c) stage[c * cc + j] = T(NAN);
          }
          if (kRowReact) {
            react[j] = T(0);
            react[cc + j] = T(0);
            react[2 * cc + j] = T(0);
          }
        }
      }
      __syncthreads();
      if (row_live) {
        T* tacc = racc + (size_t(wz) * kTargets + kTargetOf[s]) * cc;
        int j = lane;
        for (int k = 0; k < cc; ++k, ++j) {
          if (j == cc) j = 0;
          const T dx = ox - stage[j];
          const T dy = oy - stage[cc + j];
          const T dz = oz - stage[2 * cc + j];
          const T r2 = Rn<T>::add(Rn<T>::add(Rn<T>::mul(dx, dx),
                                             Rn<T>::mul(dy, dy)),
                                  Rn<T>::mul(dz, dz));
          bool valid;
          if (M == kIds) {
            valid = oid < stage[3 * cc + j] && r2 < a.cutsq;
          } else {
            valid = r2 < a.cutsq && r2 > T(0) &&
                    (M == kDist || s > 0 || j > lane);
          }
          T fpair = T(0);
          if (valid) {
            // the id-free bodies clamp r2 at 0.25 before the reciprocal
            const T r2s = M == kIds ? r2 : fmax(r2, T(0.25));
            const T r2inv = recip<T, Approx>(r2s);
            const T r6inv = r2inv * r2inv * r2inv;
            fpair = r6inv * (a.lj1 * r6inv - a.lj2) * r2inv;
            if (R != kNone) {
              const T fxij = dx * fpair, fyij = dy * fpair, fzij = dz * fpair;
              if (kRowReact) {
                atomicAdd(&react[j], -fxij);
                atomicAdd(&react[cc + j], -fyij);
                atomicAdd(&react[2 * cc + j], -fzij);
              } else {
                const size_t plane = size_t(nz) * kTargets * cc;
                atomicAdd(&tacc[j], -fxij);
                atomicAdd(&tacc[plane + j], -fyij);
                atomicAdd(&tacc[2 * plane + j], -fzij);
              }
            }
          }
          ax += dx * fpair;
          ay += dy * fpair;
          az += dz * fpair;
        }
      }
      if (kRowReact) {
        __syncthreads();  // every reaction of block s is in react[]
        if (s == 0) {
          if (row_live) {
            ax += react[lane];
            ay += react[cc + lane];
            az += react[2 * cc + lane];
          }
        } else if (R == kCell && cell_live) {
          T* out = a.rbuf + (size_t(cell) * (kBlocks - 1) + (s - 1)) * 3 * cc;
          for (int j = lane; j < cc; j += blockDim.x) {
            out[j] = react[j];
            out[cc + j] = react[cc + j];
            out[2 * cc + j] = react[2 * cc + j];
          }
        }
      }
    }
    if (row_live) {
      a.fx[row] = ax;
      a.fy[row] = ay;
      a.fz[row] = az;
    }
  }
  if (R == kTarget) {
    __syncthreads();  // every reaction of the column is in racc
    T* rc = a.rbuf + size_t(col) * racc_n;
    for (int k = tid; k < racc_n; k += nthreads) rc[k] = racc[k];
  }
}

template <typename T, Mask M, bool Approx, React R>
__global__ void __launch_bounds__(1024) column_half_kernel(const Args<T> a) {
  column_half<T, M, Approx, R, true>(a);
}

// P5 noassembly, under a name of its own so that its SASS can be read apart
// (chip_smoke.py checks that its pair loop is there)
template <typename T>
__global__ void __launch_bounds__(1024)
    column_half_noassembly(const Args<T> a) {
  column_half<T, kIds, false, kCell, false>(a);
}

// f[col][z] += the 5 target blocks aimed at column col: block t of rc at
// column col - target_t (periodic), z already aligned by the pass. A gather,
// one thread per row, no atomics; launched with launch_shape(ncells, cc).
template <typename T>
__global__ void target_fold(const T* __restrict__ rc, T* __restrict__ fx,
                            T* __restrict__ fy, T* __restrict__ fz, int nx,
                            int ny, int nz, int cc) {
  const int cell = blockIdx.x * blockDim.y + threadIdx.y;
  const int lane = threadIdx.x;
  if (cell >= nx * ny * nz || lane >= cc) return;
  const int tz = cell % nz;
  const int t = cell / nz;
  const int ty = t % ny;
  const int tx = t / ny;
  const size_t plane = size_t(nz) * kTargets * cc;
  T a0 = T(0), a1 = T(0), a2 = T(0);
  for (int k = 0; k < kTargets; ++k) {
    const int sx = (tx - kTargetXY[k][0] + nx) % nx;
    const int sy = (ty - kTargetXY[k][1] + ny) % ny;
    const T* in = rc + (sx * ny + sy) * 3 * plane +
                  (size_t(tz) * kTargets + k) * cc + lane;
    a0 += in[0];
    a1 += in[plane];
    a2 += in[2 * plane];
  }
  const int row = cell * cc + lane;
  fx[row] += a0;
  fy[row] += a1;
  fz[row] += a2;
}

template <typename T, Mask M, bool Approx, React R, bool Stage>
int launch_pass(const Args<T>& a, int w, bool fold, cudaStream_t st) {
  constexpr int kNch = (M == kIds ? 4 : 3) + (R == kOwn || R == kCell ? 3 : 0);
  const int lanes = ((a.cc + 31) / 32) * 32;
  const size_t smem =
      (size_t(w) * kNch * a.cc +
       (R == kTarget ? size_t(3) * a.nz * kTargets * a.cc : 0)) *
      sizeof(T);
  void (*kernel)(Args<T>);
  if constexpr (Stage) {
    kernel = column_half_kernel<T, M, Approx, R>;
  } else {
    kernel = column_half_noassembly<T>;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(a.nx * a.ny), dim3(lanes, w), smem, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !(R == kCell || (R == kTarget && fold)))
    return static_cast<int>(err);
  const cell_stencil::Launch L =
      cell_stencil::launch_shape(a.nx * a.ny * a.nz, a.cc);
  if (R == kCell) {
    cell_stencil::half_fold<T><<<L.grid, L.block, 0, st>>>(
        a.rbuf, a.fx, a.fy, a.fz, a.nx, a.ny, a.nz, a.cc);
  } else {
    target_fold<T><<<L.grid, L.block, 0, st>>>(a.rbuf, a.fx, a.fy, a.fz,
                                               a.nx, a.ny, a.nz, a.cc);
  }
  return static_cast<int>(cudaGetLastError());
}

// the passes, numbered as prof/column_half_kernels.PASSES numbers them
template <typename T>
int launch(int pass, const Args<T>& a, int w, bool fold, cudaStream_t st) {
  switch (pass) {
    case 0:  // P5 full (K8's scheme)
      return launch_pass<T, kIds, false, kCell, true>(a, w, fold, st);
    case 1:  // P5 batched (fold = 1), P8 (fold = 0)
      return launch_pass<T, kIds, false, kTarget, true>(a, w, fold, st);
    case 2:  // P5 redonly
      return launch_pass<T, kIds, false, kOwn, true>(a, w, fold, st);
    case 3:  // P5 noreverse, P11 fwd
      return launch_pass<T, kIds, false, kNone, true>(a, w, fold, st);
    case 4:  // P5 noassembly
      return launch_pass<T, kIds, false, kCell, false>(a, w, fold, st);
    case 5:  // P2, exact reciprocal
      return launch_pass<T, kSlot, false, kTarget, true>(a, w, fold, st);
    case 6:  // P2, approximate reciprocal
      return launch_pass<T, kSlot, true, kTarget, true>(a, w, fold, st);
    case 7:  // P11 fused
      return launch_pass<T, kDist, true, kNone, true>(a, w, fold, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). Launch pass `pass` with `w` warp
// rows per block (and the reaction fold where the pass has one and `fold`
// is set) on `stream`, do not synchronise; return cudaGetLastError() after
// the launches (0 = success). `rbuf`: ncells * 13 * 3 * cc values for the
// passes with per-cell reactions, nx * ny * 3 * nz * 5 * cc (rc) for those
// with target blocks, unused otherwise; `gi` unused by the id-free passes.
#define LJ_COLUMN_HALF_ENTRY(NAME, T)                                         \
  extern "C" int NAME(int pass, int w, int fold, const void* gx,             \
                      const void* gy, const void* gz, const void* gi,        \
                      const void* prd, void* fx, void* fy, void* fz,         \
                      void* rbuf, int nx, int ny, int nz, int cc,            \
                      double idcap, double lj1, double lj2, double cutsq,    \
                      void* stream) {                                        \
    const Args<T> a{static_cast<const T*>(gx), static_cast<const T*>(gy),    \
                    static_cast<const T*>(gz), static_cast<const T*>(gi),    \
                    static_cast<const T*>(prd), static_cast<T*>(fx),         \
                    static_cast<T*>(fy), static_cast<T*>(fz),                \
                    static_cast<T*>(rbuf), nx, ny, nz, cc,                   \
                    static_cast<T>(idcap), static_cast<T>(lj1),              \
                    static_cast<T>(lj2), static_cast<T>(cutsq)};             \
    return launch<T>(pass, a, w, fold != 0,                                  \
                     static_cast<cudaStream_t>(stream));                     \
  }

LJ_COLUMN_HALF_ENTRY(lj_column_half_f32, float)
LJ_COLUMN_HALF_ENTRY(lj_column_half_f64, double)
