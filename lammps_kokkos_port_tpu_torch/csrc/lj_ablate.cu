// Timing ablations of the sorted lj/cut pass, for Hopper (sm_90a).
//
// Replaces the Pallas prototypes P9 of benchmarks/prof/prof_sorted_ablate.py
// (one call site, `make_call` :169-183, pallas_call :171), whose three
// bodies split the Newton-half column pass (K1) into its two costs:
//   asm_only          asm_only_kernel  :96-130: assemble the 14 half-stencil
//                     candidate blocks (x, y, z shifted where the column or
//                     the z roll wraps, and the id), then write the own
//                     block's (x + y, z, id);
//   pair_only         pair_only_kernel :132-167 (approx False): the pair
//                     math of 14*cc candidates per row against a constant
//                     candidate scratch (every channel = 3.0), a pair valid
//                     where 0 <= own_id < cand_id and r2 < cutsq; exact 1/r2;
//   pair_only_approx  the same with the hardware approximate reciprocal
//                     (pl.reciprocal(approx=True) there, rcp.approx.ftz.f32
//                     here), f32 only;
// and P4 of benchmarks/prof/prof_kernel_cc32.py (t4_call :238-246, kernel
// t4_kernel :210-236, pallas_call :239): pair_only's math against the same
// constant scratch over NPAD = 512 lanes (:179), the 14*cc = 448 candidates
// rounded up to 128-lane tiles. The lane count is an argument (`lanes`),
// so one kernel serves both scripts; every lane of the constant scratch is
// a live candidate, so a kept row sums `lanes` equal terms.
// Layout: the column grid [nx*ny, nz, cc] read as cells (cx*ny+cy)*nz+cz.
//
// asm_only stages all 14 blocks in shared memory (stage[14][4][cc] per
// cell) before the barrier and reads block 0 after it: the stores feed
// other threads' reads as far as the compiler can tell, so the 14 blocks'
// global loads stay. The block loop is unrolled, so the kernel's SASS holds
// 14 * 4 = 56 global loads (LDG) of the staging; chip_smoke.py counts them
// with cuobjdump. One block row per cell, one thread per row
// (cell_stencil.cuh's launch shape). Bound: memory (it does no arithmetic
// beyond the shifts).
//
// pair_only keeps the TPU body's branch-free form, which is what the
// ablation measures: every row runs the reciprocal and the force terms for
// every one of its `lanes` candidates, invalid ones with r2 = 1 and a zero
// factor, as the TPU's vector lanes do; the scratch is filled at run time
// from `fill`, so the compiler cannot fold it; r2 is formed with explicitly
// rounded products and sums. Bound: the arithmetic of lanes candidates
// per row. The first design (one thread per row, one chain of `lanes`
// bodies, four scalar shared loads a candidate: 0.0483 ms at the 32k melt
// in f32 on an H100, about 13 warps per SM) was bound by latency. Here
// kSplit threads share a row, each with two independent chains (lanes
// j = sub + 2k kSplit and j + kSplit), so 4 kSplit times the bodies are in
// flight per row; the candidate is one packed (x, y, z, id) record, one
// 16-byte broadcast load in f32; the partial sums meet by warp shuffles in
// a fixed butterfly order (deterministic). kSplit was chosen by measurement
// (on an H100: 4 threads a row against 8, 4% faster in f64, within 2%
// in f32, where 8 gain 1-2% with the exact divide).

#include "cell_stencil.cuh"

namespace {

using cell_stencil::kHalf;
using cell_stencil::Rn;
using cell_stencil::wrap_dim;

constexpr int kBlocks = cell_stencil::kHalfBlocks;

template <typename T>
__global__ void asm_only_kernel(const T* __restrict__ gx,
                                const T* __restrict__ gy,
                                const T* __restrict__ gz,
                                const T* __restrict__ gi,
                                const T* __restrict__ prd, T* __restrict__ fx,
                                T* __restrict__ fy, T* __restrict__ fz,
                                int nx, int ny, int nz, int cc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage = reinterpret_cast<T*>(smem_raw) + threadIdx.y * kBlocks * 4 * cc;
  const int ncell = nx * ny * nz;
  const int cell = blockIdx.x * blockDim.y + threadIdx.y;
  const bool cell_live = cell < ncell;
  const int lane = threadIdx.x;
  int cx = 0, cy = 0, cz = 0;
  if (cell_live) {
    cz = cell % nz;
    const int t = cell / nz;
    cy = t % ny;
    cx = t / ny;
  }
  const T px = prd[0], py = prd[1], pz = prd[2];
#pragma unroll
  for (int s = 0; s < kBlocks; ++s) {
    T shx, shy, shz;
    const int wx = wrap_dim(cx + kHalf[s][0], nx, px, &shx);
    const int wy = wrap_dim(cy + kHalf[s][1], ny, py, &shy);
    const int wz = wrap_dim(cz + kHalf[s][2], nz, pz, &shz);
    const int nbase = ((wx * ny + wy) * nz + wz) * cc;
    T* blk = stage + s * 4 * cc;
    if (cell_live) {
      for (int j = lane; j < cc; j += blockDim.x) {
        blk[j] = gx[nbase + j] + shx;
        blk[cc + j] = gy[nbase + j] + shy;
        blk[2 * cc + j] = gz[nbase + j] + shz;
        blk[3 * cc + j] = gi[nbase + j];
      }
    }
  }
  __syncthreads();
  if (cell_live && lane < cc) {
    const int row = cell * cc + lane;
    fx[row] = stage[lane] + stage[cc + lane];
    fy[row] = stage[2 * cc + lane];
    fz[row] = stage[3 * cc + lane];
  }
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, bool Approx>
__device__ __forceinline__ T recip(T x) {
  if constexpr (Approx) {
    return rcp_approx(x);
  } else {
    return T(1) / x;
  }
}

constexpr int kSplit = 4;  // threads per row (a power of two <= 32)
constexpr int kPairThreads = 256;  // threads per block

// the scratch's record j: (x, y, z, id), one 16-byte load in f32
__device__ __forceinline__ void record(const float* s, int j, float* c) {
  const float4 v = reinterpret_cast<const float4*>(s)[j];
  c[0] = v.x, c[1] = v.y, c[2] = v.z, c[3] = v.w;
}
__device__ __forceinline__ void record(const double* s, int j, double* c) {
  const double2 a = reinterpret_cast<const double2*>(s)[2 * j];
  const double2 b = reinterpret_cast<const double2*>(s)[2 * j + 1];
  c[0] = a.x, c[1] = a.y, c[2] = b.x, c[3] = b.y;
}

// the TPU body for candidate j of the scratch, added into acc
template <typename T, bool Approx>
__device__ __forceinline__ void pair_term(const T* scratch, int j, T ox,
                                          T oy, T oz, T oid, T lj1, T lj2,
                                          T cutsq, T (&acc)[3]) {
  T c[4];
  record(scratch, j, c);
  const T dx = ox - c[0];
  const T dy = oy - c[1];
  const T dz = oz - c[2];
  const T r2 = Rn<T>::add(Rn<T>::add(Rn<T>::mul(dx, dx), Rn<T>::mul(dy, dy)),
                          Rn<T>::mul(dz, dz));
  const bool valid = oid < c[3] && oid >= T(0) && r2 < cutsq;
  const T r2inv = recip<T, Approx>(valid ? r2 : T(1));
  const T r6inv = r2inv * r2inv * r2inv;
  const T fpair = valid ? r6inv * (lj1 * r6inv - lj2) * r2inv : T(0);
  acc[0] += dx * fpair;
  acc[1] += dy * fpair;
  acc[2] += dz * fpair;
}

// kSplit threads per row (consecutive lanes of one warp), `rows` rows; the
// scratch holds nj records
template <typename T, bool Approx>
__global__ void __launch_bounds__(kPairThreads) pair_only_kernel(
    const T* __restrict__ gx, const T* __restrict__ gy,
    const T* __restrict__ gz, const T* __restrict__ gi, T* __restrict__ fx,
    T* __restrict__ fy, T* __restrict__ fz, int rows, int nj, T fill, T lj1,
    T lj2, T cutsq) {
  static_assert(32 % kSplit == 0, "a row's threads share one warp");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* scratch = reinterpret_cast<T*>(smem_raw);  // [nj][4], all `fill`
  for (int k = threadIdx.x; k < 4 * nj; k += blockDim.x) scratch[k] = fill;
  __syncthreads();
  const long t = long(blockIdx.x) * blockDim.x + threadIdx.x;
  const int row = static_cast<int>(t / kSplit), sub = threadIdx.x % kSplit;
  const bool live = row < rows;
  T a[3] = {T(0), T(0), T(0)}, b[3] = {T(0), T(0), T(0)};
  if (live) {
    const T ox = gx[row], oy = gy[row], oz = gz[row], oid = gi[row];
    int j = sub;
    for (; j + kSplit < nj; j += 2 * kSplit) {  // two independent chains
      pair_term<T, Approx>(scratch, j, ox, oy, oz, oid, lj1, lj2, cutsq, a);
      pair_term<T, Approx>(scratch, j + kSplit, ox, oy, oz, oid, lj1, lj2,
                           cutsq, b);
    }
    if (j < nj)
      pair_term<T, Approx>(scratch, j, ox, oy, oz, oid, lj1, lj2, cutsq, a);
  }
  // the row's partial sums, in one butterfly order on every thread
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a[c] += b[c];
#pragma unroll
    for (int off = kSplit / 2; off > 0; off >>= 1)
      a[c] += __shfl_xor_sync(0xffffffffu, a[c], off);
  }
  if (live && sub == 0) {
    fx[row] = a[0];
    fy[row] = a[1];
    fz[row] = a[2];
  }
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename T>
int launch_asm(const void* gx, const void* gy, const void* gz, const void* gi,
               const void* prd, void* fx, void* fy, void* fz, int nx, int ny,
               int nz, int cc, void* stream) {
  const cell_stencil::Launch L = cell_stencil::launch_shape(nx * ny * nz, cc);
  const size_t smem = size_t(kBlocks) * 4 * L.block.y * cc * sizeof(T);
  const int err = set_smem(reinterpret_cast<const void*>(&asm_only_kernel<T>),
                           smem);
  if (err != 0) return err;
  asm_only_kernel<T><<<L.grid, L.block, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gx), static_cast<const T*>(gy),
      static_cast<const T*>(gz), static_cast<const T*>(gi),
      static_cast<const T*>(prd), static_cast<T*>(fx), static_cast<T*>(fy),
      static_cast<T*>(fz), nx, ny, nz, cc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool Approx>
int launch_pair(const void* gx, const void* gy, const void* gz,
                const void* gi, void* fx, void* fy, void* fz, int ncell,
                int cc, int lanes, double fill, double lj1, double lj2,
                double cutsq, void* stream) {
  const int rows = ncell * cc;
  const long threads = long(rows) * kSplit;
  const unsigned blocks =
      static_cast<unsigned>((threads + kPairThreads - 1) / kPairThreads);
  const size_t smem = size_t(4) * lanes * sizeof(T);
  const int err = set_smem(
      reinterpret_cast<const void*>(&pair_only_kernel<T, Approx>), smem);
  if (err != 0) return err;
  pair_only_kernel<T, Approx><<<blocks, kPairThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gx), static_cast<const T*>(gy),
      static_cast<const T*>(gz), static_cast<const T*>(gi),
      static_cast<T*>(fx), static_cast<T*>(fy), static_cast<T*>(fz), rows,
      lanes, static_cast<T>(fill), static_cast<T>(lj1), static_cast<T>(lj2),
      static_cast<T>(cutsq));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Launch on `stream`, do not
// synchronise; return cudaGetLastError() after the launch (0 = success).
#define ASM_ONLY_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* gx, const void* gy, const void* gz,     \
                      const void* gi, const void* prd, void* fx, void* fy, \
                      void* fz, int nx, int ny, int nz, int cc,           \
                      void* stream) {                                     \
    return launch_asm<T>(gx, gy, gz, gi, prd, fx, fy, fz, nx, ny, nz, cc, \
                         stream);                                         \
  }

// `lanes`: the candidates of a row (14 * cc for P9, 512 for P4)
#define PAIR_ONLY_ENTRY(NAME, T, APPROX)                                     \
  extern "C" int NAME(const void* gx, const void* gy, const void* gz,       \
                      const void* gi, void* fx, void* fy, void* fz,         \
                      int ncell, int cc, int lanes, double fill,            \
                      double lj1, double lj2, double cutsq, void* stream) { \
    return launch_pair<T, APPROX>(gx, gy, gz, gi, fx, fy, fz, ncell, cc,    \
                                  lanes, fill, lj1, lj2, cutsq, stream);    \
  }

ASM_ONLY_ENTRY(lj_asm_only_f32, float)
ASM_ONLY_ENTRY(lj_asm_only_f64, double)
PAIR_ONLY_ENTRY(lj_pair_only_f32, float, false)
PAIR_ONLY_ENTRY(lj_pair_only_f64, double, false)
PAIR_ONLY_ENTRY(lj_pair_only_approx_f32, float, true)
