// lj/cut force-only pass over the Newton-half stencil, with the reactions
// carried out of the kernel in a buffer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   K8  plane_half_force_pallas  lammps_kokkos_port_tpu/ops/pallas_pair.py:471
//       (kernel _plane_half_kernel :375-459, pallas_call :512, the fold of
//       the cross-column reactions :521-529)
//   P10 fwd_call                 benchmarks/prof/prof_v3_iso.py:77
//       (kernel fwd_kernel :42-74, pallas_call :97): K8's forward sums only,
//       no reactions (physically wrong, a timing ablation)
// as two instances of one template (`React`).
//
// What K8 computes: each own row i pairs with the 14 candidate blocks of
// the half stencil _HALF (:208-212): the own cell and the 13 offsets that
// are lexicographically positive. Candidate ids of blocks s > 0 are offset
// by `idcap` (:402-403; -1 stays -1), so the rule `own_id < cand_id` is
// i < j in the own cell and "candidate is real" elsewhere. Each pair is
// evaluated once: fij goes to row i and -fij to row j.
//
// The hazard: K8 is race-free on the TPU because every program writes its
// own reaction slot (the rc output) and the caller folds them. CUDA blocks
// run concurrently, so this kernel keeps that property and uses no global
// atomics:
//   - one block row per own cell, one thread per own row;
//   - for each of the 14 blocks the cell's candidate block is staged in
//     shared memory with the +-prd shift of the wrapped dims (wrap_dim, in
//     place of the padded pre-shifted copies of :478-488), and a shared
//     reaction accumulator react[3][cc] is zeroed;
//   - thread i walks the cc candidates rotated by its lane (j = i + k mod
//     cc), so the threads of a warp hit distinct candidates at every step;
//     it adds fij to its forward sum in registers and -fij to react[.][j]
//     with a shared-memory atomicAdd (native in f32 and f64 on sm_90a);
//   - after the block: the own cell's reactions (s = 0) go to the own rows'
//     sums; each of the 13 others is written once to rbuf[cell][s-1][3][cc];
//   - a second small kernel (the fold, cell_stencil.cuh's half_fold) adds,
//     for every cell and row, the 13 blocks that target it:
//     rbuf[cell - offset_s][s-1]. It is a gather, one thread per row, no
//     atomics, and runs right after the first kernel on the same stream. A
//     kernel and not torch.roll: the 13 rolls of the
//     JAX wrapper's counterpart would be 39 passes over [nx, ny, nz, cc]
//     tensors plus the adds.
// The shared atomics sum each candidate's reactions in an order that varies
// from run to run; the forward sums run in a fixed order.
//
// Cost: 14*cc candidates per row, half the pairs of the 27-cell kernels;
// the pair arithmetic binds, plus the reaction buffer (13*3*cc values per
// cell written and read once: 253 MB each way at the 1M grid in f32).
//
// r2 is formed with explicitly rounded products and sums, as the plain twin
// forms it; 1/r2 is an exact IEEE divide (the JAX `_recip` off the TPU).

#include "cell_stencil.cuh"

namespace {

using cell_stencil::kHalf;
using cell_stencil::Rn;
using cell_stencil::wrap_dim;

constexpr int kBlocks = cell_stencil::kHalfBlocks;

template <typename T, bool React>
__global__ void lj_plane_half_kernel(
    const T* __restrict__ gx, const T* __restrict__ gy,
    const T* __restrict__ gz, const T* __restrict__ gi,
    const T* __restrict__ prd, T* __restrict__ fx, T* __restrict__ fy,
    T* __restrict__ fz, T* __restrict__ rbuf, int nx, int ny, int nz, int cc,
    T idcap, T lj1, T lj2, T cutsq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kNch = React ? 7 : 4;  // staged x, y, z, id (+ reactions)
  T* stage = reinterpret_cast<T*>(smem_raw) + threadIdx.y * kNch * cc;
  T* react = stage + 4 * cc;

  const int ncell = nx * ny * nz;
  const int cell = blockIdx.x * blockDim.y + threadIdx.y;
  const bool cell_live = cell < ncell;
  const int lane = threadIdx.x;
  const bool row_live = cell_live && lane < cc;
  const int row = cell * cc + lane;
  int cx = 0, cy = 0, cz = 0;
  if (cell_live) {
    cz = cell % nz;
    const int t = cell / nz;
    cy = t % ny;
    cx = t / ny;
  }
  const T px = prd[0], py = prd[1], pz = prd[2];
  T ox = T(0), oy = T(0), oz = T(0), oid = T(0);
  if (row_live) {
    ox = gx[row];
    oy = gy[row];
    oz = gz[row];
    oid = gi[row];
  }
  T ax = T(0), ay = T(0), az = T(0);

  for (int s = 0; s < kBlocks; ++s) {
    T shx, shy, shz;
    const int wx = wrap_dim(cx + kHalf[s][0], nx, px, &shx);
    const int wy = wrap_dim(cy + kHalf[s][1], ny, py, &shy);
    const int wz = wrap_dim(cz + kHalf[s][2], nz, pz, &shz);
    const int nbase = ((wx * ny + wy) * nz + wz) * cc;
    __syncthreads();  // the previous block's stage and reactions are read
    if (cell_live) {
      for (int j = lane; j < cc; j += blockDim.x) {
        stage[j] = gx[nbase + j] + shx;
        stage[cc + j] = gy[nbase + j] + shy;
        stage[2 * cc + j] = gz[nbase + j] + shz;
        const T id = gi[nbase + j];
        stage[3 * cc + j] = (s == 0) ? id : (id >= T(0) ? id + idcap : T(-1));
        if (React) {
          react[j] = T(0);
          react[cc + j] = T(0);
          react[2 * cc + j] = T(0);
        }
      }
    }
    __syncthreads();
    if (row_live) {
      int j = lane;
      for (int k = 0; k < cc; ++k, ++j) {
        if (j == cc) j = 0;
        const T dx = ox - stage[j];
        const T dy = oy - stage[cc + j];
        const T dz = oz - stage[2 * cc + j];
        const T r2 = Rn<T>::add(Rn<T>::add(Rn<T>::mul(dx, dx),
                                           Rn<T>::mul(dy, dy)),
                                Rn<T>::mul(dz, dz));
        if (oid < stage[3 * cc + j] && r2 < cutsq) {
          const T r2inv = T(1) / r2;
          const T r6inv = r2inv * r2inv * r2inv;
          const T fpair = r6inv * (lj1 * r6inv - lj2) * r2inv;
          const T fxij = dx * fpair, fyij = dy * fpair, fzij = dz * fpair;
          ax += fxij;
          ay += fyij;
          az += fzij;
          if (React) {
            atomicAdd(&react[j], -fxij);
            atomicAdd(&react[cc + j], -fyij);
            atomicAdd(&react[2 * cc + j], -fzij);
          }
        }
      }
    }
    if (React) {
      __syncthreads();  // every reaction of block s is in react[]
      if (s == 0) {
        if (row_live) {
          ax += react[lane];
          ay += react[cc + lane];
          az += react[2 * cc + lane];
        }
      } else if (cell_live) {
        T* out = rbuf + (size_t(cell) * (kBlocks - 1) + (s - 1)) * 3 * cc;
        for (int j = lane; j < cc; j += blockDim.x) {
          out[j] = react[j];
          out[cc + j] = react[cc + j];
          out[2 * cc + j] = react[2 * cc + j];
        }
      }
    }
  }
  if (row_live) {
    fx[row] = ax;
    fy[row] = ay;
    fz[row] = az;
  }
}

template <typename T, bool React>
int launch(const void* gx, const void* gy, const void* gz, const void* gi,
           const void* prd, void* fx, void* fy, void* fz, void* rbuf, int nx,
           int ny, int nz, int cc, double idcap, double lj1, double lj2,
           double cutsq, void* stream) {
  const cell_stencil::Launch L = cell_stencil::launch_shape(nx * ny * nz, cc);
  const size_t smem = size_t(React ? 7 : 4) * L.block.y * cc * sizeof(T);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  lj_plane_half_kernel<T, React><<<L.grid, L.block, smem, st>>>(
      static_cast<const T*>(gx), static_cast<const T*>(gy),
      static_cast<const T*>(gz), static_cast<const T*>(gi),
      static_cast<const T*>(prd), static_cast<T*>(fx), static_cast<T*>(fy),
      static_cast<T*>(fz), static_cast<T*>(rbuf), nx, ny, nz, cc,
      static_cast<T>(idcap), static_cast<T>(lj1), static_cast<T>(lj2),
      static_cast<T>(cutsq));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !React) return static_cast<int>(err);
  cell_stencil::half_fold<T><<<L.grid, L.block, 0, st>>>(
      static_cast<const T*>(rbuf), static_cast<T*>(fx), static_cast<T*>(fy),
      static_cast<T*>(fz), nx, ny, nz, cc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Launch on `stream`, do not
// synchronise; return cudaGetLastError() after the launches (0 = success).
// `rbuf` holds ncells * 13 * 3 * cc values (unused by the _fwd entries).
#define LJ_PLANE_HALF_ENTRY(NAME, T, REACT)                                  \
  extern "C" int NAME(const void* gx, const void* gy, const void* gz,       \
                      const void* gi, const void* prd, void* fx, void* fy,  \
                      void* fz, void* rbuf, int nx, int ny, int nz, int cc, \
                      double idcap, double lj1, double lj2, double cutsq,   \
                      void* stream) {                                       \
    return launch<T, REACT>(gx, gy, gz, gi, prd, fx, fy, fz, rbuf, nx, ny,  \
                            nz, cc, idcap, lj1, lj2, cutsq, stream);        \
  }

LJ_PLANE_HALF_ENTRY(lj_plane_half_f32, float, true)
LJ_PLANE_HALF_ENTRY(lj_plane_half_f64, double, true)
LJ_PLANE_HALF_ENTRY(lj_plane_half_fwd_f32, float, false)
LJ_PLANE_HALF_ENTRY(lj_plane_half_fwd_f64, double, false)
