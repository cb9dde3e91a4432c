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
// Design: one thread per bucket lane (cell c, lane a), blockDim.x = cc
// rounded up to a warp, blockDim.y cells per block. For each of the 27
// stencil entries the block stages that cell's atom indices and positions
// in shared memory; every thread of a cell then reads the same address (a
// broadcast) as it walks the cc candidates. Masks are by index, as K6's id
// masks are: an empty lane, the self pair (candidate index == own index)
// and the dead cell never contribute. No position sentinel is needed, so
// the minimum image cannot wrap a sentinel back into the box. Each atom
// sits in exactly one bucket, so its thread writes f[atom] once: no
// atomics, deterministic; atoms in no bucket keep the wrapper's zeros, as
// the JAX scatter's mode="drop" leaves them.
//
// Cost: 27*cc candidate pairs per lane (the full stencil, as K6), bound by
// pair arithmetic; the gathers of candidate positions by atom index are
// 27*cc*3 loads per cell, shared by the cell's cc threads.
//
// The minimum image d - prd*rint(d*(1/prd)) and r2 are formed with
// explicitly rounded multiplies and adds (no fused multiply-add), rint
// rounds half to even as jnp.round / torch.round do, and 1/prd and 1/r2
// are IEEE divides: the cutoff decisions are bit-identical to the plain
// PyTorch version's; only the order of the force sums differs.

#include "cell_stencil.cuh"

namespace {

using cell_stencil::Rn;

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

template <typename T>
__global__ void lj_cell_dense_kernel(
    const int* __restrict__ buckets, const int* __restrict__ stencil,
    const T* __restrict__ x, const T* __restrict__ prd, T* __restrict__ f,
    int ntot, int cc, int cap, T lj1, T lj2, T cutsq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // per cell row of the block: 3*cc positions, then (after all rows) cc
  // atom indices
  T* sx = reinterpret_cast<T*>(smem_raw) + threadIdx.y * 3 * cc;
  int* sidx = reinterpret_cast<int*>(reinterpret_cast<T*>(smem_raw) +
                                     blockDim.y * 3 * cc) +
              threadIdx.y * cc;

  const int cell = blockIdx.x * blockDim.y + threadIdx.y;
  const bool cell_live = cell < ntot;
  const int lane = threadIdx.x;
  const int me = (cell_live && lane < cc) ? buckets[cell * cc + lane] : cap;
  const bool live = me < cap;

  const T px = prd[0], py = prd[1], pz = prd[2];
  const T ix = T(1) / px, iy = T(1) / py, iz = T(1) / pz;
  T ox = T(0), oy = T(0), oz = T(0);
  if (live) {
    ox = x[3 * me];
    oy = x[3 * me + 1];
    oz = x[3 * me + 2];
  }
  T ax = T(0), ay = T(0), az = T(0);

  for (int s = 0; s < 27; ++s) {
    const int nc = cell_live ? stencil[cell * 27 + s] : ntot;
    const bool dead = nc >= ntot;  // the same for every thread of a cell
    __syncthreads();  // the previous stencil cell has been read
    if (!dead) {
      for (int j = lane; j < cc; j += blockDim.x) {
        const int idx = buckets[nc * cc + j];
        sidx[j] = idx;
        if (idx < cap) {
          sx[j] = x[3 * idx];
          sx[cc + j] = x[3 * idx + 1];
          sx[2 * cc + j] = x[3 * idx + 2];
        }
      }
    }
    __syncthreads();
    if (live && !dead) {
      for (int j = 0; j < cc; ++j) {
        const int idx = sidx[j];
        if (idx >= cap || idx == me) continue;
        const T dx = min_image(ox - sx[j], px, ix);
        const T dy = min_image(oy - sx[cc + j], py, iy);
        const T dz = min_image(oz - sx[2 * cc + j], pz, iz);
        const T r2 = Rn<T>::add(Rn<T>::add(Rn<T>::mul(dx, dx),
                                           Rn<T>::mul(dy, dy)),
                                Rn<T>::mul(dz, dz));
        if (r2 < cutsq) {
          const T r2inv = T(1) / r2;
          const T r6inv = r2inv * r2inv * r2inv;
          const T fpair = r6inv * (lj1 * r6inv - lj2) * r2inv;
          ax += dx * fpair;
          ay += dy * fpair;
          az += dz * fpair;
        }
      }
    }
  }
  if (live) {
    f[3 * me] = ax;
    f[3 * me + 1] = ay;
    f[3 * me + 2] = az;
  }
}

template <typename T>
int launch(const void* buckets, const void* stencil, const void* x,
           const void* prd, void* f, int ntot, int cc, int cap, double lj1,
           double lj2, double cutsq, void* stream) {
  const cell_stencil::Launch L = cell_stencil::launch_shape(ntot, cc);
  const size_t smem = size_t(L.block.y) * cc * (3 * sizeof(T) + sizeof(int));
  lj_cell_dense_kernel<T><<<L.grid, L.block, smem,
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
