// lj/cut force-only pass over the cell-major grid, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of the JAX package's sorted path,
// which compute the same forces and differ only in how they tile TPU VMEM:
//   K1 column_half_force_pallas  lammps_kokkos_port_tpu/ops/pallas_pair.py:319
//      (kernel _column_half_kernel :215-315, pallas_call :331)
//   K2 slab_half_force_pallas    pallas_pair.py:659
//      (kernel _slab_half_kernel :532-629, pallas_call :645)
//   K3 plane_force_pallas        pallas_pair.py:811
//      (kernel _slab_kernel :728-787, pallas_call :799)
//
// Layout: positions gx, gy, gz are [ncells, cc] rows, cell id
// (cx*ny + cy)*nz + cz; padding rows hold distinct far-away sentinels
// (ops/sortedforce.PAD_POS), so they fail the cutoff by distance and need
// no validity lanes.
//
// Design: the full 27-cell stencil with no Newton halving, as K3 does. One
// thread owns one row and writes its sum once, so the result is
// deterministic and needs no atomics. K1/K2 add reactions into other
// columns without atomics, which is safe only because the TPU grid runs
// sequentially; CUDA blocks run concurrently, so a literal port would race.
// A block holds `cpb` cells (blockDim.y) of `lanes` threads (blockDim.x,
// cc rounded up to a warp). For each of the 27 neighbour offsets the block
// stages each cell's neighbour block, shifted by +-prd where it wraps across
// the box (no minimum image), in shared memory; every thread of a cell then
// reads the same address (a broadcast) as it walks the cc candidates.
//
// Cost: 27*cc candidate pairs per row, about 2x the pair count of the
// Newton-halved K1 (14 blocks, half of them masked in the self block), so
// on this card the kernel is bound by pair arithmetic, not by memory: each
// row reads 27*cc*3 values from shared memory and its own 3 values from
// device memory. The Newton-half variant (atomics or a colouring of the
// cells) is left to a later performance change.
//
// r2 is formed with explicitly rounded multiplies and adds (no fused
// multiply-add), so it is bit-identical to the plain PyTorch version and
// both make the same cutoff decisions; only the order of the force sums
// differs. 1/r2 is an exact IEEE divide (nvcc's default -prec-div=true).

#include <cuda_runtime.h>

namespace {

template <typename T> struct Rn;

template <> struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
};

template <> struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
};

// wrapped neighbour index along one dim and the shift to apply to it
template <typename T>
__device__ __forceinline__ int wrap_dim(int c, int n, T prd, T* shift) {
  if (c < 0) {
    *shift = -prd;
    return c + n;
  }
  if (c >= n) {
    *shift = prd;
    return c - n;
  }
  *shift = T(0);
  return c;
}

template <typename T>
__global__ void lj_cell_force_kernel(
    const T* __restrict__ gx, const T* __restrict__ gy,
    const T* __restrict__ gz, const T* __restrict__ prd,
    T* __restrict__ fx, T* __restrict__ fy, T* __restrict__ fz,
    int nx, int ny, int nz, int cc, T lj1, T lj2, T cutsq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage = reinterpret_cast<T*>(smem_raw) + threadIdx.y * 3 * cc;
  T* sx = stage;
  T* sy = stage + cc;
  T* sz = stage + 2 * cc;

  const int ncell = nx * ny * nz;
  const int cell = blockIdx.x * blockDim.y + threadIdx.y;
  const bool cell_live = cell < ncell;
  const int lane = threadIdx.x;
  const bool row_live = cell_live && lane < cc;

  int cx = 0, cy = 0, cz = 0;
  if (cell_live) {
    cz = cell % nz;
    const int t = cell / nz;
    cy = t % ny;
    cx = t / ny;
  }
  const T px = prd[0], py = prd[1], pz = prd[2];
  const int row = cell * cc + lane;
  T xi = T(0), yi = T(0), zi = T(0);
  if (row_live) {
    xi = gx[row];
    yi = gy[row];
    zi = gz[row];
  }
  T ax = T(0), ay = T(0), az = T(0);

  for (int ox = -1; ox <= 1; ++ox) {
    T shx;
    const int wx = wrap_dim(cx + ox, nx, px, &shx);
    for (int oy = -1; oy <= 1; ++oy) {
      T shy;
      const int wy = wrap_dim(cy + oy, ny, py, &shy);
      for (int oz = -1; oz <= 1; ++oz) {
        T shz;
        const int wz = wrap_dim(cz + oz, nz, pz, &shz);
        const int nbase = ((wx * ny + wy) * nz + wz) * cc;
        __syncthreads();  // the previous neighbour block has been read
        if (cell_live) {
          for (int j = lane; j < cc; j += blockDim.x) {
            sx[j] = gx[nbase + j] + shx;
            sy[j] = gy[nbase + j] + shy;
            sz[j] = gz[nbase + j] + shz;
          }
        }
        __syncthreads();
        if (row_live) {
          // the self pair sits in the own cell at the own lane
          const int self_lane = (ox == 0 && oy == 0 && oz == 0) ? lane : -1;
          for (int j = 0; j < cc; ++j) {
            const T dx = xi - sx[j];
            const T dy = yi - sy[j];
            const T dz = zi - sz[j];
            const T r2 = Rn<T>::add(Rn<T>::add(Rn<T>::mul(dx, dx),
                                               Rn<T>::mul(dy, dy)),
                                    Rn<T>::mul(dz, dz));
            if (r2 < cutsq && j != self_lane) {
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
    }
  }
  if (row_live) {
    fx[row] = ax;
    fy[row] = ay;
    fz[row] = az;
  }
}

template <typename T>
int launch(const void* gx, const void* gy, const void* gz, const void* prd,
           void* fx, void* fy, void* fz, int nx, int ny, int nz, int cc,
           double lj1, double lj2, double cutsq, void* stream) {
  const int lanes = ((cc + 31) / 32) * 32;
  const int cpb = lanes >= 128 ? 1 : 128 / lanes;
  const int ncell = nx * ny * nz;
  const dim3 block(lanes, cpb);
  const dim3 grid((ncell + cpb - 1) / cpb);
  const size_t smem = size_t(3) * cpb * cc * sizeof(T);
  lj_cell_force_kernel<T><<<grid, block, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gx), static_cast<const T*>(gy),
      static_cast<const T*>(gz), static_cast<const T*>(prd),
      static_cast<T*>(fx), static_cast<T*>(fy), static_cast<T*>(fz), nx, ny,
      nz, cc, static_cast<T>(lj1), static_cast<T>(lj2),
      static_cast<T>(cutsq));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Launch on `stream`, do not
// synchronise; return cudaGetLastError() after the launch (0 = success).
extern "C" int lj_cell_force_f32(const void* gx, const void* gy,
                                 const void* gz, const void* prd, void* fx,
                                 void* fy, void* fz, int nx, int ny, int nz,
                                 int cc, double lj1, double lj2, double cutsq,
                                 void* stream) {
  return launch<float>(gx, gy, gz, prd, fx, fy, fz, nx, ny, nz, cc, lj1, lj2,
                       cutsq, stream);
}

extern "C" int lj_cell_force_f64(const void* gx, const void* gy,
                                 const void* gz, const void* prd, void* fx,
                                 void* fy, void* fz, int nx, int ny, int nz,
                                 int cc, double lj1, double lj2, double cutsq,
                                 void* stream) {
  return launch<double>(gx, gy, gz, prd, fx, fy, fz, nx, ny, nz, cc, lj1, lj2,
                        cutsq, stream);
}
