// The two dense-EAM cell sweeps over the cell-major grid, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package's sorted EAM path
// (lammps_kokkos_port_tpu/ops/pallas_eam.py):
//   K4 rho_pallas    (kernel _rho_kernel :104-138, pallas_call :200):
//      rho_i = sum_j g(u_ij), u = r^2
//   K5 force_pallas  (kernel _force_kernel :141-190, pallas_call :219):
//      f_i = sum_j dx_ij * fpair, fpair = -((fp_i + fp_j) a(u) + b(u))
// g, a and b are Chebyshev series in u over [u_lo, u_hi] (ops/eamdense),
// evaluated by Clenshaw exactly as _clenshaw_static (:36-44), on the
// clamped u = clip(r^2, u_lo, u_hi) of _pair_u (:100). fp = F'(rho) is
// computed between the two sweeps in plain PyTorch and staged here as a
// fourth channel beside x, y, z.
//
// Design (the stencil walk of cell_stencil.cuh): K4/K5 are Newton-halved
// and add reactions into other columns without atomics, which is safe only
// because the TPU grid runs in order. CUDA blocks run concurrently, so both
// sweeps take the full 27-cell stencil instead: one thread per row, one
// write per row, no atomics, deterministic. The self pair is excluded by
// lane index in the own cell and padding rows by distance (their position
// sentinels), so the JAX kernels' id channel and idcap bias are gone.
//
// Coefficients: Pallas bakes them into the kernel as static tuples. Here
// they arrive by value in a small struct of kernel parameters (85 values,
// 680 bytes in f64, far under the 4 KB limit), cast to T once on the host
// side of the launch. The struct is a __grid_constant__ parameter, so the
// sweep's callback reads it in place (no local copy) and each coefficient
// is a constant-bank operand of the Clenshaw recurrence: no table lookup
// per pair.
//
// Cost: 27*cc candidates per row, about 2x the pair count of the
// Newton-halved K4/K5. A pair inside the cutoff costs one Clenshaw series
// of 29 terms in the rho sweep and two of 28 in the force sweep (about 60
// and 115 FMA-class operations); with a warp's 32 rows facing the same
// candidate, a candidate inside the cutoff of any of them costs the whole
// warp. Each row reads its own 3 (or 4) values from device memory and
// 27*cc*3 (or *4) values from shared memory, so both sweeps are bound by
// pair arithmetic, not by memory. Newton halving and fusing fp into the
// rho sweep's epilogue are left to later performance changes.
//
// r2 is bit-identical to the plain PyTorch versions' (cell_stencil.cuh),
// so kernel and twin make the same cutoff decisions; the series and the
// sums differ only in rounding and order.

#include "cell_stencil.cuh"

namespace {

constexpr int NG = 29;   // g: degree 28
constexpr int NAB = 28;  // a, b: derivative series of degree-28 fits

// the affine map u -> t in [-1, 1] of the Chebyshev fits, and the cutoff
template <typename T> struct Domain {
  T u_lo, u_hi, shift, scale, cutsq;  // t = (2u - shift) * scale
};

template <typename T> struct RhoParams {
  T g[NG];
  Domain<T> d;
};

template <typename T> struct ForceParams {
  T a[NAB];
  T b[NAB];
  Domain<T> d;
};

template <typename T>
__device__ __forceinline__ T cheb_arg(T r2, const Domain<T>& d) {
  const T u = r2 < d.u_lo ? d.u_lo : (r2 > d.u_hi ? d.u_hi : r2);
  return (T(2) * u - d.shift) * d.scale;
}

template <typename T>
__global__ void eam_cell_rho_kernel(
    const T* __restrict__ gx, const T* __restrict__ gy,
    const T* __restrict__ gz, const T* __restrict__ prd,
    T* __restrict__ rho, int nx, int ny, int nz, int cc,
    const __grid_constant__ RhoParams<T> p) {
  T own[3];
  T acc = T(0);
  const cell_stencil::Row me = cell_stencil::sweep<T, 3>(
      {{gx, gy, gz}}, prd, nx, ny, nz, cc, p.d.cutsq, own,
      [&acc, &p](T, T, T, T r2, const T*, int) {
        const T t = cheb_arg(r2, p.d);
        const T t2 = t + t;
        T b1 = T(0), b2 = T(0);
#pragma unroll
        for (int k = NG - 1; k >= 1; --k) {
          const T b0 = t2 * b1 - b2 + p.g[k];
          b2 = b1;
          b1 = b0;
        }
        acc += t * b1 - b2 + p.g[0];
      });
  if (me.row_live) rho[me.row] = acc;
}

template <typename T>
__global__ void eam_cell_force_kernel(
    const T* __restrict__ gx, const T* __restrict__ gy,
    const T* __restrict__ gz, const T* __restrict__ gfp,
    const T* __restrict__ prd, T* __restrict__ fx, T* __restrict__ fy,
    T* __restrict__ fz, int nx, int ny, int nz, int cc,
    const __grid_constant__ ForceParams<T> p) {
  T own[4] = {};  // filled by sweep() before the first pair
  T ax = T(0), ay = T(0), az = T(0);
  const cell_stencil::Row me = cell_stencil::sweep<T, 4>(
      {{gx, gy, gz, gfp}}, prd, nx, ny, nz, cc, p.d.cutsq, own,
      [&ax, &ay, &az, &own, &p, cc](T dx, T dy, T dz, T r2, const T* stage,
                                    int j) {
        const T t = cheb_arg(r2, p.d);
        const T t2 = t + t;
        // the a and b series side by side: two independent recurrences
        T a1 = T(0), a2 = T(0), b1 = T(0), b2 = T(0);
#pragma unroll
        for (int k = NAB - 1; k >= 1; --k) {
          const T a0 = t2 * a1 - a2 + p.a[k];
          const T b0 = t2 * b1 - b2 + p.b[k];
          a2 = a1;
          a1 = a0;
          b2 = b1;
          b1 = b0;
        }
        const T a = t * a1 - a2 + p.a[0];
        const T b = t * b1 - b2 + p.b[0];
        const T fpair = -((own[3] + stage[3 * cc + j]) * a + b);
        ax += dx * fpair;
        ay += dy * fpair;
        az += dz * fpair;
      });
  if (me.row_live) {
    fx[me.row] = ax;
    fy[me.row] = ay;
    fz[me.row] = az;
  }
}

template <typename T>
Domain<T> domain(double u_lo, double u_hi, double cutsq) {
  // the same constants _clenshaw_static derives in Python floats
  return {static_cast<T>(u_lo), static_cast<T>(u_hi),
          static_cast<T>(u_lo + u_hi), static_cast<T>(1.0 / (u_hi - u_lo)),
          static_cast<T>(cutsq)};
}

template <typename T>
int launch_rho(const void* gx, const void* gy, const void* gz,
               const void* prd, void* rho, int nx, int ny, int nz, int cc,
               const double* g, double u_lo, double u_hi, double cutsq,
               void* stream) {
  RhoParams<T> p;
  for (int k = 0; k < NG; ++k) p.g[k] = static_cast<T>(g[k]);
  p.d = domain<T>(u_lo, u_hi, cutsq);
  const cell_stencil::Launch L = cell_stencil::launch_shape(nx * ny * nz, cc);
  const size_t smem = size_t(3) * L.block.y * cc * sizeof(T);
  eam_cell_rho_kernel<T><<<L.grid, L.block, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gx), static_cast<const T*>(gy),
      static_cast<const T*>(gz), static_cast<const T*>(prd),
      static_cast<T*>(rho), nx, ny, nz, cc, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_force(const void* gx, const void* gy, const void* gz,
                 const void* gfp, const void* prd, void* fx, void* fy,
                 void* fz, int nx, int ny, int nz, int cc, const double* a,
                 const double* b, double u_lo, double u_hi, double cutsq,
                 void* stream) {
  ForceParams<T> p;
  for (int k = 0; k < NAB; ++k) {
    p.a[k] = static_cast<T>(a[k]);
    p.b[k] = static_cast<T>(b[k]);
  }
  p.d = domain<T>(u_lo, u_hi, cutsq);
  const cell_stencil::Launch L = cell_stencil::launch_shape(nx * ny * nz, cc);
  const size_t smem = size_t(4) * L.block.y * cc * sizeof(T);
  eam_cell_force_kernel<T><<<L.grid, L.block, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gx), static_cast<const T*>(gy),
      static_cast<const T*>(gz), static_cast<const T*>(gfp),
      static_cast<const T*>(prd), static_cast<T*>(fx), static_cast<T*>(fy),
      static_cast<T*>(fz), nx, ny, nz, cc, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Coefficient arrays are host
// doubles: g has 29 values, a and b 28 each. Launch on `stream`, do not
// synchronise; return cudaGetLastError() after the launch (0 = success).
extern "C" int eam_cell_rho_f32(const void* gx, const void* gy,
                                const void* gz, const void* prd, void* rho,
                                int nx, int ny, int nz, int cc,
                                const double* g, double u_lo, double u_hi,
                                double cutsq, void* stream) {
  return launch_rho<float>(gx, gy, gz, prd, rho, nx, ny, nz, cc, g, u_lo,
                           u_hi, cutsq, stream);
}

extern "C" int eam_cell_rho_f64(const void* gx, const void* gy,
                                const void* gz, const void* prd, void* rho,
                                int nx, int ny, int nz, int cc,
                                const double* g, double u_lo, double u_hi,
                                double cutsq, void* stream) {
  return launch_rho<double>(gx, gy, gz, prd, rho, nx, ny, nz, cc, g, u_lo,
                            u_hi, cutsq, stream);
}

extern "C" int eam_cell_force_f32(const void* gx, const void* gy,
                                  const void* gz, const void* gfp,
                                  const void* prd, void* fx, void* fy,
                                  void* fz, int nx, int ny, int nz, int cc,
                                  const double* a, const double* b,
                                  double u_lo, double u_hi, double cutsq,
                                  void* stream) {
  return launch_force<float>(gx, gy, gz, gfp, prd, fx, fy, fz, nx, ny, nz,
                             cc, a, b, u_lo, u_hi, cutsq, stream);
}

extern "C" int eam_cell_force_f64(const void* gx, const void* gy,
                                  const void* gz, const void* gfp,
                                  const void* prd, void* fx, void* fy,
                                  void* fz, int nx, int ny, int nz, int cc,
                                  const double* a, const double* b,
                                  double u_lo, double u_hi, double cutsq,
                                  void* stream) {
  return launch_force<double>(gx, gy, gz, gfp, prd, fx, fy, fz, nx, ny, nz,
                              cc, a, b, u_lo, u_hi, cutsq, stream);
}
