// The two dense-EAM cell sweeps over the sorted cell-major grid, for
// Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package's sorted EAM path
// (lammps_kokkos_port_tpu/ops/pallas_eam.py) and the glue between them:
//   K4 rho_pallas    (kernel _rho_kernel :104-138, pallas_call :200):
//      rho_i = sum_j g(u_ij), u = r^2;
//   the fp glue of compute_force_sorted (:253-260), which XLA fused into
//      one op: fp_i = F'(rho_i), here the rho kernel's epilogue;
//   K5 force_pallas  (kernel _force_kernel :141-190, pallas_call :219):
//      f_i = sum_j dx_ij * fpair, fpair = -((fp_i + fp_j) a(u) + b(u)).
// g, a and b are Chebyshev series in u over [u_lo, u_hi] (ops/eamdense),
// evaluated by Clenshaw as _clenshaw_static (:36-44) on the clamped u =
// clip(r^2, u_lo, u_hi) of _pair_u (:100); F'(rho) = Fp_s(s) / (2 s) with
// s = sqrt(clip(rho, rho_lo, rho_hi)) and Fp_s a series over [s_lo, s_hi]
// (ops/eamdense.embedding_fp).
//
// What bounds them on this card: issue slots and latency in the pair body,
// not bytes (at the eam-32k grid the rho sweep's bound is 0.001 ms of
// operations, the force sweep's 0.002). A pair inside the cutoff costs one
// Clenshaw series of 29 terms in the rho sweep and two of 28 in the force
// sweep, about 6-10x the lj body. The first design (cell_stencil.cuh's
// sweep: one thread per row walking all 27 * cc candidate slots, pads
// included, the body inside the candidate loop) paid the body wherever any
// lane of a warp was inside the cutoff: about 340 bodies per row where
// each row needs about 42 at the eam-32k grid.
//
// Design: both sweeps run the walk of cell_walk.cuh on the sorted layout
// (sorted_grid.cuh), as lj_cell_force.cu does: one warp per cell, the
// neighbour blocks copied with cp.async a batch ahead, only live
// candidates within the cutoff of the warp's own rows' bounding box
// staged, r2 masks in pass 1 and the series only over each lane's own
// in-cutoff list in pass 2. The rho sweep stages three planes and runs
// two pairs an iteration in f32 (two independent Clenshaw chains), one in
// f64 (fewer registers: faster there); its epilogue,
// one lane per row on the rho it has just summed, evaluates fp = F'(rho)
// (80 terms) and writes both, where the row is valid (a byte mask from
// the state, not the pad-position test, which the walk drops when the pad
// premise fails); invalid rows get fp = 0. The force sweep stages packed
// (x, y, z, fp) records (one 16-byte shared load in f32) and runs the a
// and b series side by side in each body, one pair an iteration (the two
// series are its two chains). The full 27-cell stencil (K4/K5 are
// Newton-halved and add reactions into other columns without atomics, safe
// only on the in-order TPU grid): one write per row, deterministic.
// The self pair is masked by its packed position, pads by position
// (sorted_grid.cuh, conditions (a)-(c)), so the JAX kernels' id channel
// and idcap bias are gone.
//
// Coefficients: Pallas bakes them into the kernel as static tuples. Here
// they arrive by value in a small struct of kernel parameters, cast to T
// on the host side of the launch. The struct is a __grid_constant__
// parameter, so the bodies read it in place (no local copy) and each
// coefficient is a constant-bank operand of the recurrence: no table
// lookup per pair.
//
// r2 is bit-identical to the plain PyTorch versions' (the same rounded
// operations), so kernel and twin make the same cutoff decisions; the
// series and the sums differ only in rounding and order.

#include "sorted_grid.cuh"

namespace {

using cell_walk::Cand;

constexpr int NG = 29;   // g: degree 28
constexpr int NAB = 28;  // a, b: derivative series of degree-28 fits
constexpr int NFP = 80;  // Fp_s: derivative series of the degree-80 F fit

// x clamped to [lo, hi], mapped to t in [-1, 1]: t = (2x - shift) * scale
template <typename T> struct Domain {
  T lo, hi, shift, scale;
};

template <typename T> struct RhoParams {
  T g[NG];
  T fp[NFP];
  Domain<T> u;  // r2 -> the g series
  Domain<T> s;  // sqrt(clamped rho) -> the Fp_s series (no clamp needed)
  T rho_lo, rho_hi, cutsq;
};
static_assert(sizeof(RhoParams<double>) <= 1024,
              "the rho sweep's coefficients stay under 1 KB of the 4 KB of "
              "kernel parameters");

template <typename T> struct ForceParams {
  T a[NAB];
  T b[NAB];
  Domain<T> u;
  T cutsq;
};

template <typename T>
__device__ __forceinline__ T cheb_arg(T x, const Domain<T>& d) {
  const T c = x < d.lo ? d.lo : (x > d.hi ? d.hi : x);
  return (T(2) * c - d.shift) * d.scale;
}

// sum_k c[k] T_k(t) by Clenshaw, as _clenshaw_static
template <int N, typename T>
__device__ __forceinline__ T clenshaw(const T (&c)[N], T t) {
  const T t2 = t + t;
  T b1 = T(0), b2 = T(0);
#pragma unroll
  for (int k = N - 1; k >= 1; --k) {
    const T b0 = t2 * b1 - b2 + c[k];
    b2 = b1;
    b1 = b0;
  }
  return t * b1 - b2 + c[0];
}

// the rho body: g(u), one accumulator; pass 2 takes two pairs an
// iteration in f32 (two independent Clenshaw chains) and one in f64, the
// faster of the two in each type (PERF.md section 6)
template <typename T> struct RhoBody {
  static constexpr int kAcc = 1;
  static constexpr int kPairs = sizeof(T) == 4 ? 2 : 1;
  const RhoParams<T>* p;
  __device__ T term(const Cand<T>&, const Cand<T>&, T r2) const {
    return clenshaw(p->g, cheb_arg(r2, p->u));
  }
  static __device__ T part(const T (&)[3], T g, int) { return g; }
};

// the force body: fpair from the a and b series side by side (two
// independent recurrences) and both rows' fp (the records' w); one pair an
// iteration of pass 2: two took 168 / 118 registers (f64 / f32) against
// 72 / 56, with a spill in f64, and were slower or level (PERF.md
// section 6)
template <typename T> struct ForceBody {
  static constexpr int kAcc = 3;
  static constexpr int kPairs = 1;
  const ForceParams<T>* p;
  __device__ T term(const Cand<T>& own, const Cand<T>& c, T r2) const {
    const T t = cheb_arg(r2, p->u);
    const T t2 = t + t;
    T a1 = T(0), a2 = T(0), b1 = T(0), b2 = T(0);
#pragma unroll
    for (int k = NAB - 1; k >= 1; --k) {
      const T a0 = t2 * a1 - a2 + p->a[k];
      const T b0 = t2 * b1 - b2 + p->b[k];
      a2 = a1;
      a1 = a0;
      b2 = b1;
      b1 = b0;
    }
    const T a = t * a1 - a2 + p->a[0];
    const T b = t * b1 - b2 + p->b[0];
    return -((own.w + c.w) * a + b);
  }
  static __device__ T part(const T (&d)[3], T fpair, int a) {
    return d[a] * fpair;
  }
};

// F'(rho) through the embedding fit in s = sqrt(rho), as embedding_fp
template <typename T>
__device__ __forceinline__ T embed_fp(T rho, const RhoParams<T>& p) {
  const T r = rho < p.rho_lo ? p.rho_lo : (rho > p.rho_hi ? p.rho_hi : rho);
  const T s = sqrt(r);
  return clenshaw(p.fp, (T(2) * s - p.s.shift) * p.s.scale) / (T(2) * s);
}

template <typename T>
__global__ void CELL_WALK_BOUNDS eam_cell_rho_kernel(
    const T* __restrict__ gx, const T* __restrict__ gy,
    const T* __restrict__ gz, const T* __restrict__ prd,
    const unsigned char* __restrict__ valid, T* __restrict__ rho,
    T* __restrict__ fp, int nx, int ny, int nz, int cc,
    const __grid_constant__ RhoParams<T> p) {
  sorted_grid::walk_rows<T, 3>(
      {gx, gy, gz, nullptr}, prd, nx, ny, nz, cc, p.cutsq, RhoBody<T>{&p},
      [&](int row, const T (&acc)[1]) {
        rho[row] = acc[0];
        if (fp != nullptr) fp[row] = valid[row] ? embed_fp(acc[0], p) : T(0);
      });
}

template <typename T>
__global__ void CELL_WALK_BOUNDS eam_cell_force_kernel(
    const T* __restrict__ gx, const T* __restrict__ gy,
    const T* __restrict__ gz, const T* __restrict__ gfp,
    const T* __restrict__ prd, T* __restrict__ fx, T* __restrict__ fy,
    T* __restrict__ fz, int nx, int ny, int nz, int cc,
    const __grid_constant__ ForceParams<T> p) {
  sorted_grid::walk_rows<T, 4>(
      {gx, gy, gz, gfp}, prd, nx, ny, nz, cc, p.cutsq, ForceBody<T>{&p},
      [=](int row, const T (&acc)[3]) {
        fx[row] = acc[0];
        fy[row] = acc[1];
        fz[row] = acc[2];
      });
}

template <typename T>
Domain<T> domain(double lo, double hi) {
  // the same constants _clenshaw_static derives in Python floats
  return {static_cast<T>(lo), static_cast<T>(hi), static_cast<T>(lo + hi),
          static_cast<T>(1.0 / (hi - lo))};
}

template <typename T>
int launch_rho(const void* gx, const void* gy, const void* gz,
               const void* prd, const void* valid, void* rho, void* fp,
               int nx, int ny, int nz, int cc, const double* g, double u_lo,
               double u_hi, double cutsq, const double* fpc, double rho_lo,
               double rho_hi, double s_lo, double s_hi, void* stream) {
  RhoParams<T> p = {};
  for (int k = 0; k < NG; ++k) p.g[k] = static_cast<T>(g[k]);
  if (fp != nullptr)
    for (int k = 0; k < NFP; ++k) p.fp[k] = static_cast<T>(fpc[k]);
  p.u = domain<T>(u_lo, u_hi);
  p.s = domain<T>(s_lo, s_hi);
  p.rho_lo = static_cast<T>(rho_lo);
  p.rho_hi = static_cast<T>(rho_hi);
  p.cutsq = static_cast<T>(cutsq);
  const cell_walk::Launch L =
      cell_walk::launch_shape<T, sorted_grid::SortedGrid<T, 3>>(nx * ny *
                                                                nz);
  eam_cell_rho_kernel<T><<<L.grid, L.block, L.smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gx), static_cast<const T*>(gy),
      static_cast<const T*>(gz), static_cast<const T*>(prd),
      static_cast<const unsigned char*>(valid), static_cast<T*>(rho),
      static_cast<T*>(fp), nx, ny, nz, cc, p);
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
  p.u = domain<T>(u_lo, u_hi);
  p.cutsq = static_cast<T>(cutsq);
  const cell_walk::Launch L =
      cell_walk::launch_shape<T, sorted_grid::SortedGrid<T, 4>>(nx * ny *
                                                                nz);
  eam_cell_force_kernel<T><<<L.grid, L.block, L.smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gx), static_cast<const T*>(gy),
      static_cast<const T*>(gz), static_cast<const T*>(gfp),
      static_cast<const T*>(prd), static_cast<T*>(fx), static_cast<T*>(fy),
      static_cast<T*>(fz), nx, ny, nz, cc, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Coefficient arrays are host
// doubles: g has 29 values, fpc 80, a and b 28 each. Launch on `stream`,
// do not synchronise; return cudaGetLastError() after the launch (0 =
// success).
//
// The rho sweep writes rho and, where `fp` is not null, fp = F'(rho) on
// the rows whose `valid` byte is set (0 elsewhere); with fp null, `valid`
// and `fpc` are not read.
extern "C" int eam_cell_rho_f32(const void* gx, const void* gy,
                                const void* gz, const void* prd,
                                const void* valid, void* rho, void* fp,
                                int nx, int ny, int nz, int cc,
                                const double* g, double u_lo, double u_hi,
                                double cutsq, const double* fpc,
                                double rho_lo, double rho_hi, double s_lo,
                                double s_hi, void* stream) {
  return launch_rho<float>(gx, gy, gz, prd, valid, rho, fp, nx, ny, nz, cc,
                           g, u_lo, u_hi, cutsq, fpc, rho_lo, rho_hi, s_lo,
                           s_hi, stream);
}

extern "C" int eam_cell_rho_f64(const void* gx, const void* gy,
                                const void* gz, const void* prd,
                                const void* valid, void* rho, void* fp,
                                int nx, int ny, int nz, int cc,
                                const double* g, double u_lo, double u_hi,
                                double cutsq, const double* fpc,
                                double rho_lo, double rho_hi, double s_lo,
                                double s_hi, void* stream) {
  return launch_rho<double>(gx, gy, gz, prd, valid, rho, fp, nx, ny, nz, cc,
                            g, u_lo, u_hi, cutsq, fpc, rho_lo, rho_hi, s_lo,
                            s_hi, stream);
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

// The launches the two sweeps make on `ncell` cells: out[0] blocks, out[1]
// x out[2] threads per block, out[3] dynamic shared memory bytes.
extern "C" int eam_cell_rho_shape(int ncell, int f64, int* out) {
  return cell_walk::report_shape<sorted_grid::SortedGrid<float, 3>,
                                 sorted_grid::SortedGrid<double, 3>>(
      ncell, f64, out);
}

extern "C" int eam_cell_force_shape(int ncell, int f64, int* out) {
  return cell_walk::report_shape<sorted_grid::SortedGrid<float, 4>,
                                 sorted_grid::SortedGrid<double, 4>>(
      ncell, f64, out);
}
