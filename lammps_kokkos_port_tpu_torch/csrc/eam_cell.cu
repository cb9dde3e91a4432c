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
// sweep, about 6-10x the lj body. The first design (a
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
//
// Tally instances (thermo rows: energy and virial; no TPU kernel, the JAX
// package left the energy pass to XLA's grid-roll path, which the port ran
// in plain PyTorch until these): two more instances of the same walks,
// under their own kernel names, so that the step's instances keep their
// registers, their SASS and their names (by-name readers of the step's
// kernels see only the step's calls).
//   eam_cell_rho_tally_kernel: the rho sweep (RhoBody); its epilogue also
//      writes each valid row's embedding energy F(rho) (the 81-term F
//      series in s, extended linearly with slope fp above rho_hi, as
//      ops/eamdense.embedding_energy), 0 on the other rows;
//   eam_cell_force_tally_kernel: the force sweep with the phi series (29
//      terms) as a third chain beside a and b (ForceTallyBody); each row
//      sums seven more values and writes them halved, since the 27-cell
//      stencil sees every pair from both rows: pe_i = e_i + 1/2 sum_j
//      phi(u), and the virial 1/2 sum_j fpair dx_a dx_b (xx, yy, zz, xy,
//      xz, yz), planes of one [7, rows] buffer. The wrapper sums the
//      planes over rows in float64 (no atomics: deterministic).

#include "sorted_grid.cuh"

namespace {

using cell_walk::Cand;

constexpr int NG = 29;   // g: degree 28
constexpr int NAB = 28;  // a, b: derivative series of degree-28 fits
constexpr int NFP = 80;  // Fp_s: derivative series of the degree-80 F fit
constexpr int NF = 81;   // F: the degree-80 embedding fit (tally only)
constexpr int NPHI = 29; // phi: degree 28 (tally only)

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

// the tally instances' constants: the step's, then the energy series
template <typename T> struct RhoTallyParams {
  RhoParams<T> r;
  T F[NF];
};
template <typename T> struct ForceTallyParams {
  ForceParams<T> f;
  T phi[NPHI];
};
static_assert(sizeof(RhoTallyParams<double>) <= 2048,
              "the rho tally's coefficients stay under 2 KB of the 4 KB of "
              "kernel parameters");

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

// a pair's two values in the tally sweep
template <typename T> struct TallyTerm {
  T fpair, phi;
};

// the force tally body: ForceBody's a and b series with phi as a third
// independent chain; acc 0-2 the force, 3 sum phi, 4-9 sum fpair dx_a dx_b
// (xx, yy, zz, xy, xz, yz)
template <typename T> struct ForceTallyBody {
  static constexpr int kAcc = 10;
  static constexpr int kPairs = 1;
  const ForceTallyParams<T>* p;
  __device__ TallyTerm<T> term(const Cand<T>& own, const Cand<T>& c,
                               T r2) const {
    const ForceParams<T>& q = p->f;
    const T t = cheb_arg(r2, q.u);
    const T t2 = t + t;
    static_assert(NPHI == NAB + 1, "phi has one term more than a and b");
    T a1 = T(0), a2 = T(0), b1 = T(0), b2 = T(0);
    T e1 = p->phi[NPHI - 1], e2 = T(0);
#pragma unroll
    for (int k = NAB - 1; k >= 1; --k) {
      const T a0 = t2 * a1 - a2 + q.a[k];
      const T b0 = t2 * b1 - b2 + q.b[k];
      const T e0 = t2 * e1 - e2 + p->phi[k];
      a2 = a1;
      a1 = a0;
      b2 = b1;
      b1 = b0;
      e2 = e1;
      e1 = e0;
    }
    const T a = t * a1 - a2 + q.a[0];
    const T b = t * b1 - b2 + q.b[0];
    return {-((own.w + c.w) * a + b), t * e1 - e2 + p->phi[0]};
  }
  static __device__ T part(const T (&d)[3], const TallyTerm<T>& e, int a) {
    switch (a) {
      case 3: return e.phi;
      case 4: return d[0] * e.fpair * d[0];
      case 5: return d[1] * e.fpair * d[1];
      case 6: return d[2] * e.fpair * d[2];
      case 7: return d[0] * e.fpair * d[1];
      case 8: return d[0] * e.fpair * d[2];
      case 9: return d[1] * e.fpair * d[2];
      default: return d[a] * e.fpair;
    }
  }
};

// F'(rho) through the embedding fit in s = sqrt(rho), as embedding_fp
template <typename T>
__device__ __forceinline__ T embed_fp(T rho, const RhoParams<T>& p) {
  const T r = rho < p.rho_lo ? p.rho_lo : (rho > p.rho_hi ? p.rho_hi : rho);
  const T s = sqrt(r);
  return clenshaw(p.fp, (T(2) * s - p.s.shift) * p.s.scale) / (T(2) * s);
}

// F(rho) through the embedding fit in s = sqrt(rho), extended linearly
// with slope fp above rho_hi, as embedding_energy
template <typename T>
__device__ __forceinline__ T embed_energy(T rho, T fp,
                                          const RhoTallyParams<T>& p) {
  const RhoParams<T>& q = p.r;
  const T r = rho < q.rho_lo ? q.rho_lo : (rho > q.rho_hi ? q.rho_hi : rho);
  const T s = sqrt(r);
  const T e = clenshaw(p.F, (T(2) * s - q.s.shift) * q.s.scale);
  return rho > q.rho_hi ? e + fp * (rho - q.rho_hi) : e;
}

template <typename T>
__global__ void CELL_WALK_BOUNDS eam_cell_rho_kernel(
    const T* __restrict__ gx, const T* __restrict__ gy,
    const T* __restrict__ gz, const T* __restrict__ prd,
    const unsigned char* __restrict__ valid, T* __restrict__ rho,
    T* __restrict__ fp, int nx, int ny, int nz, int cc,
    const __grid_constant__ RhoParams<T> p) {
  sorted_grid::walk_grid<sorted_grid::SortedGrid<T, 3>>(
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
  sorted_grid::walk_grid<sorted_grid::SortedGrid<T, 4>>(
      {gx, gy, gz, gfp}, prd, nx, ny, nz, cc, p.cutsq, ForceBody<T>{&p},
      [=](int row, const T (&acc)[3]) {
        fx[row] = acc[0];
        fy[row] = acc[1];
        fz[row] = acc[2];
      });
}

// the rho sweep with rho, fp and the embedding energy e in its epilogue
// (fp and e 0 where `valid` is not set)
template <typename T>
__global__ void CELL_WALK_BOUNDS eam_cell_rho_tally_kernel(
    const T* __restrict__ gx, const T* __restrict__ gy,
    const T* __restrict__ gz, const T* __restrict__ prd,
    const unsigned char* __restrict__ valid, T* __restrict__ rho,
    T* __restrict__ fp, T* __restrict__ e, int nx, int ny, int nz, int cc,
    const __grid_constant__ RhoTallyParams<T> p) {
  sorted_grid::walk_grid<sorted_grid::SortedGrid<T, 3>>(
      {gx, gy, gz, nullptr}, prd, nx, ny, nz, cc, p.r.cutsq,
      RhoBody<T>{&p.r}, [&](int row, const T (&acc)[1]) {
        rho[row] = acc[0];
        T f = T(0), en = T(0);
        if (valid[row]) {
          f = embed_fp(acc[0], p.r);
          en = embed_energy(acc[0], f, p);
        }
        fp[row] = f;
        e[row] = en;
      });
}

// the force sweep with each row's tallies: tally[k * rows + row], k = 0
// pe (ge + 1/2 sum phi), 1-6 the virial's halves
template <typename T>
__global__ void CELL_WALK_BOUNDS eam_cell_force_tally_kernel(
    const T* __restrict__ gx, const T* __restrict__ gy,
    const T* __restrict__ gz, const T* __restrict__ gfp,
    const T* __restrict__ ge, const T* __restrict__ prd, T* __restrict__ fx,
    T* __restrict__ fy, T* __restrict__ fz, T* __restrict__ tally, int nx,
    int ny, int nz, int cc, const __grid_constant__ ForceTallyParams<T> p) {
  const long long rows = static_cast<long long>(nx) * ny * nz * cc;
  sorted_grid::walk_grid<sorted_grid::SortedGrid<T, 4>>(
      {gx, gy, gz, gfp}, prd, nx, ny, nz, cc, p.f.cutsq,
      ForceTallyBody<T>{&p}, [=](int row, const T (&acc)[10]) {
        fx[row] = acc[0];
        fy[row] = acc[1];
        fz[row] = acc[2];
        tally[row] = ge[row] + T(0.5) * acc[3];
#pragma unroll
        for (int k = 1; k < 7; ++k)
          tally[k * rows + row] = T(0.5) * acc[3 + k];
      });
}

template <typename T>
Domain<T> domain(double lo, double hi) {
  // the same constants _clenshaw_static derives in Python floats
  return {static_cast<T>(lo), static_cast<T>(hi), static_cast<T>(lo + hi),
          static_cast<T>(1.0 / (hi - lo))};
}

// the rho sweep's constants (the Fp_s series only where fpc is not null)
template <typename T>
RhoParams<T> rho_params(const double* g, double u_lo, double u_hi,
                        double cutsq, const double* fpc, double rho_lo,
                        double rho_hi, double s_lo, double s_hi) {
  RhoParams<T> p = {};
  for (int k = 0; k < NG; ++k) p.g[k] = static_cast<T>(g[k]);
  if (fpc != nullptr)
    for (int k = 0; k < NFP; ++k) p.fp[k] = static_cast<T>(fpc[k]);
  p.u = domain<T>(u_lo, u_hi);
  p.s = domain<T>(s_lo, s_hi);
  p.rho_lo = static_cast<T>(rho_lo);
  p.rho_hi = static_cast<T>(rho_hi);
  p.cutsq = static_cast<T>(cutsq);
  return p;
}

template <typename T>
ForceParams<T> force_params(const double* a, const double* b, double u_lo,
                            double u_hi, double cutsq) {
  ForceParams<T> p;
  for (int k = 0; k < NAB; ++k) {
    p.a[k] = static_cast<T>(a[k]);
    p.b[k] = static_cast<T>(b[k]);
  }
  p.u = domain<T>(u_lo, u_hi);
  p.cutsq = static_cast<T>(cutsq);
  return p;
}

template <typename T, int P>
cell_walk::Launch walk_shape(int nx, int ny, int nz) {
  return cell_walk::launch_shape<T, sorted_grid::SortedGrid<T, P>>(nx * ny *
                                                                   nz);
}

// one launch of the rho sweep: the tally instance where `e` is not null
// (then fp, valid, fpc and fc are read too)
template <typename T>
int launch_rho(const void* gx, const void* gy, const void* gz,
               const void* prd, const void* valid, void* rho, void* fp,
               void* e, int nx, int ny, int nz, int cc, const double* g,
               double u_lo, double u_hi, double cutsq, const double* fpc,
               double rho_lo, double rho_hi, double s_lo, double s_hi,
               const double* fc, void* stream) {
  const RhoParams<T> r =
      rho_params<T>(g, u_lo, u_hi, cutsq, fp != nullptr ? fpc : nullptr,
                    rho_lo, rho_hi, s_lo, s_hi);
  const cell_walk::Launch L = walk_shape<T, 3>(nx, ny, nz);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto x = static_cast<const T*>(gx), y = static_cast<const T*>(gy),
             z = static_cast<const T*>(gz), box = static_cast<const T*>(prd);
  const auto v = static_cast<const unsigned char*>(valid);
  if (e == nullptr) {
    eam_cell_rho_kernel<T><<<L.grid, L.block, L.smem, s>>>(
        x, y, z, box, v, static_cast<T*>(rho), static_cast<T*>(fp), nx, ny,
        nz, cc, r);
  } else {
    RhoTallyParams<T> p;
    p.r = r;
    for (int k = 0; k < NF; ++k) p.F[k] = static_cast<T>(fc[k]);
    eam_cell_rho_tally_kernel<T><<<L.grid, L.block, L.smem, s>>>(
        x, y, z, box, v, static_cast<T*>(rho), static_cast<T*>(fp),
        static_cast<T*>(e), nx, ny, nz, cc, p);
  }
  return static_cast<int>(cudaGetLastError());
}

// one launch of the force sweep: the tally instance where `tally` is not
// null (then ge and phi are read too)
template <typename T>
int launch_force(const void* gx, const void* gy, const void* gz,
                 const void* gfp, const void* ge, const void* prd, void* fx,
                 void* fy, void* fz, void* tally, int nx, int ny, int nz,
                 int cc, const double* a, const double* b, const double* phi,
                 double u_lo, double u_hi, double cutsq, void* stream) {
  const ForceParams<T> f = force_params<T>(a, b, u_lo, u_hi, cutsq);
  const cell_walk::Launch L = walk_shape<T, 4>(nx, ny, nz);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto x = static_cast<const T*>(gx), y = static_cast<const T*>(gy),
             z = static_cast<const T*>(gz), w = static_cast<const T*>(gfp),
             box = static_cast<const T*>(prd);
  if (tally == nullptr) {
    eam_cell_force_kernel<T><<<L.grid, L.block, L.smem, s>>>(
        x, y, z, w, box, static_cast<T*>(fx), static_cast<T*>(fy),
        static_cast<T*>(fz), nx, ny, nz, cc, f);
  } else {
    ForceTallyParams<T> p;
    p.f = f;
    for (int k = 0; k < NPHI; ++k) p.phi[k] = static_cast<T>(phi[k]);
    eam_cell_force_tally_kernel<T><<<L.grid, L.block, L.smem, s>>>(
        x, y, z, w, static_cast<const T*>(ge), box, static_cast<T*>(fx),
        static_cast<T*>(fy), static_cast<T*>(fz), static_cast<T*>(tally),
        nx, ny, nz, cc, p);
  }
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
  return launch_rho<float>(gx, gy, gz, prd, valid, rho, fp, nullptr, nx, ny,
                           nz, cc, g, u_lo, u_hi, cutsq, fpc, rho_lo,
                           rho_hi, s_lo, s_hi, nullptr, stream);
}

extern "C" int eam_cell_rho_f64(const void* gx, const void* gy,
                                const void* gz, const void* prd,
                                const void* valid, void* rho, void* fp,
                                int nx, int ny, int nz, int cc,
                                const double* g, double u_lo, double u_hi,
                                double cutsq, const double* fpc,
                                double rho_lo, double rho_hi, double s_lo,
                                double s_hi, void* stream) {
  return launch_rho<double>(gx, gy, gz, prd, valid, rho, fp, nullptr, nx, ny,
                            nz, cc, g, u_lo, u_hi, cutsq, fpc, rho_lo,
                            rho_hi, s_lo, s_hi, nullptr, stream);
}

extern "C" int eam_cell_force_f32(const void* gx, const void* gy,
                                  const void* gz, const void* gfp,
                                  const void* prd, void* fx, void* fy,
                                  void* fz, int nx, int ny, int nz, int cc,
                                  const double* a, const double* b,
                                  double u_lo, double u_hi, double cutsq,
                                  void* stream) {
  return launch_force<float>(gx, gy, gz, gfp, nullptr, prd, fx, fy, fz,
                             nullptr, nx, ny, nz, cc, a, b, nullptr, u_lo,
                             u_hi, cutsq, stream);
}

extern "C" int eam_cell_force_f64(const void* gx, const void* gy,
                                  const void* gz, const void* gfp,
                                  const void* prd, void* fx, void* fy,
                                  void* fz, int nx, int ny, int nz, int cc,
                                  const double* a, const double* b,
                                  double u_lo, double u_hi, double cutsq,
                                  void* stream) {
  return launch_force<double>(gx, gy, gz, gfp, nullptr, prd, fx, fy, fz,
                              nullptr, nx, ny, nz, cc, a, b, nullptr, u_lo,
                              u_hi, cutsq, stream);
}

// The tally instances (thermo rows). The rho tally writes rho, fp and the
// embedding energy e (fc: the 81 F coefficients); `valid` is read. The
// force tally reads ge (each row's e) and writes the forces and `tally`,
// 7 planes of nx * ny * nz * cc rows (phi: 29 coefficients).
extern "C" int eam_cell_rho_tally_f32(
    const void* gx, const void* gy, const void* gz, const void* prd,
    const void* valid, void* rho, void* fp, void* e, int nx, int ny, int nz,
    int cc, const double* g, double u_lo, double u_hi, double cutsq,
    const double* fpc, double rho_lo, double rho_hi, double s_lo,
    double s_hi, const double* fc, void* stream) {
  return launch_rho<float>(gx, gy, gz, prd, valid, rho, fp, e, nx, ny, nz,
                           cc, g, u_lo, u_hi, cutsq, fpc, rho_lo, rho_hi,
                           s_lo, s_hi, fc, stream);
}

extern "C" int eam_cell_rho_tally_f64(
    const void* gx, const void* gy, const void* gz, const void* prd,
    const void* valid, void* rho, void* fp, void* e, int nx, int ny, int nz,
    int cc, const double* g, double u_lo, double u_hi, double cutsq,
    const double* fpc, double rho_lo, double rho_hi, double s_lo,
    double s_hi, const double* fc, void* stream) {
  return launch_rho<double>(gx, gy, gz, prd, valid, rho, fp, e, nx, ny, nz,
                            cc, g, u_lo, u_hi, cutsq, fpc, rho_lo, rho_hi,
                            s_lo, s_hi, fc, stream);
}

extern "C" int eam_cell_force_tally_f32(
    const void* gx, const void* gy, const void* gz, const void* gfp,
    const void* ge, const void* prd, void* fx, void* fy, void* fz,
    void* tally, int nx, int ny, int nz, int cc, const double* a,
    const double* b, const double* phi, double u_lo, double u_hi,
    double cutsq, void* stream) {
  return launch_force<float>(gx, gy, gz, gfp, ge, prd, fx, fy, fz, tally,
                             nx, ny, nz, cc, a, b, phi, u_lo, u_hi, cutsq,
                             stream);
}

extern "C" int eam_cell_force_tally_f64(
    const void* gx, const void* gy, const void* gz, const void* gfp,
    const void* ge, const void* prd, void* fx, void* fy, void* fz,
    void* tally, int nx, int ny, int nz, int cc, const double* a,
    const double* b, const double* phi, double u_lo, double u_hi,
    double cutsq, void* stream) {
  return launch_force<double>(gx, gy, gz, gfp, ge, prd, fx, fy, fz, tally,
                              nx, ny, nz, cc, a, b, phi, u_lo, u_hi, cutsq,
                              stream);
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
