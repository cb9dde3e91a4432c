// The sorted cell-major layout's re-bin (sm_90a): the rebuild decision, the
// local permutation and the row moves of ops/sortedforce's needs_rebuild,
// rebuild_if and rebuild_state, gated by the 0-d rebuild flag in device
// memory, so the host never reads it.
//
// Replaces no pallas_call: the JAX package re-bins in XLA
// (lammps_kokkos_port_tpu/ops/sortedforce.py: needs_rebuild, _local_perm and
// _apply_perm under the step's lax.cond). The port's plain PyTorch version
// of that pass (ops/sortedforce.rebuild_if_reference) computes both sides of
// the cond every step and selects with torch.where: about 175 device
// operations a step whatever the flag says. Here a step that does not
// rebuild costs the decision and three launches that read the flag and
// return.
//
// sorted_rebin_decide_kernel: the decision of `neigh_modify every E delay D
//   check yes/no`: the cadence from `ago`, and with `check` the displacement
//   of the valid rows since the last rebuild against (skin/2)^2, written to
//   the 0-d bool flag. A step off the cadence reads no rows. The blocks OR
//   their findings into a word of this library's device memory, and the
//   last block to finish writes the flag and clears the word (one launch, no
//   zeroed scratch from the host). One decision at a time per device: the
//   launches are ordered on the caller's stream.
// sorted_rebin_bin_kernel (gated): one thread a row. Each valid row is
//   wrapped as Box.wrap wraps it (where asked), binned, and given its stream
//   o = (dx+1)*9 + (dy+1)*3 + (dz+1), its move from its old cell, as one
//   byte (0xff on pad rows). A move of more than one cell raises the sticky
//   overflow flag.
// sorted_rebin_move_kernel (gated): one warp a destination cell. For each
//   stream k in order it reads the codes of the source cell the stream
//   comes from (cell - offset_k; where cell_cap <= 32, a lane a slot, the
//   27 cells' codes are loaded together before any is used, so the warp
//   waits on the cache once and not 27 times), takes the rows of stream k
//   by a ballot, and writes each at the running base plus its rank among
//   them (a popcount of the lower lanes' hits): the plain version's slot
//   order (stream, then rank: the exclusive sum of the 27 arrival counts),
//   with no atomics. The slots past the last arrival get the pad rows
//   (position sentinels, zeros). A cell that receives more than cell_cap
//   rows raises the overflow flag. Every slot of the cell is written once,
//   into buffers apart from the rows it reads.
// sorted_rebin_commit_kernel: on a rebuild step it copies those buffers
//   into the state's arrays and the positions into xhold, in place, and
//   sets ago to 0 and adds 1 to nbuilds; on any other step it adds 1 to ago
//   and touches nothing else. (rebuild_state, whose rebuild the host knows,
//   launches bin and move with no flag into fresh arrays and no commit.)
//
// In place: the commit overwrites the state's rows and the list's xhold,
// ago and nbuilds, and bin and move raise the list's overflow flag. The
// generic segment runner (integrate/verlet.make_step_segment) works on its
// own copies of those (sortedforce.segment_copies); x and v are made anew
// each step by the integrator.
//
// Arithmetic: the wrap and the binning are formed with explicitly rounded
// operations in the working type, term by term as the plain version forms
// them: lamda = (x - lo) * (1/prd), x_w = (lamda - floor(lamda)) * prd +
// lo, frac = lamda - floor(lamda) clamped to [0, 1 - 1e-7], cell =
// floor(frac * n). No fused multiply-add, so the rows land bit for bit
// where the plain version puts them.
//
// Bound: bytes. A decision with `check` reads the mask and, on valid rows,
// x and xhold; a rebuild reads each valid row once (bin: x and the mask;
// move: every array) plus the codes from L2, and writes every slot of the
// buffers once, then the commit reads them and writes the state and xhold.

#include <cuda_runtime.h>

// The arrays the re-bin moves (ops/rebin_kernels.Rows): x, v [rows, 3] and q
// [rows] of the working type; image [rows, 3], type, tag, mask, molecule
// [rows] int32. q and molecule are null where the atom style has none.
struct SortedRebinRows {
  void *x, *v, *q, *image, *type, *tag, *mask, *molecule;
};

namespace {

using Rows = SortedRebinRows;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;      // threads a block, every kernel
constexpr int kBlocksPerSm = 8;    // blocks of a gated grid (grid-stride)
constexpr unsigned char kPad = 0xff;  // the code of a pad row
// ops/sortedforce.py's PAD_POS and PAD_STEP
constexpr double kPadPos = 1.0e8;
constexpr double kPadStep = 16.0;

// the decision's findings: bit 0 a valid row past the threshold, bit 1 a
// NaN displacement (torch.max of the plain version returns NaN, which
// compares false); and the count of blocks that have finished
__device__ unsigned g_decide_bits = 0;
__device__ unsigned g_decide_done = 0;

template <typename T> struct Rn;

template <> struct Rn<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }
};

template <> struct Rn<double> {
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double rcp(double a) {
    return __drcp_rn(a);
  }
};

// The box as Box.to_lamda and Box.to_box use it: lo, prd = hi - lo and
// 1/prd (reciprocal(prd) * 1.0 in PyTorch: correctly rounded)
template <typename T> struct Frame {
  T lo[3], prd[3], inv[3];
};

template <typename T>
__device__ __forceinline__ Frame<T> load_frame(const T* lo, const T* hi) {
  Frame<T> f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    f.lo[c] = lo[c];
    f.prd[c] = Rn<T>::sub(hi[c], lo[c]);
    f.inv[c] = Rn<T>::rcp(f.prd[c]);
  }
  return f;
}

template <typename T>
__device__ __forceinline__ T lamda_of(const Frame<T>& f, int c, T x) {
  return Rn<T>::mul(Rn<T>::sub(x, f.lo[c]), f.inv[c]);
}

// Box.wrap on a periodic axis: the wrapped coordinate, and the image shift
template <typename T>
__device__ __forceinline__ T wrap_axis(const Frame<T>& f, int c, T x,
                                       int* shift) {
  const T lamda = lamda_of(f, c, x);
  const T s = floor(lamda);
  *shift = static_cast<int>(s);
  return Rn<T>::add(Rn<T>::mul(Rn<T>::sub(lamda, s), f.prd[c]), f.lo[c]);
}

// the cell of a coordinate along one axis (_local_perm: fraction, clamp to
// [0, 1 - 1e-7], floor(frac * n), clamped to the grid)
template <typename T>
__device__ __forceinline__ int cell_axis(const Frame<T>& f, int c, T x,
                                         int n) {
  const T lamda = lamda_of(f, c, x);
  T frac = Rn<T>::sub(lamda, floor(lamda));
  const T top = static_cast<T>(1.0 - 1e-7);
  frac = frac < T(0) ? T(0) : frac;
  frac = frac > top ? top : frac;
  const int cell =
      static_cast<int>(floor(Rn<T>::mul(frac, static_cast<T>(n))));
  return min(max(cell, 0), n - 1);
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// blocks of kThreads for `work` items, at most kBlocksPerSm an SM: the
// kernels stride over the rest, and a gated grid that returns at once is
// one short wave
inline int blocks_for(long long work) {
  const long long want = (work + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sm_count()) * kBlocksPerSm;
  return static_cast<int>(want < 1 ? 1 : (want < most ? want : most));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sorted_rebin_decide_kernel(const T* __restrict__ x,
                               const T* __restrict__ xhold,
                               const int* __restrict__ mask,
                               const long long* __restrict__ ago,
                               bool* __restrict__ flag, int rows, int delay,
                               int every, int check, T thresh) {
  const long long a = *ago + 1;
  const bool cadence = a >= delay && a % every == 0;
  if (!cadence || !check) {
    if (blockIdx.x == 0 && threadIdx.x == 0) *flag = cadence;
    return;
  }
  unsigned bits = 0;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < rows;
       r += gridDim.x * blockDim.x) {
    if (mask[r] == 0) continue;
    T sq[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T d = Rn<T>::sub(x[3 * r + c], xhold[3 * r + c]);
      sq[c] = Rn<T>::mul(d, d);
    }
    const T d2 = Rn<T>::add(Rn<T>::add(sq[0], sq[1]), sq[2]);
    if (d2 > thresh)
      bits |= 1u;
    else if (d2 != d2)
      bits |= 2u;
  }
  bits = __reduce_or_sync(kFull, bits);
  __shared__ unsigned block_bits;
  __shared__ bool last;
  if (threadIdx.x == 0) block_bits = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0 && bits) atomicOr(&block_bits, bits);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (block_bits) atomicOr(&g_decide_bits, block_bits);
    __threadfence();
    last = atomicAdd(&g_decide_done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    const unsigned all = atomicExch(&g_decide_bits, 0u);
    atomicExch(&g_decide_done, 0u);
    *flag = (all & 1u) && !(all & 2u);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sorted_rebin_bin_kernel(const bool* __restrict__ flag,
                            const T* __restrict__ x,
                            const int* __restrict__ mask, const T* lo,
                            const T* hi, unsigned char* __restrict__ code,
                            bool* overflow, int nx, int ny, int nz, int cc,
                            int wrap) {
  if (flag != nullptr && !*flag) return;
  const Frame<T> f = load_frame(lo, hi);
  const int n[3] = {nx, ny, nz};
  const int rows = nx * ny * nz * cc;
  bool far = false;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < rows;
       r += gridDim.x * blockDim.x) {
    if (mask[r] == 0) {
      code[r] = kPad;
      continue;
    }
    const int cell = r / cc;
    const int old[3] = {cell / (ny * nz), (cell / nz) % ny, cell % nz};
    int o = 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      T xc = x[3 * r + c];
      int shift;
      if (wrap) xc = wrap_axis(f, c, xc, &shift);
      int d = cell_axis(f, c, xc, n[c]) - old[c];
      const int half = n[c] / 2;
      d = d > half ? d - n[c] : (d < -half ? d + n[c] : d);
      far |= d > 1 || d < -1;
      o = o * 3 + d + 1;
    }
    code[r] = static_cast<unsigned char>(min(max(o, 0), 26));
  }
  if (far) *overflow = true;
}

template <typename T>
__device__ __forceinline__ void move_row(const Frame<T>& f, const Rows& in,
                                         const Rows& out, int src, int dst,
                                         int wrap) {
  const T* ix = static_cast<const T*>(in.x);
  const T* iv = static_cast<const T*>(in.v);
  const int* iimg = static_cast<const int*>(in.image);
  T* ox = static_cast<T*>(out.x);
  T* ov = static_cast<T*>(out.v);
  int* oimg = static_cast<int*>(out.image);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    T xc = ix[3 * src + c];
    int shift = 0;
    if (wrap) xc = wrap_axis(f, c, xc, &shift);
    ox[3 * dst + c] = xc;
    ov[3 * dst + c] = iv[3 * src + c];
    oimg[3 * dst + c] = iimg[3 * src + c] + shift;
  }
  static_cast<int*>(out.type)[dst] = static_cast<const int*>(in.type)[src];
  static_cast<int*>(out.tag)[dst] = static_cast<const int*>(in.tag)[src];
  static_cast<int*>(out.mask)[dst] = static_cast<const int*>(in.mask)[src];
  if (out.q != nullptr)
    static_cast<T*>(out.q)[dst] = static_cast<const T*>(in.q)[src];
  if (out.molecule != nullptr)
    static_cast<int*>(out.molecule)[dst] =
        static_cast<const int*>(in.molecule)[src];
}

// a pad row: the diagonal sentinel PAD_POS + row * PAD_STEP (the plain
// version's _pad_x, in the working type) and zeros
template <typename T>
__device__ __forceinline__ void pad_row(const Rows& out, int dst) {
  const T p = Rn<T>::add(static_cast<T>(kPadPos),
                         Rn<T>::mul(static_cast<T>(dst),
                                    static_cast<T>(kPadStep)));
  T* ox = static_cast<T*>(out.x);
  T* ov = static_cast<T*>(out.v);
  int* oimg = static_cast<int*>(out.image);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ox[3 * dst + c] = p;
    ov[3 * dst + c] = T(0);
    oimg[3 * dst + c] = 0;
  }
  static_cast<int*>(out.type)[dst] = 0;
  static_cast<int*>(out.tag)[dst] = 0;
  static_cast<int*>(out.mask)[dst] = 0;
  if (out.q != nullptr) static_cast<T*>(out.q)[dst] = T(0);
  if (out.molecule != nullptr) static_cast<int*>(out.molecule)[dst] = 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sorted_rebin_move_kernel(const bool* __restrict__ flag,
                             const unsigned char* __restrict__ code,
                             const T* lo, const T* hi, bool* overflow,
                             Rows in, Rows out, int nx, int ny, int nz,
                             int cc, int wrap) {
  if (flag != nullptr && !*flag) return;
  const Frame<T> f = load_frame(lo, hi);
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int warps = blockDim.x >> 5;
  const int ncell = nx * ny * nz;
  // the warp's cells: the loop's bound is the same for its 32 lanes
  for (int cell = blockIdx.x * warps + (threadIdx.x >> 5); cell < ncell;
       cell += gridDim.x * warps) {
    const int cx = cell / (ny * nz), cy = (cell / nz) % ny, cz = cell % nz;
    // stream k moved by (dx, dy, dz) = (k / 9, k / 3 % 3, k % 3) - 1: it
    // comes from cell - offset, the source coordinates below by d + 1
    const int sx[3] = {(cx + 1) % nx, cx, (cx - 1 + nx) % nx};
    const int sy[3] = {(cy + 1) % ny, cy, (cy - 1 + ny) % ny};
    const int sz[3] = {(cz + 1) % nz, cz, (cz - 1 + nz) % nz};
    int base = 0;
    if (cc <= 32) {
      // a lane a slot: the 27 source cells' codes loaded together, then
      // the streams placed in order from registers
      unsigned char cd[27];
#pragma unroll
      for (int k = 0; k < 27; ++k) {
        const int src = ((sx[k / 9] * ny + sy[(k / 3) % 3]) * nz +
                         sz[k % 3]) * cc;
        cd[k] = lane < cc ? code[src + lane] : kPad;
      }
#pragma unroll
      for (int k = 0; k < 27; ++k) {
        const bool hit = cd[k] == k;
        const unsigned m = __ballot_sync(kFull, hit);
        if (hit) {
          const int src = ((sx[k / 9] * ny + sy[(k / 3) % 3]) * nz +
                           sz[k % 3]) * cc;
          const int slot = base + __popc(m & below);
          if (slot < cc)
            move_row(f, in, out, src + lane, cell * cc + slot, wrap);
        }
        base += __popc(m);
      }
    } else {
      for (int k = 0; k < 27; ++k) {
        const int src = ((sx[k / 9] * ny + sy[(k / 3) % 3]) * nz +
                         sz[k % 3]) * cc;
        for (int j = 0; j < cc; j += 32) {
          const int s = j + lane;
          const bool hit = s < cc && code[src + s] == k;
          const unsigned m = __ballot_sync(kFull, hit);
          if (hit) {
            const int slot = base + __popc(m & below);
            if (slot < cc)
              move_row(f, in, out, src + s, cell * cc + slot, wrap);
          }
          base += __popc(m);
        }
      }
    }
    if (base > cc && lane == 0) *overflow = true;
    for (int slot = base + lane; slot < cc; slot += 32)
      pad_row<T>(out, cell * cc + slot);
  }
}

template <typename E>
__device__ __forceinline__ void copy_rows(const void* src, void* dst,
                                          long long n, long long t0,
                                          long long stride) {
  const E* s = static_cast<const E*>(src);
  E* d = static_cast<E*>(dst);
  for (long long i = t0; i < n; i += stride) d[i] = s[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sorted_rebin_commit_kernel(const bool* __restrict__ flag,
                               long long* ago, long long* nbuilds, Rows src,
                               Rows dst, T* __restrict__ xhold, int rows) {
  const bool on = *flag;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (on) {
      *ago = 0;
      *nbuilds += 1;
    } else {
      *ago += 1;
    }
  }
  if (!on) return;
  const long long t0 = blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long r = rows, r3 = 3LL * rows;
  copy_rows<T>(src.x, dst.x, r3, t0, stride);
  copy_rows<T>(src.x, xhold, r3, t0, stride);
  copy_rows<T>(src.v, dst.v, r3, t0, stride);
  copy_rows<int>(src.image, dst.image, r3, t0, stride);
  copy_rows<int>(src.type, dst.type, r, t0, stride);
  copy_rows<int>(src.tag, dst.tag, r, t0, stride);
  copy_rows<int>(src.mask, dst.mask, r, t0, stride);
  if (dst.q != nullptr) copy_rows<T>(src.q, dst.q, r, t0, stride);
  if (dst.molecule != nullptr)
    copy_rows<int>(src.molecule, dst.molecule, r, t0, stride);
}

template <typename T>
int launch_decide(const void* x, const void* xhold, const void* mask,
                  const void* ago, void* flag, int rows, int delay, int every,
                  int check, double half_skin_sq, void* stream) {
  const int grid = check ? blocks_for(rows) : 1;
  sorted_rebin_decide_kernel<T>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const T*>(xhold),
          static_cast<const int*>(mask), static_cast<const long long*>(ago),
          static_cast<bool*>(flag), rows, delay, every, check,
          static_cast<T>(half_skin_sq));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bin(const void* flag, const void* x, const void* mask,
               const void* lo, const void* hi, void* code, void* overflow,
               int nx, int ny, int nz, int cc, int wrap, void* stream) {
  sorted_rebin_bin_kernel<T><<<blocks_for(1LL * nx * ny * nz * cc), kThreads,
                               0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bool*>(flag), static_cast<const T*>(x),
      static_cast<const int*>(mask), static_cast<const T*>(lo),
      static_cast<const T*>(hi), static_cast<unsigned char*>(code),
      static_cast<bool*>(overflow), nx, ny, nz, cc, wrap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_move(const void* flag, const void* code, const void* lo,
                const void* hi, void* overflow, const Rows* in,
                const Rows* out, int nx, int ny, int nz, int cc, int wrap,
                void* stream) {
  // one warp a cell
  sorted_rebin_move_kernel<T><<<blocks_for(32LL * nx * ny * nz), kThreads,
                                0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bool*>(flag), static_cast<const unsigned char*>(code),
      static_cast<const T*>(lo), static_cast<const T*>(hi),
      static_cast<bool*>(overflow), *in, *out, nx, ny, nz, cc, wrap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_commit(const void* flag, void* ago, void* nbuilds, const Rows* src,
                  const Rows* dst, void* xhold, int rows, void* stream) {
  sorted_rebin_commit_kernel<T><<<blocks_for(3LL * rows), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bool*>(flag), static_cast<long long*>(ago),
      static_cast<long long*>(nbuilds), *src, *dst, static_cast<T*>(xhold),
      rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C entry points (ctypes, ops/rebin_kernels.py). x, xhold, lo, hi and
// the Rows' x, v, q of the dtype; mask int32 [rows]; ago, nbuilds int64
// [1]; flag, overflow bool [1]; code uint8 [rows]. flag null in bin and
// move: rebuild (rebuild_state). wrap: wrap the positions first (Box.wrap).
// Each returns cudaGetLastError() after its launch.

#define SORTED_REBIN_ENTRIES(SUFFIX, T)                                       \
  extern "C" int sorted_rebin_decide_##SUFFIX(                                \
      const void* x, const void* xhold, const void* mask, const void* ago,    \
      void* flag, int rows, int delay, int every, int check,                  \
      double half_skin_sq, void* stream) {                                    \
    return launch_decide<T>(x, xhold, mask, ago, flag, rows, delay, every,    \
                            check, half_skin_sq, stream);                     \
  }                                                                           \
  extern "C" int sorted_rebin_bin_##SUFFIX(                                   \
      const void* flag, const void* x, const void* mask, const void* lo,      \
      const void* hi, void* code, void* overflow, int nx, int ny, int nz,     \
      int cc, int wrap, void* stream) {                                       \
    return launch_bin<T>(flag, x, mask, lo, hi, code, overflow, nx, ny, nz,   \
                         cc, wrap, stream);                                   \
  }                                                                           \
  extern "C" int sorted_rebin_move_##SUFFIX(                                  \
      const void* flag, const void* code, const void* lo, const void* hi,     \
      void* overflow, const SortedRebinRows* in,                              \
      const SortedRebinRows* out, int nx, int ny, int nz, int cc, int wrap,   \
      void* stream) {                                                         \
    return launch_move<T>(flag, code, lo, hi, overflow, in, out, nx, ny, nz,  \
                          cc, wrap, stream);                                  \
  }                                                                           \
  extern "C" int sorted_rebin_commit_##SUFFIX(                                \
      const void* flag, void* ago, void* nbuilds,                             \
      const SortedRebinRows* src, const SortedRebinRows* dst, void* xhold,    \
      int rows, void* stream) {                                               \
    return launch_commit<T>(flag, ago, nbuilds, src, dst, xhold, rows,        \
                            stream);                                          \
  }

SORTED_REBIN_ENTRIES(f32, float)
SORTED_REBIN_ENTRIES(f64, double)
