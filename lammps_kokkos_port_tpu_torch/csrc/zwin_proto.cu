// The z-window Newton-half column prototype, for Hopper (sm_90a).
//
// Replaces the Pallas prototype P12 of benchmarks/prof/prof_zwin_proto.py
// (run :103-122, pallas_call :108, kernel :34-100): a throughput probe of
// the op mix of a z-window column kernel on synthetic inputs. For each
// column pid and chunk k of 8 own atoms (xT, yT, zT [S][NCOL], rows 8k..)
// it takes NLANE = WS + 4 WN candidate lanes: the own column's window
// e*[pid][G + 8k, + WS) and four windows e*[nb_w][st_w + k, + WN) of the
// columns nb_w = pid + off_w mod NCOL (off = +1, -1, +12, -12, :52-53) at
// st_w = starts[pid][0][w] (only row 0 of a column's start rows is read,
// :60, :94). A lane l < WS with l <= i is biased out for own atom i (:47-49);
// a pair within cutsq gives fpair from the approximate reciprocal refined by
// one Newton step (:74-75); the forward sums go to fT*[8k + i][pid] and the
// reactions -sum_i fij to the lanes' windows of fL* [NCOL][SE] (:90-97).
//
// The hazard: the TPU body adds each reaction window into fL of another
// column (`fL[nb[w], ...] +=`) and zeroes fL only at pid 0, relying on the
// TPU's in-order grid. CUDA blocks run concurrently. Here both outputs are
// gathers, so each element is written once, by one thread group, with no
// atomics, no scratch and no second launch:
//   - forward: fT*[8k + i][pid] sums the 256 lanes of own atom i of chunk k;
//   - reactions: every window that adds into fL*[c][p] reads the same
//     candidate e*[c][p], so fL*[c][p] = -sum (own - e[c][p]) fpair over
//     (a) the own window of c: the chunks k with l = p - G - 8k in [0, WS)
//         and the own atoms i < l of column c;
//     (b) for each w, the source column src = c - off_w mod NCOL (each w is
//         its own term, also where two sources coincide) at st = starts[src]
//         [0][w]: the chunks k with p - st - k in [0, WN) and all 8 own
//         atoms of src's chunk k.
//     A position no window covers gets 0.
// One launch, split by block index: reaction blocks first (a target column,
// kRctPos positions; they take longer, and the forward blocks fill the
// tail), then forward blocks (a column, up to kFwdChunks chunks). Each
// block stages with cp.async what its threads read, as (x, y, z) records:
// a forward block its chunks' candidate span (the own strip e[pid][G + 8
// k0, + 8 (kn - 1) + WS) and the four strips e[nb_w][st_w + k0, + kn - 1 +
// WN)); a reaction block the own atoms of the chunks its positions reach in
// each of its five windows, read from columns of the [S][NCOL] planes. One
// barrier after staging, none after. kFwdSplit (kRctSplit) threads of
// adjacent lanes share one output, each taking every kFwdSplit-th lane of
// each window (every kRctSplit-th own atom of each chunk), and their sums
// meet by a fixed butterfly of warp shuffles. The order of every sum is
// fixed: the results repeat bit for bit from run to run. A reaction warp
// runs its chunk loops over the union of its positions' ranges, so its
// lanes read one chunk's records at a time (a broadcast, no bank
// conflicts).
//
// Every lane-pair's r2 and cutoff test runs twice (once in each gather),
// against the first design's one evaluation followed by 120 dependent
// shuffles per 8 pairs and two barriers a chunk; the body and its sums run
// only inside the cutoff. r2 is formed with explicitly rounded products
// and sums, as the plain twin forms it, so both gathers and the twin make
// the same cutoff decisions. f32 only: the body's reciprocal is the
// approximate one (rcp.approx.ftz.f32 here).
//
// Bound: operations (every lane-pair's r2 and cutoff test, about 9.4 M at
// the script's shapes, plus the body of the pairs in the cutoff, about
// 0.0013 ms on an H100). What takes the time (an H100 at 700 W, the
// script's shapes, ablations of this source): the reaction
// blocks' staging, one 32-byte sector for each 4-byte value of a column
// of the planes (about half the reaction blocks' time), then the two
// gathers' tests.

#include <cuda_runtime.h>

#include <algorithm>

#include "cell_walk.cuh"

namespace {

using cell_stencil::Rn;

constexpr int kOwn = 8;  // own atoms per chunk (the body's sublanes)
constexpr int kWin = 4;  // neighbour windows
constexpr int kThreads = 256;  // threads per block, both roles
constexpr int kFwdSplit = 4;  // threads per own atom (a power of two <= 32)
constexpr int kRctSplit = 4;  // threads per reaction element (<= kOwn)
constexpr int kFwdChunks = kThreads / (kOwn * kFwdSplit);  // per block
constexpr int kRctPos = kThreads / kRctSplit;  // positions per block
static_assert(kFwdChunks >= 1 && kThreads % (kOwn * kFwdSplit) == 0 &&
                  (kFwdSplit & (kFwdSplit - 1)) == 0 && kFwdSplit <= 32,
              "the forward split");
static_assert((kRctSplit & (kRctSplit - 1)) == 0 && kRctSplit <= kOwn,
              "the reaction split");

struct Args {
  const float* ex;
  const float* ey;
  const float* ez;
  const float* xT;
  const float* yT;
  const float* zT;
  const int* starts;  // [ncol][npc][4]
  float* fTx;
  float* fTy;
  float* fTz;
  float* fLx;
  float* fLy;
  float* fLz;
  int ncol, g, ws, wn, se, npc;
  int fwd_per_col, rct_per_col, nfwd;
  int off[kWin];
  float cutsq, lj1, lj2;
};

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ int wrap(int c, int n) { return ((c % n) + n) % n; }

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// row 0 of column c's start rows, window w
__device__ __forceinline__ int start_of(const Args& a, int c, int w) {
  return a.starts[size_t(c) * a.npc * kWin + w];
}

// The pair (own o, candidate c): d = o - c with r2 rounded as the twin
// rounds it; where `take` and r2 is inside the cutoff, s += d fpair
__device__ __forceinline__ void add_pair(const Args& a, const float4& o,
                                         const float4& c, bool take,
                                         float (&s)[3]) {
  const float dx = o.x - c.x, dy = o.y - c.y, dz = o.z - c.z;
  const float r2 = Rn<float>::add(
      Rn<float>::add(Rn<float>::mul(dx, dx), Rn<float>::mul(dy, dy)),
      Rn<float>::mul(dz, dz));
  if (take && r2 < a.cutsq) {
    const float y0 = rcp_approx(r2);
    const float r2i = y0 * (2.f - r2 * y0);
    const float r6 = r2i * r2i * r2i;
    const float fp = r6 * (a.lj1 * r6 - a.lj2) * r2i;
    s[0] += dx * fp;
    s[1] += dy * fp;
    s[2] += dz * fp;
  }
}

// the sums of the Split adjacent lanes that share an output, in a fixed
// butterfly (every lane of the warp takes part)
template <int Split>
__device__ __forceinline__ void meet(float (&s)[3]) {
#pragma unroll
  for (int d = 1; d < Split; d <<= 1)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      s[c] += __shfl_xor_sync(0xffffffffu, s[c], d);
}

// the record of one value of each plane, copied asynchronously
__device__ __forceinline__ void stage_record(float4* rec, const float* x,
                                             const float* y, const float* z,
                                             size_t at) {
  float* r = reinterpret_cast<float*>(rec);
  cell_walk::copy_async(r, x + at);
  cell_walk::copy_async(r + 1, y + at);
  cell_walk::copy_async(r + 2, z + at);
}

// Forward block: column pid, chunks [k0, k0 + kn). Records: the own strip
// (chunk k's window at 8 (k - k0)), then strip w (chunk k's window at k -
// k0).
__device__ __forceinline__ void forward(const Args& a, int b, float4* rec) {
  const int pid = b / a.fwd_per_col;
  const int k0 = (b % a.fwd_per_col) * kFwdChunks;
  const int kn = min(kFwdChunks, a.npc - k0);
  const int own_len = kOwn * (kn - 1) + a.ws, nb_len = kn - 1 + a.wn;
  int nb[kWin], st[kWin];
#pragma unroll
  for (int w = 0; w < kWin; ++w) {
    nb[w] = wrap(pid + a.off[w], a.ncol);
    st[w] = start_of(a, pid, w) + k0;
  }
  const int total = own_len + kWin * nb_len;
  for (int q = threadIdx.x; q < total; q += kThreads) {
    size_t at;
    if (q < own_len) {
      at = size_t(pid) * a.se + a.g + kOwn * k0 + q;
    } else {
      const int w = (q - own_len) / nb_len, m = (q - own_len) % nb_len;
      at = size_t(nb[w]) * a.se + st[w] + m;
    }
    stage_record(rec + q, a.ex, a.ey, a.ez, at);
  }
  cell_walk::copy_commit();
  cell_walk::copy_wait_all();
  __syncthreads();

  const int u = threadIdx.x % kFwdSplit;
  const int atom = threadIdx.x / kFwdSplit;  // in the block
  const int i = atom % kOwn, kk = atom / kOwn;
  const bool live = kk < kn;
  const int r = kOwn * (k0 + kk) + i;
  float s[3] = {0.f, 0.f, 0.f};
  if (live) {
    const size_t o_at = size_t(r) * a.ncol + pid;
    const float4 o = make_float4(a.xT[o_at], a.yT[o_at], a.zT[o_at], 0.f);
    const float4* own = rec + kOwn * kk;
    for (int l = u; l < a.ws; l += kFwdSplit)
      add_pair(a, o, own[l], l > i, s);
#pragma unroll
    for (int w = 0; w < kWin; ++w) {
      const float4* win = rec + own_len + w * nb_len + kk;
      for (int m = u; m < a.wn; m += kFwdSplit)
        add_pair(a, o, win[m], true, s);
    }
  }
  meet<kFwdSplit>(s);
  if (live && u == 0) {
    const size_t at = size_t(r) * a.ncol + pid;
    a.fTx[at] = s[0];
    a.fTy[at] = s[1];
    a.fTz[at] = s[2];
  }
}

// The chunks of window v (0: the own window; 1 + w: neighbour window w)
// that reach position p, as [lo, hi] before clipping to [0, npc):
// own: l = p - G - 8k in [0, WS); neighbour: p - st - k in [0, WN).
__device__ __forceinline__ int chunk_lo(const Args& a, int v, int st, int p) {
  return v == 0 ? floor_div(p - a.g - a.ws, kOwn) + 1 : p - st - a.wn + 1;
}
__device__ __forceinline__ int chunk_hi(const Args& a, int v, int st, int p) {
  return v == 0 ? floor_div(p - a.g, kOwn) : p - st;
}

// Reaction block: target column c, positions [p0, p0 + kRctPos). Records:
// for each window v in order, the own atoms of its source column's chunks
// [klo_v, khi_v] (the chunks any of the block's positions reach), 8 a
// chunk.
__device__ __forceinline__ void reaction(const Args& a, int b, float4* rec) {
  const int c = b / a.rct_per_col;
  const int p0 = (b % a.rct_per_col) * kRctPos;
  const int p1 = min(p0 + kRctPos, a.se) - 1;
  int src[1 + kWin], st[1 + kWin], klo[1 + kWin], base[1 + kWin];
  int total = 0;
#pragma unroll
  for (int v = 0; v <= kWin; ++v) {
    src[v] = v == 0 ? c : wrap(c - a.off[v - 1], a.ncol);
    st[v] = v == 0 ? 0 : start_of(a, src[v], v - 1);
    klo[v] = max(chunk_lo(a, v, st[v], p0), 0);
    const int khi = min(chunk_hi(a, v, st[v], p1), a.npc - 1);
    base[v] = total;
    total += kOwn * max(khi - klo[v] + 1, 0);
  }
  for (int q = threadIdx.x; q < total; q += kThreads) {
    int v = 0;
#pragma unroll
    for (int t = 1; t <= kWin; ++t) v = q >= base[t] ? t : v;
    const int row = kOwn * klo[v] + (q - base[v]);  // own atom of src[v]
    stage_record(rec + q, a.xT, a.yT, a.zT, size_t(row) * a.ncol + src[v]);
  }
  cell_walk::copy_commit();
  cell_walk::copy_wait_all();
  __syncthreads();

  const int u = threadIdx.x % kRctSplit;
  const int p = p0 + threadIdx.x / kRctSplit;
  const bool live = p < a.se;
  // this warp's positions: its chunk loops run over their union
  const int wp0 = p0 + (threadIdx.x & ~31) / kRctSplit;
  const int wp1 = min(wp0 + 32 / kRctSplit, a.se) - 1;
  float s[3] = {0.f, 0.f, 0.f};
  if (wp0 < a.se) {
    const size_t e_at = size_t(c) * a.se + min(p, a.se - 1);
    const float4 e = make_float4(a.ex[e_at], a.ey[e_at], a.ez[e_at], 0.f);
#pragma unroll
    for (int v = 0; v <= kWin; ++v) {
      const int lo = max(chunk_lo(a, v, st[v], wp0), 0);
      const int hi = min(chunk_hi(a, v, st[v], wp1), a.npc - 1);
      for (int k = lo; k <= hi; ++k) {
        // the own atoms of chunk k that pair with this position: lane u
        // takes every kRctSplit-th of them
        const int l = v == 0 ? p - a.g - kOwn * k : p - st[v] - k;
        const bool in = live && l >= 0 && l < (v == 0 ? a.ws : a.wn);
        const int n = v == 0 ? min(l, kOwn) : kOwn;
        const float4* atoms = rec + base[v] + kOwn * (k - klo[v]);
#pragma unroll
        for (int j = 0; j < kOwn / kRctSplit; ++j) {
          const int i = u + j * kRctSplit;
          add_pair(a, atoms[i], e, in && i < n, s);
        }
      }
    }
  }
  meet<kRctSplit>(s);
  if (live && u == 0) {
    const size_t at = size_t(c) * a.se + p;
    a.fLx[at] = -s[0];
    a.fLy[at] = -s[1];
    a.fLz[at] = -s[2];
  }
}

// the reaction blocks first, then nfwd forward blocks
__global__ void __launch_bounds__(kThreads) zwin_gathers(const Args a) {
  extern __shared__ __align__(16) float4 zrec[];
  const int b = static_cast<int>(blockIdx.x);
  const int nrct = static_cast<int>(gridDim.x) - a.nfwd;
  if (b < nrct)
    reaction(a, b, zrec);
  else
    forward(a, b - nrct, zrec);
}

}  // namespace

// Plain C entry point (bound with ctypes): both gathers in one launch, on
// `stream`, not synchronised; returns cudaGetLastError() after the launch
// (0 = success).
extern "C" int zwin_proto_f32(const void* ex, const void* ey,
                              const void* ez, const void* xT, const void* yT,
                              const void* zT, const void* starts, void* fTx,
                              void* fTy, void* fTz, void* fLx, void* fLy,
                              void* fLz, int ncol, int s, int g, int ws,
                              int wn, int off0, int off1, int off2, int off3,
                              double cutsq, double lj1, double lj2,
                              void* stream) {
  if (s % kOwn != 0 || s < kOwn || ncol < 1 || ws < 1 || wn < 1 ||
      ws > g + kOwn)
    return static_cast<int>(cudaErrorInvalidValue);
  const int npc = s / kOwn, se = s + 2 * g;
  const int fwd_per_col = (npc + kFwdChunks - 1) / kFwdChunks;
  const int rct_per_col = (se + kRctPos - 1) / kRctPos;
  Args a{static_cast<const float*>(ex), static_cast<const float*>(ey),
         static_cast<const float*>(ez), static_cast<const float*>(xT),
         static_cast<const float*>(yT), static_cast<const float*>(zT),
         static_cast<const int*>(starts), static_cast<float*>(fTx),
         static_cast<float*>(fTy), static_cast<float*>(fTz),
         static_cast<float*>(fLx), static_cast<float*>(fLy),
         static_cast<float*>(fLz), ncol, g, ws, wn, se, npc, fwd_per_col,
         rct_per_col, ncol * fwd_per_col,
         {off0, off1, off2, off3}, static_cast<float>(cutsq),
         static_cast<float>(lj1), static_cast<float>(lj2)};
  // records: a forward block's span; a reaction block's own atoms, at most
  // the chunks kRctPos positions reach in each window
  const int fchunks = std::min(kFwdChunks, npc);
  const size_t fwd = size_t(kOwn) * (fchunks - 1) + ws +
                     size_t(kWin) * (fchunks - 1 + wn);
  const int own_chunks = std::min(npc, (kRctPos + ws + kOwn - 2) / kOwn + 1);
  const int nb_chunks = std::min(npc, kRctPos + wn - 1);
  const size_t rct = size_t(kOwn) * (own_chunks + kWin * nb_chunks);
  const size_t smem = std::max(fwd, rct) * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&zwin_gathers),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(a.nfwd + ncol * rct_per_col);
  zwin_gathers<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}
