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
// TPU's in-order grid. CUDA blocks run concurrently, so here:
//   - pass: one block per column, one thread per candidate lane. Each block
//     walks its chunks in order and keeps its five reaction strips in shared
//     memory: the own strip [8 (NPC - 1) + WS] (window k starts at 8k) and
//     one strip [NPC - 1 + WN] per neighbour window (window k starts at k).
//     Within a chunk every lane owns a distinct slot, and a barrier
//     separates the chunks, so no atomic is needed. The strips are written
//     once to strips[pid][3][own + 4 nb]. The forward sums of the 8 own
//     atoms are reduced by warp shuffles and then across warps in warp
//     order: deterministic;
//   - fold: one block per target column c; fL[c][p] = the own strip of c at
//     p - G plus, for w = 0..3, the strip w of the source column c - off_w
//     at p - starts[c - off_w][0][w]. A gather in a fixed order, one write
//     per output, no atomics: deterministic.
// r2 is formed with explicitly rounded products and sums, as the plain twin
// forms it, so both make the same cutoff decisions. f32 only: the body's
// reciprocal is the approximate one (rcp.approx.ftz.f32 here).
//
// Bound: memory at the script's shapes (a few hundred kilobytes in and
// out); in practice the 32 dependent chunks per block and the reductions.

#include <cuda_runtime.h>

#include "cell_stencil.cuh"

namespace {

using cell_stencil::Rn;

constexpr int kOwn = 8;  // own atoms per chunk (the body's sublanes)
constexpr int kWin = 4;  // neighbour windows

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
  float* strips;  // [ncol][3][own_len + 4 nb_len]
  int ncol, s, g, ws, wn, se, npc, own_len, nb_len;
  int off[kWin];
  float cutsq, lj1, lj2;
};

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ int wrap(int c, int n) { return ((c % n) + n) % n; }

__global__ void zwin_pass(const Args a) {
  extern __shared__ __align__(16) float zsmem[];
  const int slen = a.own_len + kWin * a.nb_len;
  float* strip = zsmem;                  // [3][slen]
  float* red = zsmem + 3 * slen;         // [nwarps][3 * kOwn]
  const int pid = blockIdx.x;
  const int l = threadIdx.x;
  const int nlane = a.ws + kWin * a.wn;
  const bool live = l < nlane;
  const int warp = l / 32, nwarps = blockDim.x / 32;
  for (int q = l; q < 3 * slen; q += blockDim.x) strip[q] = 0.f;

  // this lane's column, window start and strip slot at chunk 0, and its
  // step per chunk
  int col = pid, base = a.g + l, slot = l, step = kOwn;
  if (live && l >= a.ws) {
    const int w = (l - a.ws) / a.wn, m = (l - a.ws) % a.wn;
    col = wrap(pid + a.off[w], a.ncol);
    base = a.starts[size_t(pid) * a.npc * kWin + w] + m;
    slot = a.own_len + w * a.nb_len + m;
    step = 1;
  }
  for (int k = 0; k < a.npc; ++k) {
    __syncthreads();  // the previous chunk's strip slots and sums are done
    float cx = 0.f, cy = 0.f, cz = 0.f;
    if (live) {
      const size_t at = size_t(col) * a.se + base + k * step;
      cx = a.ex[at];
      cy = a.ey[at];
      cz = a.ez[at];
    }
    float f[3 * kOwn];
    float rx = 0.f, ry = 0.f, rz = 0.f;
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const size_t o = size_t(k * kOwn + i) * a.ncol + pid;
      const float dx = a.xT[o] - cx, dy = a.yT[o] - cy, dz = a.zT[o] - cz;
      const float r2 = Rn<float>::add(
          Rn<float>::add(Rn<float>::mul(dx, dx), Rn<float>::mul(dy, dy)),
          Rn<float>::mul(dz, dz));
      float fp = 0.f;
      if (live && !(l < a.ws && l <= i) && r2 < a.cutsq) {
        const float y0 = rcp_approx(r2);
        const float r2i = y0 * (2.f - r2 * y0);
        const float r6 = r2i * r2i * r2i;
        fp = r6 * (a.lj1 * r6 - a.lj2) * r2i;
      }
      f[3 * i] = dx * fp;
      f[3 * i + 1] = dy * fp;
      f[3 * i + 2] = dz * fp;
      rx += f[3 * i];
      ry += f[3 * i + 1];
      rz += f[3 * i + 2];
    }
    if (live) {
      const int q = slot + k * step;
      strip[q] -= rx;
      strip[slen + q] -= ry;
      strip[2 * slen + q] -= rz;
    }
    // forward sums of the 8 own atoms: within each warp, then across warps
#pragma unroll
    for (int q = 0; q < 3 * kOwn; ++q) {
      float v = f[q];
      for (int d = 16; d > 0; d >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, d);
      if (l % 32 == 0) red[warp * 3 * kOwn + q] = v;
    }
    __syncthreads();
    if (l < 3 * kOwn) {
      float v = 0.f;
      for (int wp = 0; wp < nwarps; ++wp) v += red[wp * 3 * kOwn + l];
      const size_t o = size_t(k * kOwn + l / 3) * a.ncol + pid;
      float* out = l % 3 == 0 ? a.fTx : (l % 3 == 1 ? a.fTy : a.fTz);
      out[o] = v;
    }
  }
  __syncthreads();
  float* dst = a.strips + size_t(pid) * 3 * slen;
  for (int q = l; q < 3 * slen; q += blockDim.x) dst[q] = strip[q];
}

__global__ void zwin_fold(const Args a) {
  const int c = blockIdx.x;
  const int slen = a.own_len + kWin * a.nb_len;
  int src[kWin], st[kWin];
#pragma unroll
  for (int w = 0; w < kWin; ++w) {
    src[w] = wrap(c - a.off[w], a.ncol);
    st[w] = a.starts[size_t(src[w]) * a.npc * kWin + w];
  }
  float* out[3] = {a.fLx, a.fLy, a.fLz};
  for (int p = threadIdx.x; p < a.se; p += blockDim.x) {
#pragma unroll
    for (int comp = 0; comp < 3; ++comp) {
      float v = 0.f;
      const int q = p - a.g;
      if (q >= 0 && q < a.own_len)
        v += a.strips[(size_t(c) * 3 + comp) * slen + q];
#pragma unroll
      for (int w = 0; w < kWin; ++w) {
        const int r = p - st[w];
        if (r >= 0 && r < a.nb_len)
          v += a.strips[(size_t(src[w]) * 3 + comp) * slen + a.own_len +
                        w * a.nb_len + r];
      }
      out[comp][size_t(c) * a.se + p] = v;
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): the pass, then the fold. Launch
// on `stream`, do not synchronise; return cudaGetLastError() after the
// launches (0 = success).
extern "C" int zwin_proto_f32(const void* ex, const void* ey,
                              const void* ez, const void* xT, const void* yT,
                              const void* zT, const void* starts, void* fTx,
                              void* fTy, void* fTz, void* fLx, void* fLy,
                              void* fLz, void* strips, int ncol, int s, int g,
                              int ws, int wn, int off0, int off1, int off2,
                              int off3, double cutsq, double lj1, double lj2,
                              void* stream) {
  const int npc = s / kOwn;
  Args a{static_cast<const float*>(ex), static_cast<const float*>(ey),
         static_cast<const float*>(ez), static_cast<const float*>(xT),
         static_cast<const float*>(yT), static_cast<const float*>(zT),
         static_cast<const int*>(starts), static_cast<float*>(fTx),
         static_cast<float*>(fTy), static_cast<float*>(fTz),
         static_cast<float*>(fLx), static_cast<float*>(fLy),
         static_cast<float*>(fLz), static_cast<float*>(strips), ncol, s, g,
         ws, wn, s + 2 * g, npc, kOwn * (npc - 1) + ws, npc - 1 + wn,
         {off0, off1, off2, off3}, static_cast<float>(cutsq),
         static_cast<float>(lj1), static_cast<float>(lj2)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = ((ws + kWin * wn + 31) / 32) * 32;
  if (threads > 1024 || s % kOwn != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t(3) * (a.own_len + kWin * a.nb_len) +
                       (threads / 32) * 3 * kOwn) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&zwin_pass),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  zwin_pass<<<ncol, threads, smem, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  zwin_fold<<<ncol, 128, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
