// Dynamic lane windows summed per column, for Hopper (sm_90a).
//
// Replaces the Pallas microbenchmark P1 of benchmarks/prof/prof_dynslice.py
// (run :51-77, pallas_call :52) and its three bodies (:19-48), which take
// NCH windows of W lanes from one row of `ext` at the offsets of `starts`
// and add them into an (8, W) accumulator, then sum its 8 rows:
//   out[c][j] = 8 * sum_t ext[c][idx(starts[c][t], j)].
// The bodies are three TPU ways to cut a window at a lane offset known only
// at run time. They differ where a window runs past the row's end:
//   kern_roll, kern_roll2d  pltpu.roll wraps: idx = (s + j) mod G   (wrap);
//   kern_ds2d               lax.dynamic_slice clamps the start to
//                           [0, G - W]: idx = clamp(s) + j          (clamp).
// On this card each is an offset load, so one kernel serves all three
// labels with a `clamp` flag; where every window fits (the script's starts
// at G = 512) the two modes agree.
//
// Design: one block per column, one thread per output lane; the thread adds
// its NCH window values in t order and scales by 8 (exact in binary), one
// write per output. The window loads of a warp are W consecutive floats of
// one row, coalesced (and split in two at a wrap). Bound: memory; the
// script's shapes move tens of kilobytes, so a call is launch and latency
// time.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void dynslice_kernel(const int* __restrict__ starts,
                                const T* __restrict__ ext, T* __restrict__ out,
                                int nch, int g, int w, bool clamp) {
  const int c = blockIdx.x;
  const T* row = ext + size_t(c) * g;
  const int* st = starts + size_t(c) * nch;
  for (int j = threadIdx.x; j < w; j += blockDim.x) {
    T acc = T(0);
    for (int t = 0; t < nch; ++t) {
      const int s = st[t];
      int idx;
      if (clamp) {
        idx = min(max(s, 0), g - w) + j;
      } else {
        idx = ((s + j) % g + g) % g;
      }
      acc += row[idx];
    }
    out[size_t(c) * w + j] = T(8) * acc;
  }
}

template <typename T>
int launch(const void* starts, const void* ext, void* out, int ncol, int nch,
           int g, int w, int clamp, void* stream) {
  if (w > g) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = w < 1024 ? ((w + 31) / 32) * 32 : 1024;
  dynslice_kernel<T><<<ncol, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const T*>(ext),
      static_cast<T*>(out), nch, g, w, clamp != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). starts [ncol, nch] int32, ext
// [ncol, g], out [ncol, w]; clamp = 0 wraps, 1 clamps. Launch on `stream`,
// do not synchronise; return cudaGetLastError() (0 = success).
extern "C" int dynslice_f32(const void* starts, const void* ext, void* out,
                            int ncol, int nch, int g, int w, int clamp,
                            void* stream) {
  return launch<float>(starts, ext, out, ncol, nch, g, w, clamp, stream);
}

extern "C" int dynslice_f64(const void* starts, const void* ext, void* out,
                            int ncol, int nch, int g, int w, int clamp,
                            void* stream) {
  return launch<double>(starts, ext, out, ncol, nch, g, w, clamp, stream);
}
