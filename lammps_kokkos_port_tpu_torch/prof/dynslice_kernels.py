"""P1, the dynamic lane-window sum of prof_dynslice.py: CUDA for Hopper,
plus its plain twin.

Replaces the Pallas microbenchmark of benchmarks/prof/prof_dynslice.py
(`run` :51-77, pallas_call :52; bodies `kern_roll`, `kern_roll2d` and
`kern_ds2d` :19-48). For each column c of `ext` [ncol, G] it takes the
windows of W lanes that start at `starts[c, t]`, t < nch, and returns
out[c, j] = 8 * sum_t ext[c, idx(starts[c, t], j)] (the bodies add each
window to every row of an (8, W) accumulator and sum its rows). Modes:

  "wrap"   idx = (s + j) mod G: pltpu.roll, the labels roll-1d-dyn and
           roll-2d-dyn;
  "clamp"  idx = min(s, G - W) + j (the start clamped to [0, G - W]):
           lax.dynamic_slice, the label dynslice-2d.

Where every window fits in the row the modes agree (the script's starts at
G = 512); at G = 128, the shape the script's timed loop really ran, "wrap"
sums circular shifts and "clamp" sums the row itself nch times.

`dynslice` is the entry point: CPU tensors go to `dynslice_reference`, CUDA
tensors to csrc/dynslice.cu (ops/cuda_build) or raise; `.launches` counts
the CUDA launches. No single PyTorch call computes it (the plain twin takes
a gather, a sum and a scale).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import cuda_build

SOURCE = cuda_build.CSRC / "dynslice.cu"
MODES = ("wrap", "clamp")


def _check(starts, ext, w, mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if starts.dtype != torch.int32 or starts.ndim != 2:
        raise ValueError("starts must be a [ncol, nch] int32 tensor")
    if ext.ndim != 2 or ext.shape[0] != starts.shape[0]:
        raise ValueError(f"ext must be [ncol={starts.shape[0]}, G], got "
                         f"{tuple(ext.shape)}")
    if not 1 <= w <= ext.shape[1]:
        raise ValueError(f"window {w} must be in [1, G={ext.shape[1]}]")
    if starts.device != ext.device:
        raise ValueError("starts and ext must share a device")


def _window_index(starts, g: int, w: int, mode: str):
    """[ncol, nch, w] lane indices of every window."""
    j = torch.arange(w, device=starts.device)
    s = starts.long()[..., None]
    if mode == "wrap":
        return torch.remainder(s + j, g)
    return torch.clamp(s, 0, g - w) + j


def dynslice_reference(starts, ext, w: int = 128, mode: str = "wrap"):
    """Plain PyTorch P1: the windows gathered, summed over t in order and
    scaled by 8. Returns [ncol, w] in ext's dtype."""
    _check(starts, ext, w, mode)
    win = torch.gather(ext[:, None, :].expand(-1, starts.shape[1], -1), 2,
                       _window_index(starts, ext.shape[1], w, mode))
    acc = torch.zeros((ext.shape[0], w), dtype=ext.dtype, device=ext.device)
    for t in range(starts.shape[1]):
        acc = acc + win[:, t]
    return 8.0 * acc


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source and flag set) and load the kernel library."""
    lib = cuda_build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("dynslice_f32", "dynslice_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 3 + [i32] * 5 + [ptr]
        fn.restype = i32
    return lib


def dynslice(starts, ext, w: int = 128, mode: str = "wrap"):
    """out[c, j] = 8 * sum_t ext[c, idx(starts[c, t], j)], j < w, with the
    window index of `mode` ("wrap" or "clamp"). starts: [ncol, nch] int32;
    ext: [ncol, G] float32 or float64. Returns [ncol, w]."""
    _check(starts, ext, w, mode)
    if ext.device.type == "cpu":
        return dynslice_reference(starts, ext, w, mode)
    if ext.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {ext.device}")
    if ext.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dynslice takes float32 or float64, got {ext.dtype}")
    if not (starts.is_contiguous() and ext.is_contiguous()):
        raise ValueError("dynslice inputs must be contiguous")
    ncol, nch = starts.shape
    out = torch.empty((ncol, w), dtype=ext.dtype, device=ext.device)
    fn = getattr(_library(),
                 "dynslice_f32" if ext.dtype == torch.float32
                 else "dynslice_f64")
    with torch.cuda.device(ext.device):
        stream = torch.cuda.current_stream(ext.device).cuda_stream
        err = fn(starts.data_ptr(), ext.data_ptr(), out.data_ptr(), ncol,
                 nch, ext.shape[1], w, int(mode == "clamp"), stream)
    if err != 0:
        raise RuntimeError(f"dynslice launch failed: CUDA error {err}")
    dynslice.launches += 1
    return out


dynslice.launches = 0
