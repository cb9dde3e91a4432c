"""P12, the z-window Newton-half column prototype of prof_zwin_proto.py:
CUDA for Hopper, plus its plain twins.

Replaces the Pallas kernel of benchmarks/prof/prof_zwin_proto.py (`run`
:103-122, pallas_call :108, kernel :34-100), a throughput probe of a
z-window column kernel's op mix on synthetic inputs (its numbers are not
physics). For each column `pid` and chunk k of 8 own atoms (rows 8k..8k+7
of xT, yT, zT [S, NCOL]) it forms NLANE = WS + 4 WN candidate lanes: the own
column's window e*[pid, G + 8k : + WS] and four windows e*[nb_w, st_w + k :
+ WN] of the columns nb_w = (pid + off_w) mod NCOL, off = (+1, -1, +12,
-12), at st_w = starts[pid, 0, w] (row 0 of the column's start rows only).
Lane l < WS with l <= i is biased out for own atom i; a pair within CUTSQ
takes fpair from the approximate reciprocal refined by one Newton step.
Outputs: the forward sums fT* [S, NCOL] and the reactions, -sum_i fij of
each lane, added into the lanes' windows of fL* [NCOL, SE].

The TPU body adds the reaction windows into other columns and is race-free
only on the in-order TPU grid; csrc/zwin_proto.cu computes both outputs as
gathers in one launch: each forward sum over its own atom's lanes, and each
reaction element fL*[c, p] over the own atoms whose windows hold the
candidate e*[c, p] (each written once, no atomics, no scratch; one call in
`.launches`). Every shape the script fixes is a field of `ZwinShape`, so
the tests run a small one. f32 only (the approximate reciprocal). The
script's projection of atom-steps/s from TPU constants has no counterpart.
The windows must lie in their rows: the own window of the last chunk
(WS <= G + 8, checked) and each neighbour window, st_w + NPC - 1 + WN <=
SE (not checked: the starts live on the device; the twin raises, the
kernel reads past the row).

The script's uniform random inputs hold a few near-coincident pairs, whose
forces reach 1e14 while the rest are of order 1, so a tolerance scaled by
max|f| would pass a wrong window. A kernel is held instead to
`zwin_reference(..., magnitude=True)`, each element's sum of the magnitudes
of its terms, through `max_scaled_error`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..ops import cuda_build

SOURCE = cuda_build.CSRC / "zwin_proto.cu"
OWN = 8  # own atoms per chunk (the body's sublanes)
CUTSQ, LJ1, LJ2 = 6.25, 48.0, 24.0  # the script's constants (:30-31)
BIAS = 1e9  # the self-forward segment's bias (:49)


@dataclasses.dataclass(frozen=True)
class ZwinShape:
    """The script's shapes (:25-29, :52-53); the defaults are its own, the
    32k-equivalent ncol 144, S 256."""

    ncol: int = 144
    s: int = 256
    g: int = 32
    ws: int = 32
    wn: int = 56
    offsets: tuple = (1, -1, 12, -12)

    @property
    def se(self) -> int:
        return self.s + 2 * self.g

    @property
    def npc(self) -> int:
        return self.s // OWN

    @property
    def nlane(self) -> int:
        return self.ws + 4 * self.wn

    @property
    def lane_pairs(self) -> int:
        """(own atom, lane) pairs: each needs its r2 and cutoff test."""
        return self.ncol * self.s * self.nlane


def zwin_inputs(shape: ZwinShape = ZwinShape(), seed: int = 0, device="cpu"):
    """The script's inputs (:125-134), drawn with numpy in its order from
    its seed: ex, ey, ez [NCOL, SE] and xT, yT, zT [S, NCOL] uniform in
    [0, 30), starts [NCOL, NPC, 4] int32 in [0, SE - WN - NPC - 1). (The
    script's prd is never read by its kernel.)"""
    rng = np.random.default_rng(seed)
    e = [rng.random((shape.ncol, shape.se), dtype=np.float32) * 30
         for _ in range(3)]
    t = [rng.random((shape.s, shape.ncol), dtype=np.float32) * 30
         for _ in range(3)]
    starts = rng.integers(0, shape.se - shape.wn - shape.npc - 1,
                          size=(shape.ncol, shape.npc, 4)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (*e, *t, starts))


def _check(shape, ex, ey, ez, xT, yT, zT, starts):
    if (shape.s % OWN or shape.npc < 1 or len(shape.offsets) != 4
            or shape.ws > shape.g + OWN):
        raise ValueError(f"bad shape {shape}")
    want = {"e": (shape.ncol, shape.se), "T": (shape.s, shape.ncol)}
    for name, a, kind in (("ex", ex, "e"), ("ey", ey, "e"), ("ez", ez, "e"),
                          ("xT", xT, "T"), ("yT", yT, "T"), ("zT", zT, "T")):
        if tuple(a.shape) != want[kind] or a.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {want[kind]}, got "
                             f"{a.dtype} {tuple(a.shape)}")
        if a.device != ex.device:
            raise ValueError("zwin inputs must share a device")
    if (starts.dtype != torch.int32 or tuple(starts.shape)
            != (shape.ncol, shape.npc, 4) or starts.device != ex.device):
        raise ValueError(f"starts must be int32 {(shape.ncol, shape.npc, 4)}"
                         f" on the inputs' device")


def _windows(shape, e, st0, k):
    """[NCOL, NLANE] candidates of chunk k from one e* channel."""
    pid = torch.arange(shape.ncol, device=e.device)
    parts = [e[:, shape.g + OWN * k: shape.g + OWN * k + shape.ws]]
    for w, off in enumerate(shape.offsets):
        pos = st0[:, w, None] + k + torch.arange(shape.wn, device=e.device)
        parts.append(e[torch.remainder(pid + off, shape.ncol)[:, None], pos])
    return torch.cat(parts, dim=1)


def zwin_reference(ex, ey, ez, xT, yT, zT, starts, shape=ZwinShape(),
                   magnitude=False):
    """Plain PyTorch P12: the body's math chunk by chunk, vectorised over
    the columns (the reciprocal exact before its Newton step). Returns
    (fTx, fTy, fTz, fLx, fLy, fLz). The reactions are added into fL window
    by window, in order.

    With `magnitude`, each element is instead the sum over its pairs of
    |d_c| r2i r6 (LJ1 r6 + LJ2): the size of the terms its rounding acts
    on, against which two sums of the same pairs in other orders, with
    reciprocals a few ulp apart, differ by a small fraction."""
    _check(shape, ex, ey, ez, xT, yT, zT, starts)
    dev = ex.device
    st0 = starts[:, 0, :].long()
    pid = torch.arange(shape.ncol, device=dev)
    lane = torch.arange(shape.nlane, device=dev)
    sub = torch.arange(OWN, device=dev)
    bias = torch.where((lane[None, :] < shape.ws)
                       & (lane[None, :] <= sub[:, None]), BIAS, 0.0)
    lj2 = -LJ2 if magnitude else LJ2
    fT = [torch.zeros_like(a) for a in (xT, yT, zT)]
    fL = [torch.zeros_like(a) for a in (ex, ey, ez)]
    for k in range(shape.npc):
        d = [t[OWN * k: OWN * (k + 1)].t()[:, :, None]
             - _windows(shape, e, st0, k)[:, None, :]
             for t, e in zip((xT, yT, zT), (ex, ey, ez))]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + bias
        valid = r2 < CUTSQ
        y = 1.0 / r2
        r2i = y * (2.0 - r2 * y)
        r6 = r2i * r2i * r2i
        fp = torch.where(valid, r6 * (LJ1 * r6 - lj2) * r2i, 0.0)
        for c in range(3):
            fij = (d[c].abs() if magnitude else d[c]) * fp  # [NCOL, 8, NLANE]
            fT[c][OWN * k: OWN * (k + 1)] = fij.sum(-1).t()
            r = fij.sum(-2)
            lo = shape.g + OWN * k
            fL[c][:, lo: lo + shape.ws] -= r[:, :shape.ws]
            for w, off in enumerate(shape.offsets):
                pos = st0[:, w, None] + k + torch.arange(shape.wn, device=dev)
                a = shape.ws + w * shape.wn
                fL[c].index_put_(
                    (torch.remainder(pid + off, shape.ncol)[:, None], pos),
                    -r[:, a: a + shape.wn], accumulate=True)
    out = (*fT, *fL)
    return tuple(a.abs() for a in out) if magnitude else out


def max_scaled_error(got, ref, scale) -> float:
    """The largest |got - ref| / scale over the elements of the sequences
    `got`, `ref` and `scale` (zwin_reference's outputs, plain and with
    `magnitude`): 0 where an element has no terms and both are 0, inf where
    such an element is not 0. A kernel agrees with the twin when this is
    small (about 1e-6 in f32); a term dropped, moved or added makes it of
    order 1 in the elements that term dominates."""
    worst = 0.0
    for a, b, s in zip(got, ref, scale, strict=True):
        err = (a.double() - b.double()).abs()
        ratio = torch.where(err > 0, err / s.double(), 0.0)
        worst = max(worst, float(ratio.max()))
    return worst


def pairs_in_cutoff(ex, ey, ez, xT, yT, zT, starts, shape=ZwinShape()):
    """The (own atom, lane) pairs that pass the mask on these inputs: the
    work a pass needs, for its bound."""
    _check(shape, ex, ey, ez, xT, yT, zT, starts)
    st0 = starts[:, 0, :].long()
    lane = torch.arange(shape.nlane, device=ex.device)
    sub = torch.arange(OWN, device=ex.device)
    live = ~((lane[None, :] < shape.ws) & (lane[None, :] <= sub[:, None]))
    n = 0
    for k in range(shape.npc):
        r2 = sum((t[OWN * k: OWN * (k + 1)].t()[:, :, None]
                  - _windows(shape, e, st0, k)[:, None, :]) ** 2
                 for t, e in zip((xT, yT, zT), (ex, ey, ez)))
        n += int(((r2 < CUTSQ) & live).sum())
    return n


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source and flag set) and load the kernel library."""
    lib = cuda_build.load(SOURCE)
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.zwin_proto_f32.argtypes = [ptr] * 13 + [i32] * 9 + [f64] * 3 + [ptr]
    lib.zwin_proto_f32.restype = i32
    return lib


def zwin_proto(ex, ey, ez, xT, yT, zT, starts, shape=ZwinShape()):
    """P12 on `shape`: ex, ey, ez [NCOL, SE] and xT, yT, zT [S, NCOL]
    float32, starts [NCOL, NPC, 4] int32. Returns (fTx, fTy, fTz, fLx, fLy,
    fLz). CPU tensors go to `zwin_reference`; CUDA tensors to the kernel's
    one launch (`zwin_proto.launches`)."""
    _check(shape, ex, ey, ez, xT, yT, zT, starts)
    if ex.device.type == "cpu":
        return zwin_reference(ex, ey, ez, xT, yT, zT, starts, shape)
    inputs = (ex, ey, ez, xT, yT, zT, starts)
    if ex.device.type != "cuda" or not all(a.is_contiguous() for a in inputs):
        raise ValueError("zwin kernel inputs must be contiguous CUDA tensors")
    fT = [torch.empty_like(a) for a in (xT, yT, zT)]
    fL = [torch.empty_like(a) for a in (ex, ey, ez)]
    with torch.cuda.device(ex.device):
        stream = torch.cuda.current_stream(ex.device).cuda_stream
        err = _library().zwin_proto_f32(
            *(a.data_ptr() for a in (*inputs, *fT, *fL)),
            shape.ncol, shape.s, shape.g, shape.ws, shape.wn, *shape.offsets,
            CUTSQ, LJ1, LJ2, stream)
    if err != 0:
        raise RuntimeError(f"zwin_proto launch failed: CUDA error {err}")
    zwin_proto.launches += 1
    return (*fT, *fL)


zwin_proto.launches = 0
