"""The sorted layout's re-bin on the card: the rebuild decision, the local
permutation and the row moves as CUDA kernels, gated by the 0-d rebuild
flag in device memory.

No Pallas kernel is replaced: the JAX package re-bins in XLA
(`ops/sortedforce.py`: needs_rebuild, _local_perm, _apply_perm under the
step's lax.cond). The plain PyTorch version in ops/sortedforce
(`needs_rebuild_reference`, `rebuild_if_reference`,
`rebuild_state_reference`) takes both sides of that cond every step,
about 175 device operations whatever the flag says. The kernels of
`csrc/sorted_rebin.cu` (its head note has the design and the bound):

  `sorted_rebin_decide` (`sorted_rebin_decide_kernel`): the 0-d bool flag
      from the cadence and, with `check`, the valid rows' displacement;
  `sorted_rebin_bin` (`sorted_rebin_bin_kernel`): each valid row's stream
      (its move from its old cell) as one byte, the rows wrapped first
      (Box.wrap) in `rebuild_if`; a move of more than one cell raises the
      overflow flag;
  `sorted_rebin_move` (`sorted_rebin_move_kernel`): every slot of every
      cell written once, in stream then rank order, into other buffers; a
      cell over `cell_cap` raises the overflow flag;
  `sorted_rebin_commit` (`sorted_rebin_commit_kernel`): on a rebuild step
      those buffers into the state's arrays and xhold, in place, and
      ago = 0, nbuilds + 1; on any other step ago + 1.

Bin and move read the flag and return at once where it is false; with no
flag (`rebuild_state`, whose rebuilds the host schedules) they always run,
into fresh arrays, and no commit follows. The host never reads the flag.

In place: `rebuild_if` overwrites the state's type, tag, image, mask, q,
molecule (and its x and v) and the list's xhold, ago, nbuilds and
overflow. The generic segment runner works on its own copies of those
(its carry: integrate/verlet, integrate/graphs), so the caller's state and
list, which a grow-retry keeps as its snapshot, stay as they were.

These functions take CUDA tensors only (ops/sortedforce dispatches: CPU
tensors go to the plain versions there). The per-kernel wrappers launch on
the stream they are given, under the caller's device guard (one a step).
Every launch adds one to its counter: `sorted_rebin_decide.launches`,
`sorted_rebin_bin.launches`, `sorted_rebin_move.launches`,
`sorted_rebin_commit.launches`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import cuda_build

SOURCE = cuda_build.CSRC / "sorted_rebin.cu"
# the per-row arrays the re-bin moves, in the order of the C struct Rows
# (`f` is not moved: every rebuild is followed by a force pass)
FIELDS = ("x", "v", "q", "image", "type", "tag", "mask", "molecule")


class Rows(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in FIELDS]


_PTR, _I32, _F64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ROWS = ctypes.POINTER(Rows)
ARGTYPES = {
    "sorted_rebin_decide": [_PTR] * 5 + [_I32] * 4 + [_F64, _PTR],
    "sorted_rebin_bin": [_PTR] * 7 + [_I32] * 5 + [_PTR],
    "sorted_rebin_move": [_PTR] * 5 + [_ROWS] * 2 + [_I32] * 5 + [_PTR],
    "sorted_rebin_commit": [_PTR] * 3 + [_ROWS] * 2 + [_PTR, _I32, _PTR],
}


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (once per source and flag set) and load the kernel library."""
    lib = cuda_build.load(SOURCE)
    for stem, types in ARGTYPES.items():
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"{stem}_{dt}")
            fn.argtypes = types
            fn.restype = _I32
    return lib


@functools.cache
def _fn(stem: str, dtype):
    return getattr(_library(),
                   f"{stem}_f32" if dtype == torch.float32 else f"{stem}_f64")


def _call(stem: str, counted, dtype, stream: int, *args) -> None:
    """Launch on `stream` (the caller holds the device guard)."""
    err = _fn(stem, dtype)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{stem} launch failed: CUDA error {err}")
    counted.launches += 1


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check_x(x) -> None:
    if x.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64, got {x.dtype}")
    if x.ndim != 2 or x.shape[1] != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous [rows, 3]")
    if 3 * x.shape[0] >= 2**31:
        raise ValueError(f"{x.shape[0]} rows overflow the kernels' int32 "
                         "indices")


def _check_state(state, fields=FIELDS) -> None:
    """The arrays the kernels read (`fields` of them): on one CUDA device,
    contiguous, x and v [rows, 3] of float32 or float64, image [rows, 3]
    and type, tag, mask, molecule [rows] int32, q [rows] of x's dtype; a
    fully periodic orthogonal box of x's dtype."""
    x = state.x
    _check_x(x)
    rows = x.shape[0]
    for name in fields:
        a = getattr(state, name)
        if a is None and name in ("q", "molecule"):
            continue
        shape = (rows, 3) if name in ("x", "v", "image") else (rows,)
        dtype = x.dtype if name in ("x", "v", "q") else torch.int32
        if (a.shape != shape or a.dtype != dtype or a.device != x.device
                or not a.is_contiguous()):
            raise ValueError(f"state.{name} must be a contiguous {dtype} "
                             f"{list(shape)} on {x.device}")
    box = state.box
    if not all(box.periodic):
        raise NotImplementedError("the re-bin kernels wrap every axis: the "
                                  "sorted layout needs a periodic box")
    for t in (box.lo, box.hi):
        if t.dtype != x.dtype or t.device != x.device or t.shape != (3,):
            raise ValueError("box lo and hi must be [3] of x's dtype and "
                             "device")


def _check_grid(state, cl) -> None:
    nx, ny, nz = cl.params.ncells
    if state.x.shape[0] != nx * ny * nz * cl.params.cell_cap:
        raise ValueError(f"{state.x.shape[0]} rows are not the layout's "
                         f"{nx} x {ny} x {nz} cells of {cl.params.cell_cap}")
    if cl.overflow.dtype != torch.bool or cl.overflow.numel() != 1:
        raise ValueError("overflow must be one bool")


def _rows(arrays: dict) -> Rows:
    return Rows(**{name: _ptr(arrays.get(name)) for name in FIELDS})


def _fields(state) -> dict:
    return {name: getattr(state, name) for name in FIELDS}


def _scratch(state) -> tuple[torch.Tensor, dict]:
    """One buffer for the moved rows of a gated re-bin and the stream codes:
    (the buffer, which must live until the launches are enqueued, and
    {field: pointer into it, "code": pointer})."""
    rows = state.x.shape[0]
    size = state.x.element_size()
    per = {"x": 3 * size, "v": 3 * size, "q": size, "image": 12, "type": 4,
           "tag": 4, "mask": 4, "molecule": 4, "code": 1}
    offsets, total = {}, 0
    for name, nbytes in per.items():
        if name in ("q", "molecule") and getattr(state, name) is None:
            continue
        offsets[name] = total
        total += -(-nbytes * rows // 256) * 256
    buf = torch.empty(total, dtype=torch.uint8, device=state.x.device)
    base = buf.data_ptr()
    return buf, {name: base + off for name, off in offsets.items()}


def sorted_rebin_decide(stream: int, x, xhold, mask, ago, flag, delay: int,
                        every: int, check: bool, half_skin_sq: float) -> None:
    """Write the rebuild decision into the 0-d bool `flag`: (ago+1 >=
    delay) & ((ago+1) % every == 0), and with `check` a valid row (mask
    nonzero) displaced from xhold by more than half_skin_sq (compared in
    x's dtype). x, xhold [rows, 3] (xhold is not read without `check`);
    ago int64 [1]. Launches `sorted_rebin_decide_kernel`."""
    if (ago.dtype != torch.int64 or ago.numel() != 1
            or flag.dtype != torch.bool or flag.numel() != 1):
        raise ValueError("ago must be one int64, flag one bool")
    if check and (xhold.shape != x.shape or xhold.dtype != x.dtype
                  or not xhold.is_contiguous()):
        raise ValueError("xhold must be a contiguous copy of x's shape and "
                         "dtype")
    _call("sorted_rebin_decide", sorted_rebin_decide, x.dtype, stream,
          x.data_ptr(), xhold.data_ptr(), mask.data_ptr(), ago.data_ptr(),
          flag.data_ptr(), x.shape[0], delay, max(every, 1), int(check),
          half_skin_sq)


def sorted_rebin_bin(stream: int, flag, x, mask, lo, hi, code, overflow,
                     ncells, cc: int, wrap: bool) -> None:
    """Each row's stream code (uint8 [rows]; 0xff on pad rows) where the
    0-d bool `flag` is set (always where `flag` is None); raises
    `overflow` on a move of more than one cell. Launches
    `sorted_rebin_bin_kernel`."""
    nx, ny, nz = ncells
    _call("sorted_rebin_bin", sorted_rebin_bin, x.dtype, stream, _ptr(flag),
          x.data_ptr(), mask.data_ptr(), lo.data_ptr(), hi.data_ptr(), code,
          overflow.data_ptr(), nx, ny, nz, cc, int(wrap))


def sorted_rebin_move(stream: int, flag, code, lo, hi, overflow, src: Rows,
                      dst: Rows, dtype, ncells, cc: int, wrap: bool) -> None:
    """Every slot of every cell of `dst` from the rows of `src` (of
    `dtype`) and their codes where the flag is set (always where it is
    None); raises `overflow` on a cell over `cc`. Launches
    `sorted_rebin_move_kernel`."""
    nx, ny, nz = ncells
    _call("sorted_rebin_move", sorted_rebin_move, dtype, stream, _ptr(flag),
          code, lo.data_ptr(), hi.data_ptr(), overflow.data_ptr(),
          ctypes.byref(src), ctypes.byref(dst), nx, ny, nz, cc, int(wrap))


def sorted_rebin_commit(stream: int, flag, ago, nbuilds, src: Rows,
                        dst: Rows, xhold, rows: int) -> None:
    """Where the flag is set: `src` into `dst` and src's x into xhold, ago
    = 0, nbuilds + 1; else ago + 1. Launches
    `sorted_rebin_commit_kernel`."""
    if nbuilds.dtype != torch.int64 or nbuilds.numel() != 1:
        raise ValueError("nbuilds must be one int64")
    _call("sorted_rebin_commit", sorted_rebin_commit, xhold.dtype, stream,
          flag.data_ptr(), ago.data_ptr(), nbuilds.data_ptr(),
          ctypes.byref(src), ctypes.byref(dst), xhold.data_ptr(), rows)


sorted_rebin_decide.launches = 0
sorted_rebin_bin.launches = 0
sorted_rebin_move.launches = 0
sorted_rebin_commit.launches = 0
KERNELS = ("sorted_rebin_decide", "sorted_rebin_bin", "sorted_rebin_move",
           "sorted_rebin_commit")


# ---- the sortedforce functions on CUDA tensors -----------------------------

def needs_rebuild(state, cl) -> torch.Tensor:
    """ops/sortedforce.needs_rebuild on the card: a new 0-d bool tensor."""
    _check_state(state, ("mask",))
    p = cl.params
    x = state.x
    flag = torch.empty((), dtype=torch.bool, device=x.device)
    xhold = cl.xhold if p.check else x
    with torch.cuda.device(x.device):
        sorted_rebin_decide(_stream(x), x, xhold, state.mask, cl.ago, flag,
                            p.delay, p.every, p.check, (0.5 * p.skin) ** 2)
    return flag


def rebuild_if(state, cl, rebuild: torch.Tensor):
    """ops/sortedforce.rebuild_if on the card, in place: the state's arrays
    and the list's xhold, ago, nbuilds and overflow are updated where they
    are; returns (state, cl) as given."""
    _check_state(state)
    _check_grid(state, cl)
    if rebuild.dtype != torch.bool or rebuild.numel() != 1:
        raise ValueError("rebuild must be one bool")
    p = cl.params
    x, box = state.x, state.box
    buf, ptrs = _scratch(state)
    scratch = Rows(**{name: ptrs.get(name) for name in FIELDS})
    rows = _rows(_fields(state))
    with torch.cuda.device(x.device):
        stream = _stream(x)
        sorted_rebin_bin(stream, rebuild, x, state.mask, box.lo, box.hi,
                         ptrs["code"], cl.overflow, p.ncells, p.cell_cap,
                         True)
        sorted_rebin_move(stream, rebuild, ptrs["code"], box.lo, box.hi,
                          cl.overflow, rows, scratch, x.dtype, p.ncells,
                          p.cell_cap, True)
        sorted_rebin_commit(stream, rebuild, cl.ago, cl.nbuilds, scratch,
                            rows, cl.xhold, x.shape[0])
    del buf  # freed after the launches: the stream orders any reuse
    return state, cl


def rebuild_state(state, old):
    """ops/sortedforce.rebuild_state on the card: a state with the
    re-binned rows in fresh arrays (the state given is not changed); the
    list's overflow flag is raised in place."""
    _check_state(state)
    _check_grid(state, old)
    p = old.params
    out = {name: None if a is None else torch.empty_like(a)
           for name, a in _fields(state).items()}
    x, box = state.x, state.box
    code = torch.empty(x.shape[0], dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = _stream(x)
        sorted_rebin_bin(stream, None, x, state.mask, box.lo, box.hi,
                         code.data_ptr(), old.overflow, p.ncells, p.cell_cap,
                         False)
        sorted_rebin_move(stream, None, code.data_ptr(), box.lo, box.hi,
                          old.overflow, _rows(_fields(state)), _rows(out),
                          x.dtype, p.ncells, p.cell_cap, False)
    return dataclasses.replace(state, **{k: v for k, v in out.items()
                                         if v is not None})
