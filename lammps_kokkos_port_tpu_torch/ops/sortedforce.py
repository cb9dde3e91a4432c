"""Cell-major (sorted) state mode: the state itself is stored in cell order.

Port of `lammps_kokkos_port_tpu/ops/sortedforce.py` (the analog of the
reference's spatial atom sort, src/atom.cpp:2246 Atom::sort, made the
layout itself):

  - state capacity = ncells * cell_cap; every cell owns a fixed slab of
    rows, padding rows have mask 0;
  - at every neighbor rebuild the per-atom arrays are permuted into the new
    cell assignment (`rebuild_state` on steps the host schedules,
    `needs_rebuild` + `rebuild_if` where the device decides; on the card
    the kernels of ops/rebin_kernels, on the CPU the plain versions here);
  - the force passes read positions in grid layout and write forces in the
    same layout (each pair style's "sorted" path, models/pair.ForcePaths:
    ops/pair_kernels for lj/cut, ops/eamdense and ops/eam_kernels for EAM,
    ops/tersoff_kernels for Tersoff), so a force pass has no gathers or
    scatters at all. This module holds the layout alone and imports no
    force module.

JAX's clamped gathers and dropping scatters become explicit masks here:
PyTorch raises on out-of-range indices.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np
import torch

from ..core.state import State
from ..utils import trace
from . import neighbor as nbr
from . import rebin_kernels

# padding rows carry DISTINCT position sentinels (PAD_POS + row*PAD_STEP on
# the space diagonal): pad-real pairs fail the cutoff by distance, and
# pad-pad pairs do too (rows differ by >= PAD_STEP in every component), so
# the force kernel needs no validity lanes (f32 note: ulp(1e8) = 8, so steps
# of 16 stay exactly representable across multi-million-row capacities)
PAD_POS = 1.0e8
PAD_STEP = 16.0
# the first width of a three-body style's short list: diamond Si has 4
# neighbours within Tersoff's R + D; the grow-retry widens it
SHORT_CAP = 16


def _pad_x(cap: int, dtype, device) -> torch.Tensor:
    """[cap] distinct diagonal pad sentinel per row."""
    return (torch.tensor(PAD_POS, dtype=dtype, device=device)
            + torch.arange(cap, dtype=dtype, device=device) * PAD_STEP)


@dataclasses.dataclass(frozen=True)
class SortedCells:
    """Rebuild bookkeeping; the cell buckets are the state layout itself.

    `ago` (steps since the last rebuild) and `nbuilds` are host ints
    between segments: the cadence-only fused segment (integrate/fused.py)
    keeps them so, since the host knows its rebuild schedule. The
    distance-checked step (integrate/verlet.make_step) decides on the
    device and carries them as 0-d device tensors inside a segment;
    `read_back` brings them to the host with the overflow flag. `overflow`
    is a sticky 0-d bool tensor on the device. `xhold` holds the positions
    of the last rebuild, for the distance check (`needs_rebuild`). (The
    JAX version's `ndanger` counter is not ported.)

    A three-body style (ops/tersoff_kernels) builds a short list of `short_cap`
    neighbours a row at each force pass. `short_need` is a 0-d int32 tensor
    made at `build` and carried by reference through every rebuild of the
    segment: the short-list kernel raises it, in place, to the count of a
    row that did not fit (and sets `overflow`), so the host's grow-retry
    can tell a short-list overflow from a cell overflow
    (runner._grow_params).
    """

    list_mode: ClassVar[str] = "sorted"

    ago: int | torch.Tensor
    nbuilds: int | torch.Tensor
    overflow: torch.Tensor
    params: nbr.NeighborParams
    xhold: torch.Tensor | None = None
    short_cap: int = SHORT_CAP
    short_need: torch.Tensor | None = None


def expand_state(state: State, p: nbr.NeighborParams) -> State:
    """Host-side: compact the valid rows and re-pad to capacity
    ncells*cell_cap (rows beyond the atoms are mask-0 padding). Accepts any
    incoming layout, including an already-sorted one of another
    capacity."""
    cap2 = p.total_cells * p.cell_cap
    cap = state.capacity
    rows = np.flatnonzero(state.valid_mask.cpu().numpy())
    if len(rows) > cap2:
        raise ValueError(
            f"sorted capacity {cap2} cannot hold {len(rows)} atoms")

    def repack(a, fill=0):
        if a is None or a.ndim == 0 or a.shape[0] != cap:
            return a
        host = a.cpu().numpy()
        out = np.full((cap2,) + host.shape[1:], fill, dtype=host.dtype)
        out[:len(rows)] = host[rows]
        return torch.from_numpy(out).to(state.device)

    xr = repack(state.x, fill=PAD_POS).cpu().numpy()
    pr = np.arange(len(rows), cap2)
    xr[len(rows):] = (PAD_POS + pr[:, None] * PAD_STEP)
    return state.replace(
        x=torch.from_numpy(xr).to(state.device), v=repack(state.v),
        f=repack(state.f), type=repack(state.type), tag=repack(state.tag),
        image=repack(state.image), q=repack(state.q),
        molecule=repack(state.molecule), mask=repack(state.mask),
        owned_all=True,  # rows scatter across cells; every valid row owned
    )


def _local_perm(state: State, p: nbr.NeighborParams):
    """Sort-free re-binning for an ALREADY cell-major state.

    Between rebuilds atoms move at most ~skin, i.e. at most one cell. Each
    row's old cell is implied by its position in the layout (row //
    cell_cap), so the new slot assignment reduces to 27 "streams" (one per
    cell offset) with per-cell exclusive sums — no sort. If an atom moved
    more than one cell, or a cell overflows, the sticky overflow flag makes
    the host redo the segment through the full-sort `build`.

    Returns (newpos [cap] int64 forward destinations, == cap for padding
    rows, overflow 0-d bool tensor).
    """
    cap = state.capacity
    cc = p.cell_cap
    ntot = p.total_cells
    nx, ny, nz = p.ncells
    dev = state.device
    dims = torch.tensor([nx, ny, nz], dtype=torch.int32, device=dev)

    # new cell coords from positions (same mapping as nbr._bin_atoms)
    lamda = state.box.to_lamda(state.x)
    frac = lamda - torch.floor(lamda)
    frac = torch.clamp(frac, 0.0, 1.0 - 1e-7)
    c_new = torch.floor(frac * dims.to(frac.dtype)).to(torch.int32)
    c_new = torch.minimum(torch.clamp(c_new, min=0), dims - 1)  # [cap, 3]

    # old cell coords are static per row
    row = torch.arange(cap, dtype=torch.int32, device=dev)
    oldcell = row // cc
    ox = oldcell // (ny * nz)
    rem = oldcell - ox * (ny * nz)
    c_old = torch.stack([ox, rem // nz, rem - (rem // nz) * nz], dim=1)

    d = c_new - c_old
    half = dims // 2
    d = torch.where(d > half, d - dims, torch.where(d < -half, d + dims, d))
    valid = state.valid_mask
    moved_far = ((d.abs() > 1) & valid[:, None]).any()

    o = (d[:, 0] + 1) * 9 + (d[:, 1] + 1) * 3 + (d[:, 2] + 1)  # 0..26
    o = torch.clamp(o, 0, 26)

    # rank of each slot among same-(cell, stream) slots, and per-(cell,
    # stream) counts (integer sums in int32, as the JAX version does)
    o_rs = o.reshape(ntot, cc)
    v_rs = valid.reshape(ntot, cc)
    lane = torch.arange(cc, dtype=torch.int32, device=dev)
    ltri = lane[:, None] > lane[None, :]
    oeq = ((o_rs[:, :, None] == o_rs[:, None, :])
           & ltri[None, :, :] & v_rs[:, None, :])
    rank = oeq.sum(dim=-1, dtype=torch.int32).reshape(cap)
    streams = torch.arange(27, dtype=torch.int32, device=dev)
    oh = (o_rs[:, :, None] == streams[None, None, :]) & v_rs[:, :, None]
    counts = oh.sum(dim=1, dtype=torch.int32)  # [ntot, 27]

    # arrivals at dest cell from stream k originate at dest - offset_k
    counts3 = counts.reshape(nx, ny, nz, 27)
    offs = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]
    arr = torch.stack(
        [torch.roll(counts3[..., k], offs[k], dims=(0, 1, 2))
         for k in range(27)], dim=-1)  # [nx, ny, nz, 27]
    cell_overflow = arr.sum(dim=-1).max() > cc
    base = (torch.cumsum(arr, dim=-1, dtype=torch.int32) - arr).reshape(-1)

    dcell = (c_new[:, 0] * ny + c_new[:, 1]) * nz + c_new[:, 2]
    slot = base[(dcell * 27 + o).long()] + rank
    newpos = dcell.long() * cc + torch.clamp(slot, max=cc - 1)
    return torch.where(valid, newpos, cap), moved_far | cell_overflow


def _gather(state: State, perm, with_f: bool) -> State:
    """Row r of every per-atom array taken from row perm[r] (`perm` [cap]
    int64; entries >= cap make r a padding row: zeros, mask 0 and its pad
    sentinel position). `f` is gathered too where `with_f`, else left as
    it is."""
    cap = state.capacity
    dev = state.device
    valid = perm < cap
    safe = torch.clamp(perm, max=cap - 1)

    def g(a):
        if a is None:
            return None
        sel = valid.reshape([-1] + [1] * (a.ndim - 1))
        return torch.where(sel, a[safe], torch.zeros((), dtype=a.dtype,
                                                      device=dev))

    x = torch.where(valid[:, None], state.x[safe],
                    _pad_x(cap, state.dtype, dev)[:, None])
    return state.replace(
        x=x, v=g(state.v), f=g(state.f) if with_f else state.f,
        type=g(state.type), tag=g(state.tag), image=g(state.image),
        q=g(state.q), molecule=g(state.molecule), mask=g(state.mask),
    )


def _apply_perm(state: State, newpos, overflow):
    """Move every row to its destination slot (`newpos` [cap]; entries
    >= cap are dropped). The forward map is inverted with one scatter into
    `perm`, then each per-atom array is gathered once. `f` is not moved:
    every rebuild is followed by a force evaluation."""
    cap = state.capacity
    dev = state.device
    keep = newpos < cap
    perm = torch.full((cap,), cap, dtype=torch.int64, device=dev)
    perm[newpos[keep]] = torch.arange(cap, device=dev)[keep]
    return _gather(state, perm, with_f=False), overflow


def _permute(state: State, p: nbr.NeighborParams):
    """Permute all per-atom arrays, `f` included, into cell-major order.
    Returns (state_sorted, cell_overflow)."""
    _, buckets, overflow = nbr._bin_atoms(state, p)
    perm = buckets[:p.total_cells].reshape(-1).long()  # == cap -> padding
    return _gather(state, perm, with_f=True), overflow


@trace.spanned("neigh")
def build(state: State, p: nbr.NeighborParams, short_cap: int = SHORT_CAP):
    """Sort the (already expanded) state; returns (state, SortedCells)."""
    state, overflow = _permute(state, p)
    return state, SortedCells(
        ago=0, nbuilds=1, overflow=overflow, params=p, xhold=state.x,
        short_cap=short_cap,
        short_need=torch.zeros((), dtype=torch.int32, device=state.device))


def rebuild_state_reference(state: State, old: SortedCells):
    """The plain version of `rebuild_state`: the local permutation and the
    gathers of _local_perm and _apply_perm, in fresh arrays."""
    newpos, overflow = _local_perm(state, old.params)
    state, overflow = _apply_perm(state, newpos, overflow)
    return state, SortedCells(ago=0, nbuilds=old.nbuilds + 1,
                              overflow=old.overflow | overflow,
                              params=old.params, xhold=state.x,
                              short_cap=old.short_cap,
                              short_need=old.short_need)


@trace.spanned("neigh")
def rebuild_state(state: State, old: SortedCells):
    """In-step rebuild of a wrapped state on a step the host knows
    rebuilds (the fused segment's cadence): the sort-free local re-binning
    (atoms move <= one cell between rebuilds; violations raise the sticky
    overflow flag and the host replays the segment through the full-sort
    `build`). The re-binned rows are fresh arrays; `ago` and `nbuilds`
    are host ints or device tensors as given. CPU tensors take the plain
    version; CUDA tensors the bin and move kernels of ops/rebin_kernels
    with no flag, which raise `old.overflow` in place."""
    trace.count("neigh.rebin_passes")
    if state.device.type == "cpu":
        return rebuild_state_reference(state, old)
    # the fused segment hands views of its planar [3, rows] arrays
    state = rebin_kernels.rebuild_state(
        state.replace(x=state.x.contiguous(), v=state.v.contiguous(),
                      image=state.image.contiguous()), old)
    return state, dataclasses.replace(old, ago=0, nbuilds=old.nbuilds + 1,
                                      xhold=state.x)


def tick(cl: SortedCells) -> SortedCells:
    return dataclasses.replace(cl, ago=cl.ago + 1)


def needs_rebuild_reference(state: State, cl: SortedCells) -> torch.Tensor:
    """The plain version of `needs_rebuild`."""
    p = cl.params
    ago = cl.ago + 1
    cadence = (ago >= p.delay) & (torch.remainder(ago, max(p.every, 1)) == 0)
    if not p.check:
        return cadence
    half_skin_sq = (0.5 * p.skin) ** 2
    disp = state.x - cl.xhold
    d2 = torch.where(state.valid_mask, torch.sum(disp * disp, dim=-1), 0.0)
    return cadence & (torch.max(d2) > half_skin_sq)


@trace.spanned("neigh")
def needs_rebuild(state: State, cl: SortedCells) -> torch.Tensor:
    """The rebuild decision of `neigh_modify every E delay D check yes/no`
    (ref: Neighbor::decide, src/neighbor.cpp:2309-2404) as a 0-d bool
    tensor on the device: the cadence, and with `check` a displacement of
    more than skin/2 since the last rebuild. `cl.ago` is a device
    tensor. CPU tensors take the plain version, CUDA tensors
    `sorted_rebin_decide_kernel` (ops/rebin_kernels)."""
    if state.device.type == "cpu":
        return needs_rebuild_reference(state, cl)
    return rebin_kernels.needs_rebuild(state, cl)


def rebuild_if_reference(state: State, cl: SortedCells,
                         rebuild: torch.Tensor):
    """The plain version of `rebuild_if`: the counterpart of the JAX step's
    `lax.cond(rebuild, do_rebuild, no_rebuild)` with both sides computed
    every step. The wrapped positions and the local permutation are
    selected against the unwrapped positions and the identity permutation
    with torch.where, and the identity permutation leaves the state as it
    is. Fresh arrays and a fresh list are returned."""
    cap = state.capacity
    valid = state.valid_mask
    x_w, image_w = state.box.wrap(state.x, state.image)
    newpos, overflow = _local_perm(state.replace(x=x_w), cl.params)
    identity = torch.where(valid, torch.arange(cap, device=state.device),
                           cap)
    moved = state.replace(x=torch.where(rebuild, x_w, state.x),
                          image=torch.where(rebuild, image_w, state.image))
    state, _ = _apply_perm(moved, torch.where(rebuild, newpos, identity),
                           overflow)
    return state, SortedCells(
        ago=torch.where(rebuild, 0, cl.ago + 1),
        nbuilds=cl.nbuilds + rebuild.to(cl.nbuilds.dtype),
        overflow=cl.overflow | (rebuild & overflow), params=cl.params,
        xhold=torch.where(rebuild, state.x, cl.xhold),
        short_cap=cl.short_cap, short_need=cl.short_need)


@trace.spanned("neigh")
def rebuild_if(state: State, cl: SortedCells, rebuild: torch.Tensor):
    """Wrap and re-bin where the 0-d device flag `rebuild` says so, with no
    host read; on other steps the state is left as it is and `ago` counts
    on. `cl.ago` and `cl.nbuilds` are int64 device tensors.

    CPU tensors take the plain version (fresh arrays). CUDA tensors take
    the kernels of ops/rebin_kernels, which read the flag on the device
    and do the re-bin only where it is set, IN PLACE: the state's x, v,
    type, tag, image, mask, q, molecule and the list's xhold, ago, nbuilds
    and overflow are overwritten, and the same state and list are
    returned. They are the segment's own: the generic runner's carry
    (integrate/verlet, integrate/graphs), or `segment_copies` and the
    integrator's fresh x and v in `make_step`'s step run in a loop."""
    trace.count("neigh.rebin_passes")
    if state.device.type == "cpu":
        return rebuild_if_reference(state, cl, rebuild)
    return rebin_kernels.rebuild_if(state, cl, rebuild)


def segment_copies(state: State, cl: SortedCells):
    """(state, cl) with their own copies of what `rebuild_if` updates in
    place on the card: the rows' type, tag, image, mask, q and molecule,
    the list's xhold and overflow flag, and `ago`/`nbuilds` as int64
    device tensors. `make_step`'s step run in a loop (the tests'
    reference, prof/rebin) takes them at its start, so that the state and
    list it was given stay as they were, as the segment runners leave
    theirs (their carry is their own: integrate/graphs). `short_need`
    stays shared: the host reads it after a short-list overflow."""
    dev = state.device

    def own(a):
        return None if a is None else a.clone()

    def counter(n):
        if isinstance(n, torch.Tensor):
            return n.to(device=dev, dtype=torch.int64, copy=True)
        return torch.tensor(n, dtype=torch.int64, device=dev)

    state = state.replace(type=own(state.type), tag=own(state.tag),
                          image=own(state.image), mask=own(state.mask),
                          q=own(state.q), molecule=own(state.molecule))
    return state, dataclasses.replace(
        cl, ago=counter(cl.ago), nbuilds=counter(cl.nbuilds),
        overflow=cl.overflow.clone(),
        xhold=None if cl.xhold is None else cl.xhold.clone(
            memory_format=torch.contiguous_format))


def read_back(cl: SortedCells) -> tuple[bool, SortedCells]:
    """A segment's one host read: the overflow flag, and `ago`/`nbuilds`
    where the segment kept them on the device (returned as host ints)."""
    if not isinstance(cl.ago, torch.Tensor):
        return bool(cl.overflow), cl
    overflow, ago, nbuilds = torch.stack(
        [cl.overflow.long(), cl.ago.long(), cl.nbuilds.long()]).tolist()
    return bool(overflow), dataclasses.replace(cl, ago=ago, nbuilds=nbuilds)


def planar(a: torch.Tensor) -> torch.Tensor:
    """[cap, 3] rows -> a fresh contiguous [3, cap] tensor, the kernel's
    layout (each component is a [ncells, cell_cap] grid). Always a copy:
    the fused segment updates it in place."""
    return a.t().clone(memory_format=torch.contiguous_format)

