"""Simulation runner: the `run` command / library-API analog.

Port of `lammps_kokkos_port_tpu/runner.py`, in two list modes: "sorted"
(the state itself cell-major, ops/sortedforce; the default) and "cell"
(dense cell buckets over an atom-ordered state, ops/cellforce; explicit
only). Mirrors the reference's Run::command -> Verlet::setup -> Verlet::run
flow (ref: src/run.cpp:37, src/verlet.cpp:93,229): the hot loop is a
segment of steps, the fused NVE segment (integrate/fused.py) for lj/cut
under a cadence-only rebuild policy, the generic step with its on-device
rebuild decision (integrate/verlet.make_step) otherwise, and always in
cell mode; the host orchestrates segment boundaries (thermo output) and
the capacity overflow grow-and-retry loop (ref:
src/KOKKOS/npair_kokkos.cpp:225-330). Requests outside the slice (other
list modes, fixes, rRESPA, triclinic or non-periodic boxes) raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .compute import thermo as thermo_mod
from .core.state import State
from .integrate.fused import make_sorted_nve_segment
from .integrate.verlet import Integrator, list_ops, make_step_segment
from .models.forcefield import ForceField, from_pair
from .ops import cellforce, sortedforce
from .ops import neighbor as nbr
from .utils import trace
from .utils.units import Units, get_units


class Simulation:
    """Owns state + styles + the segment runner for one run configuration
    (ref: src/lammps.h:24-109 for the role)."""

    def __init__(
        self,
        state: State,
        pair_style,
        dt: float | None = None,
        skin: float | None = None,
        neigh_every: int = 1,
        neigh_delay: int = 0,
        neigh_check: bool = True,
        list_mode: str = "auto",
    ):
        if list_mode not in ("auto", "sorted", "cell"):
            raise NotImplementedError(
                f"list mode {list_mode!r} is not ported; only 'sorted' and "
                "'cell' are")
        self.list_mode_req = list_mode
        self.state = state
        self.forcefield = (pair_style if isinstance(pair_style, ForceField)
                           else from_pair(pair_style))
        self.pair_style = self.forcefield.pair
        self.units: Units = get_units(state.units_name)
        self.dt = float(dt) if dt is not None else self.units.dt
        self.skin = float(skin) if skin is not None else self.units.skin
        self.neigh_every = neigh_every
        self.neigh_delay = neigh_delay
        self.neigh_check = neigh_check
        self.integrator = Integrator(dt=self.dt, units=self.units)
        self.nl: sortedforce.SortedCells | cellforce.CellListDense | None = (
            None)
        self.thermo_norm: bool | None = None  # thermo_modify norm
        self.ntimestep = 0
        self._segment_runner = None
        # the short-list width of a three-body style (sorted mode), grown
        # by _grow_params like cell_cap
        self.short_cap = sortedforce.SHORT_CAP

    # -- forces -------------------------------------------------------------

    def force_fn(self, state: State, nl, eflag: bool, vflag: bool):
        return self.forcefield.compute(state, nl, eflag, vflag)

    # -- setup (ref: Verlet::setup, src/verlet.cpp:93) ----------------------

    @trace.spanned("setup")
    def setup(self):
        self.state = self.integrator.setup(self.state)
        cutneigh = self.forcefield.max_cutoff() + self.skin
        params = nbr.size_for_system(
            self.state, cutneigh=cutneigh, skin=self.skin,
            every=self.neigh_every, delay=self.neigh_delay,
            check=self.neigh_check)
        x, image = self.state.box.wrap(self.state.x, self.state.image)
        self.state = self.state.replace(x=x, image=image)
        self._pick_list_mode()
        # dense-path cost scales with cell_cap^2: size tightly and let the
        # overflow-retry loop absorb density fluctuations
        params = nbr.size_for_system(
            self.state, cutneigh=cutneigh, skin=self.skin,
            every=self.neigh_every, delay=self.neigh_delay,
            check=self.neigh_check, cell_pad=1.12, cell_round=2)
        if self.list_mode == "sorted":
            with trace.span("setup.grid"):
                params = self._optimize_sorted_grid(params, cutneigh)
                params = self._align_cell_cap(params)
        with trace.span("setup.list"):
            self.nl = self._build_list(self.state, params)
        self._check_overflow_and_grow()
        self.presetup_forces()
        if bool(self.nl.overflow):
            # a force pass that overflowed a list of its own (a three-body
            # style's short list): grow it and evaluate again
            self._check_overflow_and_grow()
            self.presetup_forces()
            if bool(self.nl.overflow):
                raise RuntimeError("the setup force pass still overflows "
                                   "after growing its lists")

    def presetup_forces(self):
        """The setup force pass, and the `run ... pre yes` pass between
        consecutive runs (ref: Verlet::setup): forces from the current
        state, nothing else reset."""
        f, _, _, _ = self.force_fn(self.state, self.nl, False, False)
        self.state = self.state.replace(f=f)

    def _pick_list_mode(self):
        """The list mode the request resolves to, as the pair style states
        where it runs (its `force_paths`, models/pair.ForcePaths): "cell"
        or "sorted" where the style runs in that mode; "auto" is "sorted"
        unless the style refuses it. All need a fully periodic orthogonal
        box.
        The JAX package falls back to other engines otherwise; those are
        not ported, so this raises instead of drifting onto another
        path."""
        box = self.state.box
        if not all(box.periodic) or box.triclinic:
            raise NotImplementedError(
                f"list mode {self.list_mode_req!r} needs a fully periodic "
                "orthogonal box")
        paths = self.pair_style.force_paths
        mode = self.list_mode_req
        if mode == "auto":
            if paths.auto_refused:
                raise NotImplementedError(paths.auto_refused)
            mode = "sorted"
        if mode not in paths.modes:
            raise NotImplementedError(
                f"cell mode needs a pair_terms style or a single-element "
                f"EAM style, not {type(self.pair_style).__name__}"
                if mode == "cell" else
                "sorted mode needs a single-type lj/cut style, a "
                "single-element EAM style or a three-body style")
        self.list_mode = mode

    def _build_list(self, state, params):
        if self.list_mode == "cell":
            return cellforce.build_cell(state, params)
        # sorted mode owns the state layout: expand to the cell-major
        # capacity and permute (self.state is replaced)
        state = sortedforce.expand_state(state, params)
        state, nl = sortedforce.build(state, params, self.short_cap)
        self.state = state
        return nl

    def _optimize_sorted_grid(self, params, cutneigh):
        """Pick the cell grid minimizing the dense kernel's pair-math cost
        ntot * cc_aligned^2 (see the JAX runner for the derivation). The
        sizing is kept unchanged from the JAX package, so the port's state
        is row for row the JAX state; its 32/8-lane rounding is a TPU
        tiling choice that a later change re-derives for the CUDA kernel."""
        nx, ny, nz = params.ncells
        if min(nx, ny, nz) < 4:
            return params

        heights = np.asarray(nbr.box_heights(self.state.box))
        nvalid = self.state.nlocal

        def aligned_cap(max_cell, avg):
            # equilibrium density fluctuations reach ~ avg + 2.4 sqrt(avg)
            tight = max(max_cell, int(avg + 2.4 * avg ** 0.5 + 1), 4)
            r32 = max(32, ((tight + 31) // 32) * 32)
            r8 = ((tight + 7) // 8) * 8
            return r32 if r32 <= r8 * 1.3 else r8

        best, best_cost, best_cc = None, None, None
        for d in range(-1, 4):
            nc = (max(3, nx - d), max(3, ny - d), max(3, nz - d))
            if d < 0:
                edges = heights / np.asarray(nc)
                if np.any(edges < cutneigh * 0.999):
                    continue
            counts = np.bincount(
                nbr._cell_ids_host(self.state, nc),
                minlength=nc[0] * nc[1] * nc[2] + 1)
            max_cell = int(counts[:-1].max())
            cc = aligned_cap(max_cell, nvalid / (nc[0] * nc[1] * nc[2]))
            cost = nc[0] * nc[1] * nc[2] * (-(-cc // 8) * 8) * cc
            if best_cost is None or cost < best_cost:
                best, best_cost, best_cc = nc, cost, cc
        if best is None:
            return params
        grown = nbr.size_for_system(
            self.state, cutneigh=cutneigh, skin=self.skin,
            every=self.neigh_every, delay=self.neigh_delay,
            check=self.neigh_check, cell_pad=1.12, cell_round=2,
            ncells=best)
        return dataclasses.replace(grown, cell_cap=best_cc)

    @staticmethod
    def _align_cell_cap(params):
        """Round cell_cap to a multiple of 32, or of 8 when the 32-multiple
        overshoots the observed occupancy by more than ~30% (unchanged from
        the JAX package; see _optimize_sorted_grid)."""
        cc = params.cell_cap
        # recover the observed max occupancy from the tight cap's 1.12 pad
        est_max = max(1, int((cc - 1) / 1.12))
        r32 = max(32, ((est_max + 1 + 31) // 32) * 32)
        r8 = max(8, ((est_max + 1 + 7) // 8) * 8)
        return dataclasses.replace(params,
                                   cell_cap=r32 if r32 <= r8 * 1.3 else r8)

    def _grow_params(self, params):
        """Sorted mode: occupancy-aware growth, measuring the capacity the
        current state needs instead of multiplying blindly; where the
        overflow was a three-body style's short list (the list's
        `short_need`, the longest list that did not fit), the short list
        alone is widened, counted on `neigh.short_grows`. Cell mode: the
        plain x1.3 growth of neighbor.grow."""
        if self.list_mode == "cell":
            return nbr.grow(params)
        need = getattr(self.nl, "short_need", None)
        if need is not None and int(need) > 0:
            trace.count("neigh.short_grows")
            self.short_cap = max(-(-int(need) // 8) * 8,
                                 self.nl.short_cap + 8)
            return params
        counts = np.bincount(
            nbr._cell_ids_host(self.state, params.ncells),
            minlength=params.total_cells + 1)[:-1]
        need = int(counts.max()) + 3  # margin for in-segment drift
        cc = max(-(-need // 8) * 8, params.cell_cap + 8)
        r32 = ((cc + 31) // 32) * 32
        if r32 <= cc * 1.3:
            cc = r32
        return dataclasses.replace(params, cell_cap=cc,
                                   K=int(params.K * 1.3) + 8)

    def _check_overflow_and_grow(self, max_tries: int = 8):
        for _ in range(max_tries):
            if not bool(self.nl.overflow):
                return
            params = self._grow_params(self.nl.params)
            self.nl = self._build_list(self.state, params)
        raise RuntimeError("neighbor capacity growth did not converge")

    # -- run ----------------------------------------------------------------

    def _get_segment_runner(self):
        """Sorted mode: the fused NVE segment for lj/cut with a
        cadence-only rebuild policy (`check no`, delay <= every). The
        generic step segment for everything else, and always in cell mode.
        Either reads shapes from the state and list it is given, so one
        runner serves every capacity."""
        if self._segment_runner is None:
            kk = getattr(self.forcefield.pair, "kernel_key", None)
            every = max(self.neigh_every, 1)
            if (self.list_mode == "sorted" and kk is not None
                    and kk() is not None and not self.neigh_check
                    and self.neigh_delay <= every):
                self._segment_runner = make_sorted_nve_segment(
                    self.integrator, self.forcefield.pair)
            else:
                self._segment_runner = make_step_segment(
                    self.integrator, self.force_fn)
        return self._segment_runner

    def run(
        self,
        nsteps: int,
        thermo_every: int = 0,
        on_row=None,
    ) -> list[dict]:
        """Advance nsteps; emit thermo rows at the cadence (incl. first and
        last), like Output::setup/write (ref: src/output.cpp:189,339).
        `on_row(row)`, where given, sees each row as it is made (with its
        "step") and may add to it in place. Non-finite thermo raises (the
        lost-atom / NaN guard)."""
        if self.nl is None:
            self.setup()
        self.state = self.integrator.refresh_segment(self.state)
        rows = []

        def emit(step_no):
            row = self.thermo()
            row["step"] = step_no
            rows.append(row)
            if on_row is not None:
                on_row(row)
            if not all(math.isfinite(v) for v in row.values()
                       if isinstance(v, float)):
                raise RuntimeError(
                    f"non-finite thermo at step {step_no}: {row} "
                    "(simulation unstable — lost atoms or bad dynamics)")

        with trace.span("run"):
            emit(self.ntimestep)
            done = 0
            while done < nsteps:
                if thermo_every > 0:
                    next_out = min(nsteps, ((done // thermo_every) + 1)
                                   * thermo_every)
                else:
                    next_out = nsteps
                seg = next_out - done
                self._run_segment_retry(seg)
                done = next_out
                self.ntimestep += seg
                emit(self.ntimestep)
        return rows

    @trace.spanned("segment")
    def _run_segment_retry(self, seg: int, max_tries: int = 8):
        snap_state, snap_nl = self.state, self.nl
        for _ in range(max_tries):
            runner = self._get_segment_runner()
            with trace.span("segment.launch"):
                state, nl = runner(self.state, self.nl, seg)
            with trace.span("segment.read"):  # the one host sync
                overflow, nl = list_ops(nl).read_back(nl)
            if not overflow:
                self.state, self.nl = state, nl
                return
            trace.count("segment.retries")
            with trace.span("segment.grow"):
                # capacity overflow inside the segment: grow, rebuild
                # from the snapshot, and re-run the whole segment with
                # the new shapes (restore the snapshot first: the
                # post-segment state is NaN-poisoned and growth reads
                # self.state). The snapshot is wrapped into the box
                # before the re-bin, as every rebuild wraps: the
                # sorted kernels shift a candidate by whole boxes only
                # where its cell wraps, so an atom binned across a
                # face with an unwrapped coordinate would see its
                # neighbours a box away.
                cur_params = self.nl.params
                x, image = snap_state.box.wrap(snap_state.x,
                                               snap_state.image)
                self.state = snap_state.replace(x=x, image=image)
                params = self._grow_params(cur_params)
                nl = self._build_list(self.state, params)
                # a snapshot list built at this very state (ago 0:
                # setup, or a rebuild on the previous segment's last
                # step) is only resized; any other snapshot gets a new
                # build here, counted once, and the cadence (ago) and
                # the displacement reference (xhold) restart from it,
                # as the build returns them
                self.nl = dataclasses.replace(
                    nl, nbuilds=int(snap_nl.nbuilds)
                    + (int(snap_nl.ago) != 0))
                self._check_overflow_and_grow()
        raise RuntimeError("neighbor overflow retry did not converge")

    # -- observables --------------------------------------------------------

    @trace.spanned("output")
    def thermo(self) -> dict:
        """Current thermo keywords (ref: src/thermo.cpp:815-905 subset).
        All device values come to the host in one copy."""
        u = self.units
        st = self.state
        f, epair, emol, virial = self.force_fn(st, self.nl, True, True)
        t = thermo_mod.temperature(st, u)
        ke = thermo_mod.kinetic_energy(st, u)
        press = thermo_mod.pressure(st, virial, u, t)
        ptens = thermo_mod.pressure_tensor(st, virial, u)
        fmag = torch.where(st.valid_mask[:, None], f, 0.0)
        dev_vals = torch.cat([
            torch.stack([epair, emol, ke, t, press, st.box.volume,
                         torch.sqrt(torch.sum(fmag * fmag)),
                         torch.max(torch.abs(fmag))]),
            ptens, st.box.lo, st.box.hi,
        ]).double()
        with trace.span("output.read"):
            dev_vals = dev_vals.cpu().numpy()
        ep_v, em_v, ke_v, t_v, p_v, vol, fnorm, fmax = dev_vals[:8]
        ptens_v, lo, hi = dev_vals[8:14], dev_vals[14:17], dev_vals[17:20]
        n = st.nlocal
        # thermo_modify norm yes/no overrides the units default
        # (ref: src/thermo.cpp normflag modify_params)
        norm = (self.thermo_norm if self.thermo_norm is not None
                else u.norm_default)
        if norm:
            ep_v, em_v, ke_v = ep_v / n, em_v / n, ke_v / n
        pe_v = ep_v + em_v
        row = {
            "temp": float(t_v),
            "epair": float(ep_v),
            "emol": float(em_v),
            "ke": float(ke_v),
            "pe": float(pe_v),
            "etotal": float(pe_v + ke_v),
            "press": float(p_v),
            "vol": float(vol),
            "natoms": int(n),
            "fnorm": float(fnorm),
            "fmax": float(fmax),
            "enthalpy": float(pe_v + ke_v) + float(p_v) * float(vol)
            / (n if norm else 1) / u.nktv2p,
            "dt": self.dt,
        }
        for i, k in enumerate(("pxx", "pyy", "pzz", "pxy", "pxz", "pyz")):
            row[k] = float(ptens_v[i])
        for d, k in enumerate(("xlo", "ylo", "zlo")):
            row[k] = float(lo[d])
        for d, k in enumerate(("xhi", "yhi", "zhi")):
            row[k] = float(hi[d])
        return row

