"""Input-script command language: the `LammpsScript` interpreter.

Port of `lammps_kokkos_port_tpu/script.py` (ref: src/input.cpp:190,367,
420,560,749: the line loop, $var substitution, command dispatch), cut to
the command families of the benchmark decks (bench/in.lj, bench/in.eam,
examples/melt). Commands mutate the interpreter's setup; `run` builds a
`runner.Simulation` from it and drives it, printing a reference-style
thermo table.

Ported commands:
  - control: label, jump, next, include, if, variable (index, loop,
    string, equal, delete), print, log, echo;
  - setup: units, dimension (3), boundary (p p p), atom_style (atomic),
    atom_modify, lattice (style and scale), region (block, units/side),
    create_box, create_atoms (box, region, single), mass, velocity create
    (loop all/geom, dist uniform/gaussian);
  - styles: pair_style lj/cut, eam and tersoff (one element),
    pair_coeff, neighbor (bin),
    neigh_modify (every, delay, check), fix nve (group all), unfix,
    timestep;
  - output and run: thermo, thermo_style one/custom, thermo_modify norm,
    reset_timestep, timer (off, loop, normal, full), run;
  - accepted no-ops, as in the JAX package: newton, processors, suffix,
    package.
Every other command, style or keyword raises ScriptError naming it: the
port never skips a line it does not run.

One deliberate difference from the JAX package: a command that changes
what a run builds (a style, a fix, the timestep, atoms, velocities), when
it comes after a run, first pulls the live atoms back into the setup
(`_sync_from_sim`), so the next run builds a new Simulation with the new
setting from the current state. The JAX package keeps its first
Simulation and ignores such commands.

The `timer` default is `off`, where LAMMPS's is `normal`: the port's spans
(utils/trace) stay off unless a deck asks for them, so that the measured
path carries none.
"""

from __future__ import annotations

import math
import os
import re
import shlex
import time

import numpy as np
import torch

from .core.box import Box
from .core.lattice import Lattice
from .core.lattice import create_atoms as lattice_create_atoms
from .core.state import State, create_state
from .core.velocity import create_velocities_geom, create_velocities_loop_all
from .models.forcefield import ForceField
from .utils import trace
from .utils.device import resolve as resolve_device
from .utils.units import UNIT_SYSTEMS, get_units


class ScriptError(RuntimeError):
    pass


def _is_num(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def _fmt_num(v) -> str:
    """Number -> shortest exact-ish string for substitution."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _not_ported(what: str) -> ScriptError:
    return ScriptError(f"{what} is not ported")


def _atom_order(state: State) -> np.ndarray:
    """Host: row indices of the real atoms in tag order (the cell-major
    sorted layout scatters them across rows)."""
    valid = state.valid_mask.cpu().numpy()
    idx = np.flatnonzero(valid)
    tags = state.tag.cpu().numpy()[idx]
    return idx[np.argsort(tags, kind="stable")]


class LammpsScript:
    """Parse and execute an input script (ref: Input::file/one).

    dtype: the run's float type; device: where the run's tensors live
    ("cuda", the default, which raises without a CUDA device, or "cpu");
    list_mode: the Simulation's list mode ("auto", "sorted" or "cell")."""

    def __init__(self, dtype: torch.dtype = torch.float32, device="cuda",
                 log_file: str | None = None, echo: bool = False,
                 var_overrides: dict | None = None,
                 list_mode: str = "auto"):
        self.dtype = dtype
        self.device = resolve_device(device)
        self.list_mode = list_mode
        self.units_name = "lj"
        self.dimension = 3
        self.lattice: Lattice | None = None
        self.regions: dict[str, tuple] = {}
        self.box: Box | None = None
        self.ntypes = 0
        self.positions: list = []
        self.types: list = []
        self.velocities: np.ndarray | None = None
        self.thermo_norm: bool | None = None
        self.masses: dict[int, float] = {}
        self.pair_style_words: list[str] | None = None
        self.pair_coeffs: list[list[str]] = []
        self.skin: float | None = None
        self.neigh_every = 1
        self.neigh_delay = 0
        self.neigh_check = True
        self.dt: float | None = None
        self.thermo_every = 0
        self.ntimestep = 0
        # the step the current (or last) run began at: thermo `elapsed` is
        # ntimestep - firststep (ref: src/thermo.cpp compute_elapsed)
        self._first_step = 0
        self.variables: dict[str, str] = dict(var_overrides or {})
        self._equal_vars: dict[str, str] = {}
        self._index_vars: dict[str, dict] = {
            k: {"values": [v], "i": 0} for k, v in (var_overrides or {}).items()
        }
        self._jump_skip = False
        self.thermo_style: list[str] | None = None  # None = default table
        self.log_file = log_file
        self.echo = echo
        self.sim = None
        self._log_lines: list[str] = []

    # -- driver --------------------------------------------------------------

    @staticmethod
    def _read_lines(path: str) -> list[str]:
        out = []
        with open(path) as f:
            buf = ""
            for raw in f:
                line = raw.rstrip("\n")
                if line.rstrip().endswith("&"):
                    buf += line.rstrip()[:-1]
                    continue
                buf += line
                out.append(buf)
                buf = ""
            if buf.strip():
                out.append(buf)
        return out

    def file(self, path: str):
        """ref: Input::file: the line loop with continuation (&) handling
        plus label/jump/next/include control flow (ref:
        src/input.cpp:749-862; jump re-reads the file, here a program
        counter over the cached lines)."""
        self._last_file_dir = os.path.dirname(os.path.abspath(path))
        self._run_program(self._read_lines(path), path)

    @staticmethod
    def _labels(lines: list[str]) -> dict[str, int]:
        labels = {}
        for i, ln in enumerate(lines):
            w = ln.split("#")[0].split()
            if w[:1] == ["label"] and len(w) > 1:
                labels[w[1]] = i
        return labels

    def _run_program(self, lines: list[str], path: str = "SELF"):
        labels = self._labels(lines)
        pc = 0
        while pc < len(lines):
            line = lines[pc]
            pc += 1
            words = line.split("#")[0].split()
            cmd = words[0] if words else None
            if cmd == "label":
                continue
            if cmd == "jump":
                if self._jump_skip:
                    # an exhausted `next` skips the next jump
                    # (ref: src/variable.cpp next semantics)
                    self._jump_skip = False
                    continue
                target = self._substitute(" ".join(words[1:])).split()
                fname = target[0]
                if fname not in ("SELF", path):
                    lines = self._read_lines(fname)
                    labels = self._labels(lines)
                    path = fname
                pc = labels[target[1]] if len(target) > 1 else 0
                continue
            if cmd == "next":
                for name in words[1:]:
                    vals = self._index_vars.get(name)
                    if vals is None:
                        raise ScriptError(f"next on non-index variable {name}")
                    vals["i"] += 1
                    if vals["i"] >= len(vals["values"]):
                        del self._index_vars[name]
                        self.variables.pop(name, None)
                        self._jump_skip = True
                    else:
                        self.variables[name] = vals["values"][vals["i"]]
                continue
            if cmd == "include":
                self._run_program(
                    self._read_lines(self._substitute(words[1])), words[1])
                continue
            self.one(line)

    def cmd_if(self, a):
        """if "cond" then "cmd"... [elif "cond" "cmd"...] [else "cmd"...]
        (ref: src/input.cpp if command; quoted commands are grouped by
        one()'s quote-aware splitter)."""
        i = 0
        while i < len(a):
            if a[i] == "else":
                cond = None
                i += 1
            else:
                cond = a[i]
                i += 1
                if i < len(a) and a[i] == "then":
                    i += 1
            cmds = []
            while i < len(a) and a[i] not in ("elif", "else"):
                cmds.append(a[i])
                i += 1
            if i < len(a) and a[i] == "elif":
                i += 1
            if cond is None or bool(self._eval_expr(cond)):
                for c in cmds:
                    self.one(c)
                return

    def one(self, line: str):
        """ref: Input::one: substitute, parse, dispatch."""
        line = line.split("#")[0]
        line = self._substitute(line)
        head = line.split(None, 1)
        if not head:
            return
        if head[0] in ("if", "print", "variable"):
            words = shlex.split(line)  # quoted sub-commands stay grouped
        else:
            words = line.split()
        if self.echo:
            self._emit("> " + " ".join(words))
        cmd, args = words[0], words[1:]
        handler = getattr(self, f"cmd_{cmd.replace('/', '_')}", None)
        if handler is None:
            raise ScriptError(f"command '{cmd}' is unknown or not ported")
        handler(args)

    def _substitute(self, line: str) -> str:
        """$x, ${name} and $(expr) substitution (ref: Input::substitute;
        equal-style variables evaluate lazily at substitution time)."""

        def repl(m):
            name = m.group(1) or m.group(2)
            if name in self._equal_vars:
                return _fmt_num(self._eval_expr(self._equal_vars[name]))
            if name not in self.variables:
                raise ScriptError(f"undefined variable ${name}")
            return str(self.variables[name])

        def subst_immediate(s: str) -> str:
            # $(expr) with balanced parens (ref: Input::substitute $(...))
            out = []
            i = 0
            while i < len(s):
                if s[i] == "$" and i + 1 < len(s) and s[i + 1] == "(":
                    depth = 0
                    j = i + 1
                    while j < len(s):
                        if s[j] == "(":
                            depth += 1
                        elif s[j] == ")":
                            depth -= 1
                            if depth == 0:
                                break
                        j += 1
                    out.append(_fmt_num(self._eval_expr(s[i + 2:j])))
                    i = j + 1
                else:
                    out.append(s[i])
                    i += 1
            return "".join(out)

        prev = None
        while prev != line:
            prev = line
            line = subst_immediate(line)
            line = re.sub(r"\$\{(\w+)\}|\$(\w)", repl, line)
        return line

    def _emit(self, text: str):
        print(text)
        self._log_lines.append(text)
        if self.log_file:
            with open(self.log_file, "a") as f:
                f.write(text + "\n")

    def _sync_from_sim(self):
        """Pull the live atoms back into the host-side setup (tag order)
        and drop the built Simulation, so the next run builds a new one
        from the current state. Image flags are not carried (the atomic
        setup has none; wrapped positions are kept)."""
        if self.sim is None:
            return
        st = self.sim.state
        rows = _atom_order(st)
        self.positions = st.x.double().cpu().numpy()[rows].tolist()
        self.types = st.type.cpu().numpy()[rows].tolist()
        self.velocities = st.v.double().cpu().numpy()[rows]
        self.ntimestep = self.sim.ntimestep
        self.sim = None

    # -- setup commands ------------------------------------------------------

    def cmd_units(self, a):
        if a[0] not in UNIT_SYSTEMS:
            raise ScriptError(f"unknown units {a[0]}")
        self._sync_from_sim()
        self.units_name = a[0]

    def cmd_dimension(self, a):
        if a[0] != "3":
            raise _not_ported(f"dimension {a[0]}")
        self.dimension = 3

    def cmd_boundary(self, a):
        if tuple(a) != ("p", "p", "p"):
            # the port runs fully periodic boxes only
            raise _not_ported(f"boundary {' '.join(a)}")

    def cmd_atom_style(self, a):
        if a != ["atomic"]:
            raise _not_ported(f"atom_style {' '.join(a)}")

    def cmd_atom_modify(self, a):
        pass  # map/sort hints are automatic here

    def cmd_newton(self, a):
        pass  # accepted; full stencils make it moot

    def cmd_processors(self, a):
        pass

    def cmd_suffix(self, a):
        pass  # one backend

    def cmd_package(self, a):
        pass

    def cmd_log(self, a):
        self.log_file = None if a[0] == "none" else a[0]

    def cmd_echo(self, a):
        self.echo = a[0] in ("screen", "both")

    def cmd_print(self, a):
        self._emit(" ".join(a).strip('"'))

    def cmd_variable(self, a):
        name, style = a[0], a[1]
        if style == "index":
            if name not in self._index_vars:
                self._index_vars[name] = {"values": list(a[2:]), "i": 0}
                self.variables.setdefault(name, a[2])
        elif style == "loop":
            if name not in self._index_vars:
                n = int(a[2])
                vals = [str(i) for i in range(1, n + 1)]
                self._index_vars[name] = {"values": vals, "i": 0}
                self.variables.setdefault(name, vals[0])
        elif style == "string":
            self.variables.setdefault(name, a[2])
        elif style == "equal":
            # lazy: evaluated at each substitution (thermo keywords are live)
            self._equal_vars[name] = a[2]
        elif style == "delete":
            self.variables.pop(name, None)
            self._equal_vars.pop(name, None)
            self._index_vars.pop(name, None)
        else:
            raise _not_ported(f"variable style {style}")

    # thermo keywords usable in equal-style expressions
    # (ref: src/variable.cpp thermo keyword dispatch -> Thermo::evaluate)
    _THERMO_KEYS = ("step", "temp", "press", "pe", "ke", "etotal", "epair",
                    "emol", "vol", "density", "atoms", "lx", "ly", "lz",
                    "dt", "time", "elapsed")

    def _thermo_keyword(self, key: str) -> float:
        if key == "dt":
            return self.dt if self.dt is not None else get_units(
                self.units_name).dt
        if self.sim is None:
            if key == "step":
                return float(self.ntimestep)
            if key == "atoms":
                return float(len(self.positions))
            raise ScriptError(
                f"thermo keyword '{key}' in variable before any run")
        row = self.sim.thermo()
        row["step"] = self.sim.ntimestep
        row["atoms"] = row["natoms"]
        row["elapsed"] = self.sim.ntimestep - self._first_step
        row["time"] = self.sim.ntimestep * (self.dt or 0.0)
        row["lx"], row["ly"], row["lz"] = self.sim.state.box.prd.tolist()
        row["density"] = self._density(row)
        return float(row[key])

    def _density(self, row) -> float:
        masses = self._mass_table()
        st = self.sim.state
        types = st.type.cpu().numpy()[st.valid_mask.cpu().numpy()]
        mtot = float(masses[types].sum())
        return get_units(self.units_name).mv2d * mtot / row["vol"]

    def _eval_expr(self, expr: str):
        """Equal-style expression engine: arithmetic, comparisons, boolean
        ops, math functions, v_ variables, and thermo keywords (subset of
        ref: src/variable.cpp evaluate)."""
        s = expr.strip()
        s = re.sub(r"v_(\w+)", lambda m: self._var_value(m.group(1)), s)
        s = s.replace("^", "**").replace("&&", " and ").replace("||", " or ")
        s = re.sub(r"!(?!=)", " not ", s)
        # thermo keywords -> values
        for key in self._THERMO_KEYS:
            if re.search(rf"\b{key}\b", s):
                s = re.sub(rf"\b{key}\b", _fmt_num(self._thermo_keyword(key)),
                           s)
        allowed = {
            "sqrt": math.sqrt, "exp": math.exp, "ln": math.log,
            "log": math.log10, "abs": abs, "sin": math.sin, "cos": math.cos,
            "tan": math.tan, "floor": math.floor, "ceil": math.ceil,
            "round": round, "pow": pow, "PI": math.pi,
            "and": None, "or": None, "not": None,
        }
        if not re.fullmatch(r"[\w\.\+\-\*/%\(\),<>=! \t]+", s):
            raise ScriptError(f"unsupported expression: {expr}")
        for tok in re.findall(r"[A-Za-z_]\w*", s):
            if tok not in allowed and not re.fullmatch(
                    r"\d*[eE]\d+|nan|inf", tok):
                raise ScriptError(f"unknown token '{tok}' in: {expr}")
        ns = {k: v for k, v in allowed.items() if v is not None}
        try:
            out = eval(s, {"__builtins__": {}}, ns)
        except Exception as e:  # noqa: BLE001
            raise ScriptError(f"bad expression: {expr} ({e})") from e
        return float(out) if isinstance(out, bool) else out

    def _var_value(self, name: str) -> str:
        if name in self._equal_vars:
            return "(" + str(self._eval_expr(self._equal_vars[name])) + ")"
        if name in self.variables:
            return str(self.variables[name])
        raise ScriptError(f"undefined variable v_{name}")

    def cmd_lattice(self, a):
        if a[0] == "none":
            self.lattice = None
            return
        if len(a) != 2:
            raise _not_ported(f"lattice keywords {' '.join(a[2:])}")
        self.lattice = Lattice(style=a[0], scale=float(a[1]),
                               units_name=self.units_name,
                               dimension=self.dimension)

    def cmd_region(self, a):
        """region ID block xlo xhi ylo yhi zlo zhi [units box|lattice]
        [side in|out] (ref: src/region_block.cpp)."""
        name, style = a[0], a[1]
        if style != "block":
            raise _not_ported(f"region style {style}")
        units = "lattice"
        side = "in"
        clean = []
        rest = list(a[2:])
        i = 0
        while i < len(rest):
            if rest[i] == "units":
                units = rest[i + 1]
                i += 2
            elif rest[i] == "side":
                side = rest[i + 1]
                i += 2
            elif len(clean) < 6:
                clean.append(rest[i])
                i += 1
            else:
                raise _not_ported(f"region keyword {rest[i]}")
        params = [None if s in ("INF", "EDGE") else float(s) for s in clean]
        self.regions[name] = (style, params, units, side)

    def _region_scale(self, units: str) -> np.ndarray:
        if units == "box" or self.lattice is None:
            return np.ones(3)
        return np.asarray(self.lattice.spacing)

    def _region_bbox(self, name: str):
        """(lo, hi) bounding box of a block in box units; INF/EDGE bounds
        take the box's."""
        _, p, units, _ = self.regions[name]
        sp = self._region_scale(units)

        def b(v, d, bound):
            return v * sp[d] if v is not None else bound[d]

        lo = np.array([b(p[0], 0, self._box_lo_np), b(p[2], 1, self._box_lo_np),
                       b(p[4], 2, self._box_lo_np)])
        hi = np.array([b(p[1], 0, self._box_hi_np), b(p[3], 1, self._box_hi_np),
                       b(p[5], 2, self._box_hi_np)])
        return lo, hi

    def _region_contains(self, name: str, pts: np.ndarray) -> np.ndarray:
        """Inside-mask for points in box units (ref: Region::match; side
        out inverts)."""
        side = self.regions[name][3]
        lo, hi = self._region_bbox(name)
        sel = np.all((pts >= lo) & (pts <= hi), axis=1)
        return ~sel if side == "out" else sel

    def cmd_create_box(self, a):
        if len(a) != 2:
            raise _not_ported(f"create_box keywords {' '.join(a[2:])}")
        self._sync_from_sim()
        self.ntypes = int(a[0])
        _, p, units, _ = self.regions[a[1]]
        if any(v is None for v in p):
            raise ScriptError("create_box needs a bounded block region")
        sp = self._region_scale(units)
        # keep exact fp64 bounds on the host: lattice-point inclusion must
        # not depend on the run's float width
        self._box_lo_np = np.array([p[0], p[2], p[4]], dtype=float) * sp
        self._box_hi_np = np.array([p[1], p[3], p[5]], dtype=float) * sp
        self.box = Box.create(self._box_lo_np, self._box_hi_np,
                              periodic=(True, True, True),
                              dtype=torch.float64, device=self.device)

    @trace.spanned("setup.atoms")
    def cmd_create_atoms(self, a):
        type_id = int(a[0])
        style = a[1]
        nargs = {"box": 2, "region": 3, "single": 5}.get(style)
        if nargs is None:
            raise _not_ported(f"create_atoms style {style}")
        if len(a) != nargs:
            raise _not_ported(f"create_atoms keywords {' '.join(a[nargs:])}")
        self._sync_from_sim()
        if style == "single":
            # create_atoms TYPE single x y z (lattice units by default)
            sp = self._region_scale("lattice")
            pt = np.array([float(a[2]), float(a[3]), float(a[4])]) * sp
            self.positions.append(tuple(pt))
            self.types.append(type_id)
            return
        if style == "box":
            lo, hi = self._box_lo_np, self._box_hi_np
        else:
            lo, hi = self._region_bbox(a[2])
            lo = np.maximum(lo, self._box_lo_np)
            hi = np.minimum(hi, self._box_hi_np)
        x, t = lattice_create_atoms(self.lattice, lo, hi, type_id=type_id)
        if style == "region" and len(x):
            keep = self._region_contains(a[2], np.asarray(x))
            x, t = np.asarray(x)[keep], np.asarray(t)[keep]
        self.positions.extend(np.asarray(x).tolist())
        self.types.extend(np.asarray(t).tolist())

    def cmd_mass(self, a):
        self._sync_from_sim()
        if a[0] == "*":
            for t in range(1, self.ntypes + 1):
                self.masses[t] = float(a[1])
        else:
            self.masses[int(a[0])] = float(a[1])

    def cmd_velocity(self, a):
        """velocity all create T seed [dist uniform|gaussian] [loop
        all|geom] [mom yes] [rot no] (ref: src/velocity.cpp create)."""
        group, action = a[0], a[1]
        if action != "create":
            raise _not_ported(f"velocity {action}")
        if group != "all":
            raise _not_ported(f"velocity on group {group}")
        self._sync_from_sim()
        t_target = float(a[2])
        seed = int(a[3])
        opts = dict(dist="uniform", loop="all", mom="yes", rot="no")
        for k, v in zip(a[4::2], a[5::2]):
            if k not in opts:
                raise _not_ported(f"velocity keyword {k}")
            opts[k] = v
        if (opts["loop"] not in ("all", "geom") or opts["mom"] != "yes"
                or opts["rot"] != "no"):
            raise _not_ported(f"velocity options {' '.join(a[4:])}")
        x = np.asarray(self.positions)
        m_per_atom = self._mass_table()[np.asarray(self.types,
                                                   dtype=np.int32)]
        units = get_units(self.units_name)
        if opts["loop"] == "geom":
            v = create_velocities_geom(
                x, m_per_atom, t_target, seed, units, dist=opts["dist"],
                dimension=self.dimension)
        else:
            v = create_velocities_loop_all(
                len(x), m_per_atom, t_target, seed, units,
                dist=opts["dist"], dimension=self.dimension)
        self.velocities = v

    def _mass_table(self) -> np.ndarray:
        tab = np.ones(self.ntypes + 1)
        for t, m in self.masses.items():
            tab[t] = m
        return tab

    # -- style commands ------------------------------------------------------

    def cmd_pair_style(self, a):
        if a[0].startswith("tersoff/"):
            raise NotImplementedError(
                f"pair_style {a[0]}: only plain tersoff is ported")
        if a[0] == "tersoff" and len(a) > 1:
            raise NotImplementedError(
                f"pair_style tersoff {' '.join(a[1:])}: its keywords "
                "(shift) are not ported")
        if a[0] not in ("lj/cut", "eam", "tersoff"):
            raise _not_ported(f"pair_style {a[0]}")
        self._sync_from_sim()
        self.pair_style_words = a

    def cmd_pair_coeff(self, a):
        self._sync_from_sim()
        self.pair_coeffs.append(a)
        # EAM potential files carry the element mass (ref: funcfl readers
        # set atom->mass); honor it like the reference does
        name = self.pair_style_words[0] if self.pair_style_words else ""
        if name == "eam" and len(a) >= 3:
            from .io.eam_reader import read_funcfl

            self.masses[int(a[0])] = read_funcfl(a[2]).mass

    def cmd_neighbor(self, a):
        if a[1:] != ["bin"]:
            raise _not_ported(f"neighbor style {' '.join(a[1:])}")
        self._sync_from_sim()
        self.skin = float(a[0])

    def cmd_neigh_modify(self, a):
        self._sync_from_sim()
        for k, v in zip(a[0::2], a[1::2]):
            if k == "every":
                self.neigh_every = int(v)
            elif k == "delay":
                self.neigh_delay = int(v)
            elif k == "check":
                self.neigh_check = v == "yes"
            else:
                raise _not_ported(f"neigh_modify keyword {k}")

    def cmd_fix(self, a):
        """fix ID all nve: the Simulation's own NVE integrator, which a run
        uses with or without it (as the JAX package's `_build_fixes` falls
        back to NVE); nothing else is ported."""
        group, style = a[1], a[2]
        if style != "nve":
            raise _not_ported(f"fix style {style}")
        if group != "all":
            raise _not_ported(f"fix on group {group}")
        if len(a) > 3:
            raise _not_ported(f"fix nve arguments {' '.join(a[3:])}")
        self._sync_from_sim()

    def cmd_unfix(self, a):
        self._sync_from_sim()

    def cmd_timestep(self, a):
        self._sync_from_sim()
        self.dt = float(a[0])

    def cmd_thermo(self, a):
        self.thermo_every = int(a[0])

    def cmd_timer(self, a):
        """timer off|loop|normal|full (ref: src/timer.cpp
        Timer::modify_params): `normal` and `full` turn the spans on for
        the runs that follow, each run then ending with the task timing
        breakdown; `off` and `loop` turn them off."""
        for w in a:
            if w in ("normal", "full"):
                trace.enable()
            elif w in ("off", "loop"):
                trace.disable()
            else:
                raise _not_ported(f"timer keyword {w}")

    def cmd_thermo_style(self, a):
        """thermo_style one | custom <keywords> (ref: src/thermo.cpp)."""
        if a[0] == "one":
            self.thermo_style = None
            return
        if a[0] != "custom":
            raise _not_ported(f"thermo_style {a[0]}")
        for w in a[1:]:
            if w not in self._THERMO_COLS and not w.startswith("v_"):
                raise _not_ported(f"thermo_style keyword {w}")
        self.thermo_style = list(a[1:])

    def cmd_thermo_modify(self, a):
        for k, v in zip(a[0::2], a[1::2]):
            if k != "norm":
                raise _not_ported(f"thermo_modify keyword {k}")
            self.thermo_norm = v == "yes"
            if self.sim is not None:
                self.sim.thermo_norm = self.thermo_norm

    def cmd_reset_timestep(self, a):
        self.ntimestep = int(a[0])
        if self.sim is not None:
            self.sim.ntimestep = self.ntimestep

    # -- thermo output -------------------------------------------------------

    _THERMO_COLS = {
        "step": ("Step", "{:>10d}"), "temp": ("Temp", "{:>14.8g}"),
        "epair": ("E_pair", "{:>14.8g}"), "emol": ("E_mol", "{:>14.8g}"),
        "etotal": ("TotEng", "{:>14.8g}"), "press": ("Press", "{:>14.8g}"),
        "pe": ("PotEng", "{:>14.8g}"), "ke": ("KinEng", "{:>14.8g}"),
        "vol": ("Volume", "{:>14.8g}"), "atoms": ("Atoms", "{:>10d}"),
        "density": ("Density", "{:>14.8g}"), "lx": ("Lx", "{:>12.8g}"),
        "ly": ("Ly", "{:>12.8g}"), "lz": ("Lz", "{:>12.8g}"),
        "cpu": ("CPU", "{:>10.4g}"), "elapsed": ("Elaps", "{:>10d}"),
        "pxx": ("Pxx", "{:>14.8g}"), "pyy": ("Pyy", "{:>14.8g}"),
        "pzz": ("Pzz", "{:>14.8g}"), "pxy": ("Pxy", "{:>14.8g}"),
        "pxz": ("Pxz", "{:>14.8g}"), "pyz": ("Pyz", "{:>14.8g}"),
        "xlo": ("Xlo", "{:>12.8g}"), "xhi": ("Xhi", "{:>12.8g}"),
        "ylo": ("Ylo", "{:>12.8g}"), "yhi": ("Yhi", "{:>12.8g}"),
        "zlo": ("Zlo", "{:>12.8g}"), "zhi": ("Zhi", "{:>12.8g}"),
        "fmax": ("Fmax", "{:>14.8g}"), "fnorm": ("Fnorm", "{:>14.8g}"),
        "enthalpy": ("Enthalpy", "{:>14.8g}"), "dt": ("Dt", "{:>12.6g}"),
        "time": ("Time", "{:>12.8g}"),
        # CPU-rate keywords (ref: src/thermo.cpp compute_spcpu/tpcpu/
        # cpuremain): rates since the previous thermo line of this run
        "spcpu": ("S/CPU", "{:>12.6g}"), "tpcpu": ("T/CPU", "{:>12.6g}"),
        "cpuremain": ("CPULeft", "{:>12.6g}"),
    }

    def _thermo_columns(self):
        return self.thermo_style or ["step", "temp", "epair", "emol",
                                     "etotal", "press"]

    def _emit_thermo_row(self, sim, row, t0):
        """Completes a thermo row of `sim.run` in place (its keywords
        beyond the runner's), prints it, raises on a non-finite value, and
        returns it."""
        step_no = row["step"]
        row["atoms"] = row["natoms"]
        row["cpu"] = time.perf_counter() - t0
        row["elapsed"] = step_no - self._first_step
        row["time"] = step_no * sim.dt
        # CPU-rate keywords relative to the previous thermo line
        # (ref: src/thermo.cpp compute_spcpu/tpcpu/cpuremain)
        prev_step, prev_cpu = self._thermo_prev
        d_cpu = row["cpu"] - prev_cpu
        d_step = step_no - prev_step
        spcpu = d_step / d_cpu if d_cpu > 0 and d_step > 0 else 0.0
        row["spcpu"] = spcpu
        row["tpcpu"] = spcpu * self._thermo_keyword("dt")
        row["cpuremain"] = ((self._run_end - step_no) / spcpu if spcpu > 0
                            else 0.0)
        self._thermo_prev = (step_no, row["cpu"])
        row["lx"], row["ly"], row["lz"] = sim.state.box.prd.tolist()
        if "density" in self._thermo_columns():
            row["density"] = self._density(row)

        parts = []
        for c in self._thermo_columns():
            if c.startswith("v_"):
                row[c] = float(self._eval_expr(self._equal_vars[c[2:]]))
                parts.append("{:>14.8g}".format(row[c]))
                continue
            fmt = self._THERMO_COLS[c][1]
            v = row[c]
            parts.append(fmt.format(int(v) if "d" in fmt else v))
        self._emit(" ".join(parts))
        if not all(math.isfinite(v) for v in row.values()
                   if isinstance(v, float)):
            raise ScriptError(f"non-finite thermo at step {step_no}: {row}")
        return row

    # -- run -----------------------------------------------------------------

    def cmd_run(self, a):
        """run N [start S] [stop E] [pre yes|no] [post yes|no]: thermo at
        its cadence and on the last step (ref: src/output.cpp:339;
        src/run.cpp). `pre yes` (the default) recomputes the forces before
        a run that continues a built Simulation (ref: Verlet::setup)."""
        nsteps = int(a[0])
        pre = True
        for k, v in zip(a[1::2], a[2::2]):
            if k == "pre":
                pre = v == "yes"
            elif k not in ("start", "stop", "post"):
                raise _not_ported(f"run keyword {k}")
        fresh = self.sim is None
        sim = self._build_simulation()
        if pre and not fresh:
            sim.presetup_forces()
        self._emit(" ".join(
            (self._THERMO_COLS[c][0] if c in self._THERMO_COLS else c)
            for c in self._thermo_columns()))
        spans0 = trace.snapshot()["spans"] if trace.ON else None
        t0 = time.perf_counter()
        self._first_step = sim.ntimestep
        self._thermo_prev = (sim.ntimestep, 0.0)
        self._run_end = sim.ntimestep + nsteps
        rows = sim.run(nsteps, self.thermo_every,
                       lambda row: self._emit_thermo_row(sim, row, t0))
        if sim.state.x.is_cuda:
            torch.cuda.synchronize(sim.state.x.device)
        loop = time.perf_counter() - t0
        n = rows[-1]["natoms"]
        rate = nsteps / loop if loop > 0 else float("inf")
        self._emit(
            f"Loop time of {loop:.6g} on 1 procs for {nsteps} steps with "
            f"{n} atoms")
        self._emit(
            f"Performance: {rate:.3f} timesteps/s, "
            f"{n * nsteps / max(loop, 1e-9) / 1e6:.3f} Matom-step/s")
        # Finish-style statistics (ref: src/finish.cpp:127-460); no list
        # mode of the port (or of the JAX package) counts dangerous builds
        self._emit(f"Neighbor list builds = {int(sim.nl.nbuilds)}  "
                   "Dangerous builds = 0")
        if spans0 is not None:
            self._emit_timer_breakdown(spans0, trace.snapshot()["spans"],
                                       loop)
        self.ntimestep = sim.ntimestep
        return rows

    def _emit_timer_breakdown(self, before: dict, after: dict, loop: float):
        """LAMMPS's task timing breakdown (ref: src/finish.cpp:127-460)
        from the spans of one run (`before`, `after`: `trace.snapshot()`'s
        span aggregates around it). Pair and Neigh are the `pair` and
        `neigh` spans, Output the thermo rows' own time (`output` less its
        pair pass and read), Sync the host's waits on the device
        (`segment.read`, `output.read`), Other the rest of the loop."""

        def spent(name, key="total_s"):
            return (after.get(name, {}).get(key, 0.0)
                    - before.get(name, {}).get(key, 0.0))

        rows = [("Pair", spent("pair")), ("Neigh", spent("neigh")),
                ("Output", spent("output", "self_s")),
                ("Sync", spent("segment.read") + spent("output.read"))]
        other = loop - sum(t for _, t in rows)

        def pct(t):
            return 100.0 * t / loop if loop > 0 else 0.0

        self._emit("")
        self._emit("MPI task timing breakdown (host times: the device runs "
                   "asynchronously, and Sync holds the waits for it):")
        self._emit("Section |  min time  |  avg time  |  max time  |%varavg|"
                   " %total")
        self._emit("-" * 63)
        for name, t in rows:
            self._emit(f"{name:<8}|{t:< 12.5g}|{t:< 12.5g}|{t:< 12.5g}|"
                       f"{0.0:6.1f} |{pct(t):6.2f}")
        self._emit(f"{'Other':<8}|{'':12}|{other:< 12.5g}|{'':12}|{'':7}|"
                   f"{pct(other):6.2f}")

    def _build_simulation(self):
        from .runner import Simulation

        if self.sim is not None:
            return self.sim
        if self.box is None or not self.positions:
            raise ScriptError("no system defined before run")

        with trace.span("setup.atoms"):
            state = create_state(
                np.asarray(self.positions), self.box,
                types=np.asarray(self.types, dtype=np.int32),
                velocities=self.velocities, masses=self._mass_table(),
                units_name=self.units_name, dtype=self.dtype,
                device=self.device)
        sim = Simulation(
            state, self._build_forcefield(), dt=self.dt, skin=self.skin,
            neigh_every=self.neigh_every, neigh_delay=self.neigh_delay,
            neigh_check=self.neigh_check, list_mode=self.list_mode)
        sim.thermo_norm = self.thermo_norm
        sim.setup()
        sim.ntimestep = self.ntimestep
        self.sim = sim
        return sim

    def _build_forcefield(self) -> ForceField:
        """The pair style from pair_style + pair_coeff (the factory
        analog of force->create_pair, ref: src/force.cpp:83-121)."""
        if not self.pair_style_words:
            raise ScriptError("run needs a pair_style")
        name, args = self.pair_style_words[0], self.pair_style_words[1:]
        if name == "lj/cut":
            from .models.pair_lj import make_lj_cut

            pair = make_lj_cut(self.ntypes, self._pair_coeff_dict(),
                               float(args[0]), dtype=self.dtype,
                               device=self.device)
        elif name == "tersoff":
            from .models.pair_tersoff import make_tersoff

            c = self.pair_coeffs[-1] if self.pair_coeffs else []
            if c[:2] != ["*", "*"] or len(c) < 4:
                raise ScriptError("pair_coeff for tersoff: * * <file> "
                                  "<element per type>")
            pair = make_tersoff(self.ntypes, c[2], c[3:])
        else:  # eam (cmd_pair_style admits nothing else)
            from .models.pair_eam import make_eam_funcfl

            files = {int(c[0]): c[2] for c in self.pair_coeffs}
            pair = make_eam_funcfl(self.ntypes, files, dtype=self.dtype,
                                   device=self.device)
        return ForceField(pair=pair)

    def _pair_coeff_dict(self):
        coeffs = {}
        for c in self.pair_coeffs:
            ii = (range(1, self.ntypes + 1) if c[0] == "*"
                  else [int(c[0])])
            jj = (range(1, self.ntypes + 1) if c[1] == "*"
                  else [int(c[1])])
            vals = tuple(float(v) for v in c[2:])
            for i in ii:
                for j in jj:
                    if j >= i:
                        coeffs[(i, j)] = vals
        return coeffs
