"""The comparison that decides `correct`.

What the window produced is read after it closes: the end state (positions,
velocities and the forces of the last step, by atom tag), the last thermo
row, and the state at the start of the last segment (the snapshot the
harness keeps at each thermo row). The float64 reference (`reference/`)
then gives four numbers:

- `force_gap`: the widest gap between a program force and the reference's
  force at the program's end positions, over the reference's rms force
  (the force kernels, and the re-binning's map of rows to atoms). From
  each atom's gap the forces of its pairs in the cutoff band are taken
  off (`models.CUTOFF_BAND`): float32 rounding may decide those either
  way, and the decks' potentials are not zero at the cutoff;
- `position_rms`: the rms over atoms of the minimum-image distance between
  the program's end positions and the reference's, run from the snapshot
  for the same steps (the step loop, the integrator and the re-binning).
  An rms, not the widest gap: a pair that float32 takes on the other side
  of the cutoff kicks its two atoms, and the kicks spread, so the widest
  gap of a million atoms swings from seed to seed;
- `velocity_rms`: the same for velocities, over the reference's rms speed;
- `thermo_gap`: the largest relative gap of the last thermo row's pe, press
  and temp against the reference at the program's end state (pressure
  against `press_scale`, since a pressure can be near 0).

Each number has a limit of its own per cell (`limits/<cell>.json`); the
run is correct when every number is finite and within its limit and the
health checks hold. The control (`control_numbers`) is the reference in
the program's place one precision below the configuration's.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

from . import decks, lookup
from .reference import md
from .reference.models import CONTROL, CUTOFF_BAND, REF
from .reference.neighbors import min_image

NUMBERS = ("force_gap", "position_rms", "velocity_rms", "thermo_gap")
ROOT = Path(__file__).resolve().parent
LIMITS = ROOT / "limits"
REFERENCE = ROOT / "reference"


def system_for(config: dict, mix: dict, device, potential_path=None):
    """The reference's view of a deck: box, mass, step, units, model. The
    model and mass come from `build(config, potential_path, band)` of
    `reference/pair_<style>.py` (`/` in the style read as `_`)."""
    prd = torch.tensor(decks.box_lengths(config, mix), dtype=torch.float64,
                       device=device)
    style = config["pair"]["style"]
    model, mass = lookup.module(
        REFERENCE, "pair_" + style.replace("/", "_"),
        f"reference of pair style {style!r}").build(
            config, potential_path, CUTOFF_BAND[config["dtype"]])
    return md.System(prd=prd, mass=mass, dt=config["timestep"],
                     units=config["units"], model=model,
                     skin=config["reference_skin"])


def _rms(a: torch.Tensor) -> float:
    return float(torch.sqrt((a.double() ** 2).sum(-1).mean()))


def gaps(system, end: dict, row: dict, traj_ref) -> dict:
    """The four numbers of one end state against the reference.
    end: {x, v, f} by tag; row: {pe, press, temp}; traj_ref: the
    reference's (x, v) after the same steps from the same snapshot."""
    th = md.thermo(system, end["x"].double(), end["v"].double(), REF)
    f_ref = th["f"]
    x_ref, v_ref = traj_ref
    dx = min_image(end["x"].double() - x_ref, system.prd)
    gap = ((end["f"].double() - f_ref).norm(dim=-1) - th["band"]).clamp(
        min=0.0)
    return {
        "force_gap": float(gap.max()) / _rms(f_ref),
        "position_rms": _rms(dx),
        "velocity_rms": _rms(end["v"].double() - v_ref) / _rms(v_ref),
        "thermo_gap": max(
            abs(row["pe"] - th["pe"]) / abs(th["pe"]),
            abs(row["press"] - th["press"]) / th["press_scale"],
            abs(row["temp"] - th["temp"]) / th["temp"]),
    }


def control_numbers(system, snap: dict, steps: int, traj_ref,
                    dtype: str) -> dict:
    """The control in the program's place: the reference one precision
    below the configuration's `dtype` (bfloat16 pair arithmetic over
    float32 state for float32; float32 for float64), from the same
    snapshot, with its own thermo row, held to the same numbers."""
    prec = CONTROL[dtype]
    x, v, f = md.integrate(system, snap["x"], snap["v"], steps, prec)
    row = md.thermo(system, x, v, prec)
    return gaps(system, {"x": x, "v": v, "f": f}, row, traj_ref)


def load_limits(cell: str) -> dict:
    path = LIMITS / f"{cell}.json"
    if not path.exists():
        return {}
    return {k: float(v["limit"]) for k, v in
            json.loads(path.read_text()).items()}


def judge(numbers: dict, limits: dict, health: list) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every number finite and within
    its limit, every health check true."""
    shown, ok = {}, True
    for name in NUMBERS:
        value = numbers.get(name, float("nan"))
        limit = limits.get(name)
        shown[name] = {"value": value, "limit": limit}
        if limit is None or not math.isfinite(value) or value > limit:
            ok = False
    for name, passed, detail in health:
        shown[name] = {"value": detail, "limit": "true"}
        ok = ok and passed
    return ok, shown
