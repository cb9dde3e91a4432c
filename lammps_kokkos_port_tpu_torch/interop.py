"""Conversion between the JAX package's objects and the port's.

The JAX package's `State`, `PairLJCut`, `PairEAM` and `CellListDense`
arrive here as plain dicts of numpy arrays plus their static fields (field
names as in the JAX dataclasses; the box and the neighbor params as nested
dicts), so this module imports neither jax nor the JAX package. The tests
use it to feed both packages the same state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.box import Box
from .core.state import State
from .models.pair_eam import PairEAM
from .models.pair_lj import PairLJCut
from .ops.cellforce import CellListDense
from .ops.neighbor import NeighborParams

_STATE_ARRAYS = ("x", "v", "f", "type", "tag", "image", "q", "molecule",
                 "mass", "mask", "virial")
_PAIR_ARRAYS = ("lj1", "lj2", "lj3", "lj4", "cutsq", "offset")
_EAM_ARRAYS = ("frho_spline", "rhor_spline", "z2r_spline", "type2frho",
               "type2rhor", "type2z2r", "cutsq")
_EAM_STATIC = {"ntypes": int, "nrho": int, "nr": int, "drho": float,
               "dr": float, "rhomax": float, "cutmax": float}


def dataclass_to_arrays(obj) -> dict:
    """{field: numpy array or static value} of a dataclass instance, such
    as the JAX package's State or PairLJCut. Nested dataclasses (the box)
    become nested dicts; array fields go through np.asarray."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = dataclass_to_arrays(v)
        elif v is None or isinstance(v, (bool, int, float, str, tuple,
                                         dict)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def _tensor(a, device):
    return None if a is None else torch.from_numpy(
        np.array(a, copy=True)).to(device)


def state_from_arrays(d: dict, device="cpu") -> State:
    """Port State from {field: numpy array or static value}; `d["box"]`
    is {"lo", "hi", "tilt", "periodic", "triclinic"}."""
    b = d["box"]
    if b.get("triclinic", False):
        raise NotImplementedError("triclinic boxes are not ported yet")
    box = Box(lo=_tensor(b["lo"], device), hi=_tensor(b["hi"], device),
              tilt=_tensor(b["tilt"], device),
              periodic=tuple(bool(p) for p in b["periodic"]))
    return State(
        **{k: _tensor(d.get(k), device) for k in _STATE_ARRAYS},
        box=box, nlocal=int(d["nlocal"]), ntimestep=int(d["ntimestep"]),
        aux={}, units_name=d["units_name"], dimension=int(d["dimension"]),
        owned_all=bool(d["owned_all"]),
    )


def state_to_arrays(state: State) -> dict:
    """Inverse of state_from_arrays (aux is not carried)."""
    host = lambda a: None if a is None else a.detach().cpu().numpy()  # noqa
    d = {k: host(getattr(state, k)) for k in _STATE_ARRAYS}
    d["box"] = {"lo": host(state.box.lo), "hi": host(state.box.hi),
                "tilt": host(state.box.tilt),
                "periodic": state.box.periodic,
                "triclinic": state.box.triclinic}
    d.update(nlocal=state.nlocal, ntimestep=state.ntimestep,
             units_name=state.units_name, dimension=state.dimension,
             owned_all=state.owned_all)
    return d


def pair_from_arrays(d: dict, device="cpu") -> PairLJCut:
    """Port PairLJCut from {table: numpy array, "ntypes", "cut_global_max"}."""
    return PairLJCut(**{k: _tensor(d[k], device) for k in _PAIR_ARRAYS},
                     ntypes=int(d["ntypes"]),
                     cut_global_max=float(d["cut_global_max"]))


def pair_to_arrays(pair: PairLJCut) -> dict:
    d = {k: getattr(pair, k).detach().cpu().numpy() for k in _PAIR_ARRAYS}
    d.update(ntypes=pair.ntypes, cut_global_max=pair.cut_global_max)
    return d


def pair_eam_from_arrays(d: dict, device="cpu") -> PairEAM:
    """Port PairEAM from {table: numpy array, static field: value}, the
    field names of the JAX PairEAM (spline tables, type maps, cutsq)."""
    return PairEAM(**{k: _tensor(d[k], device) for k in _EAM_ARRAYS},
                   **{k: cast(d[k]) for k, cast in _EAM_STATIC.items()})


def pair_eam_to_arrays(pair: PairEAM) -> dict:
    d = {k: getattr(pair, k).detach().cpu().numpy() for k in _EAM_ARRAYS}
    d.update({k: getattr(pair, k) for k in _EAM_STATIC})
    return d


def cell_list_from_arrays(d: dict, device="cpu") -> CellListDense:
    """Port CellListDense from {field: numpy array or static value}, the
    field names of the JAX CellListDense (`params` as a nested dict of the
    NeighborParams fields; `ndanger` is not carried)."""
    p = dict(d["params"])
    p["ncells"] = tuple(int(n) for n in p["ncells"])
    p["images"] = tuple(int(n) for n in p["images"])
    return CellListDense(
        buckets=_tensor(d["buckets"], device),
        stencil=_tensor(d["stencil"], device),
        xhold=_tensor(d["xhold"], device), ago=int(d["ago"]),
        nbuilds=int(d["nbuilds"]),
        overflow=_tensor(np.asarray(d["overflow"], dtype=bool), device),
        params=NeighborParams(**p))


def cell_list_to_arrays(cl: CellListDense) -> dict:
    """Inverse of cell_list_from_arrays."""
    host = lambda a: a.detach().cpu().numpy()  # noqa: E731
    return {"buckets": host(cl.buckets), "stencil": host(cl.stencil),
            "xhold": host(cl.xhold), "ago": cl.ago, "nbuilds": cl.nbuilds,
            "overflow": host(cl.overflow),
            "params": dataclasses.asdict(cl.params)}
