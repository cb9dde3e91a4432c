"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit) and the operations each kernel's work needs.

A kernel's work (`kernels/<kernel>.json`) is counted per unordered pair
within the model's cutoff (`pair_ops`), each pair once, so that a
full-stencil kernel and a Newton-half kernel are held to the same work;
per atom (`row_ops`); and, where the file gives `triplet_ops`, per
ordered triplet (i; j, k), j != k, with r_ij and r_ik both within the
cutoff (a three-body kernel). The counts come from the end state's
positions (`reference.neighbors.work_counts`: `pairs`, `atoms` and, only
where some kernel of the cell names `triplet_ops`, `triplets`). A count
is a number, or the name of a constant below. lj: displacement 3, r2 5,
cutoff 1, 1/r2 1, r6 2, fpair 4, fij 3, +f_i 3, -f_j 3. EAM: displacement,
r2 and cutoff 9, clamp 2, each Chebyshev series 2 + 3 per coefficient (29
for rho, 28 each for a and b), rho +2; force fpair 4, fij 3, +f_i 3, -f_j
3. The rho sweep's fp epilogue, per row: clamp 2, sqrt 1, the argument 2,
the Fp_s series (80 coefficients), 2 s and the divide 2. Bytes: each input
read once, each output written once, per atom.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}

LJ_PAIR_OPS = 25
EAM_RHO_PAIR_OPS = 9 + 2 + (2 + 3 * 29) + 2
EAM_FORCE_PAIR_OPS = 9 + 2 + 2 * (2 + 3 * 28) + 4 + 9
EAM_FP_ROW_OPS = 2 + 1 + 2 + (2 + 3 * 80) + 2

KERNELS = Path(__file__).resolve().parent / "kernels"


def _count(v) -> int:
    """A count given as a number or as the name of a constant above."""
    return int(globals()[v]) if isinstance(v, str) else int(v)


def kernel_work(kernel: str) -> dict:
    """{pair_ops, row_ops[, triplet_ops], bytes_per_atom: {dtype: n}} of a
    kernel's call, from `kernels/<kernel>.json`; None when the file is not
    there."""
    path = KERNELS / f"{kernel}.json"
    if not path.exists():
        return None
    spec = json.loads(path.read_text())
    work = {"pair_ops": _count(spec["pair_ops"]),
            "row_ops": _count(spec["row_ops"]),
            "bytes_per_atom": spec["bytes_per_atom"]}
    if "triplet_ops" in spec:
        work["triplet_ops"] = _count(spec["triplet_ops"])
    return work


def needs_triplets(kernels) -> bool:
    """Whether some kernel's work is counted per triplet."""
    return any("triplet_ops" in (kernel_work(k) or {}) for k in kernels)


def work_ops(kernel: str, counts: dict) -> int:
    """Operations of one call of `kernel` on `counts` (`pairs`, `atoms`,
    and `triplets` where the kernel names `triplet_ops`)."""
    w = kernel_work(kernel)
    ops = counts["pairs"] * w["pair_ops"] + counts["atoms"] * w["row_ops"]
    if "triplet_ops" in w:
        ops += counts["triplets"] * w["triplet_ops"]
    return ops


def bound_of(ops: int, nbytes: int, dtype: str) -> dict:
    """The least time of a pass of `ops` operations moving `nbytes`: the
    larger of the operations over the peak of `dtype` and the bytes over
    the HBM rate."""
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return {"bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def kernel_bound(kernel: str, counts: dict, dtype: str) -> dict:
    """`bound_of` one call of `kernel` on `counts`."""
    nbytes = counts["atoms"] * kernel_work(kernel)["bytes_per_atom"][dtype]
    return bound_of(work_ops(kernel, counts), nbytes, dtype)


def kernel_share(kernel: str, traced: dict, counts: dict, dtype: str):
    """Percent of the roofline one call of `kernel` reaches: its bound over
    its device time per call in the trace. None when the trace holds no
    call of it (a later design took it off the path)."""
    seen = traced["kernels"].get(kernel)
    if not seen or kernel_work(kernel) is None:
        return None
    per_call = seen["total_s"] / seen["calls"]
    return 100.0 * kernel_bound(kernel, counts, dtype)["bound_s"] / (
        per_call)
