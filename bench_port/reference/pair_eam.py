"""The reference of `pair_style eam` (one element, funcfl): the dense
Chebyshev form that the configuration's `math` block states, fitted from
the run's potential file; the file gives the mass."""

from bench_port.reference import eam_tables
from bench_port.reference.models import EAM


def build(config: dict, potential_path, band: float):
    tables = eam_tables.build(potential_path, config["math"])
    return EAM(tables, band), tables["mass"]
