"""Command-line runner: `python -m lammps_kokkos_port_tpu_torch.cli -in in.lj`.

Port of `lammps_kokkos_port_tpu/cli.py`, the analog of the reference's
main() driver (ref: src/main.cpp:40-117, CLI flags src/lammps.cpp:267-455):
reads an input script and executes it with `script.LammpsScript`. Flags:
-in/-i, -log/-l, -echo/-e, -var/-v name value, -fp64 (float64 instead of
float32), -device cuda|cpu (default cuda; without a CUDA device it
raises instead of running on the CPU).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="lammps_kokkos_port_tpu_torch")
    ap.add_argument("-in", "-i", dest="infile", required=True)
    ap.add_argument("-log", "-l", dest="logfile", default=None)
    ap.add_argument("-echo", "-e", dest="echo", default="none",
                    choices=["none", "screen", "log", "both"])
    ap.add_argument("-var", "-v", dest="vars", nargs=2, action="append",
                    default=[], metavar=("NAME", "VALUE"))
    ap.add_argument("-fp64", action="store_true", help="run in float64")
    ap.add_argument("-device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass -device cpu to run on the "
                           "CPU")

    from .script import LammpsScript

    script = LammpsScript(
        dtype=torch.float64 if args.fp64 else torch.float32,
        device=args.device,
        log_file=args.logfile,
        echo=args.echo in ("screen", "both"),
        var_overrides=dict(args.vars),
    )
    script.file(args.infile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
