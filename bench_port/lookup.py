"""Lookups by name. Each part of the benchmark that depends on a
configuration, a mix or a metric lives in a file of its own, which the
harness finds by the name `BENCHMARK.json` or the configuration gives:
`potentials/<kind>.py`, `reference/pair_<style>.py`, `metrics/<name>.py`
(the kernel work files of `roofline/kernels/` are JSON). A new
configuration then adds files and edits none."""

from __future__ import annotations

import importlib.util
from pathlib import Path


def module(directory: Path, stem: str, what: str):
    """The module of `<directory>/<stem>.py`, loaded from its file;
    FileNotFoundError naming the file where there is none."""
    path = Path(directory) / f"{stem}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{what}: no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_port_lookup_{abs(hash(str(path)))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
