"""The one generator of the benchmark's inputs: a cell of `BENCHMARK.json`
names a configuration (`configs/<name>.json` and its deck text) and a mix
(`mixes/<name>.json`); `make_deck` turns them and a seed into the deck the
port runs.

The deck is the published text with three changes, all from data: the
mix's `vars` are passed as `-var` values; the `velocity ... create T SEED`
line takes the run's seed (1 + seed mod 2147483646, the range LAMMPS's
RanPark accepts); a `pair_coeff` naming the configuration's `file_token`
names the written potential instead. The deck's last `run N` is split off:
the window repeats it (`N`, the deck's `thermo` cadence).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED_RANGE = 2**31 - 2


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict      # the workload's entry in BENCHMARK.json
    config: dict
    mix: dict
    bench: dict      # the whole of BENCHMARK.json

    @property
    def size_vars(self) -> dict:
        return {k: str(v) for k, v in self.mix["vars"].items()}


def load_cell(bench_path: Path, workload: str) -> Cell:
    bench = json.loads(Path(bench_path).read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in {bench_path}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((Path(bench_path).parent / conf["file"]).read_text())
    mix = json.loads((ROOT / "mixes" / f"{entry['traffic']}.json")
                     .read_text())
    return Cell(workload, entry, config, mix, bench)


def deck_seed(seed: int) -> int:
    return 1 + seed % SEED_RANGE


def make_deck(config: dict, seed: int, potential_path: str | None = None):
    """(setup lines, run steps): the deck text with the run's seed and the
    potential, without its last `run` line."""
    text = (ROOT / "configs" / config["deck"]).read_text()
    lines = text.splitlines()
    out, run_steps = [], None
    token = config["pair"].get("file_token")
    for line in lines:
        w = line.split("#")[0].split()
        if w[:1] == ["velocity"] and w[2:3] == ["create"]:
            w[4] = str(deck_seed(seed))
            line = " ".join(w)
        elif w[:1] == ["pair_coeff"] and token and token in w:
            if potential_path is None:
                raise ValueError("the deck reads a potential file: pass it")
            line = " ".join(potential_path if t == token else t for t in w)
        elif w[:1] == ["run"]:
            run_steps = int(w[1])
            continue
        out.append(line)
    if run_steps is None:
        raise ValueError(f"{config['deck']} has no run command")
    return out, run_steps


def box_lengths(config: dict, mix: dict) -> list[float]:
    """Box lengths the deck creates: `cells_per_var` lattice cells times
    each size variable (fcc: 4 atoms a cell; in lj units the lattice scale
    is a reduced density)."""
    lat = config["lattice"]
    if lat["style"] != "fcc":
        raise NotImplementedError(f"lattice {lat['style']}")
    a = ((4.0 / lat["scale"]) ** (1.0 / 3.0) if config["units"] == "lj"
         else lat["scale"])
    return [n * float(mix["vars"][v]) * a
            for n, v in zip(config["cells_per_var"], "xyz")]


def atoms(config: dict, mix: dict) -> int:
    n = 4
    for c, v in zip(config["cells_per_var"], "xyz"):
        n *= round(c * float(mix["vars"][v]))
    return n
