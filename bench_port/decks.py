"""The one generator of the benchmark's inputs: a cell of `BENCHMARK.json`
names a configuration (the JSON file its `configs` entry gives, with its
deck text and any potential data file beside it) and a mix
(`mixes/<name>.json`); `make_deck` turns them and a seed into the deck the
port runs, and `potential` provides the file the deck reads.

The deck is the published text with three changes, all from data: the
mix's `vars` are passed as `-var` values; the `velocity ... create T SEED`
line takes the run's seed (1 + seed mod 2147483646, the range LAMMPS's
RanPark accepts); a word equal to the configuration's `file_token` (in a
`pair_coeff` or an `include`) names the run's potential file instead. The
deck's last `run N` is split off: the window repeats it (`N`, the deck's
`thermo` cadence).
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

from . import lookup

ROOT = Path(__file__).resolve().parent
CONFIGS = ROOT / "configs"
MIXES = ROOT / "mixes"
POTENTIALS = ROOT / "potentials"
SEED_RANGE = 2**31 - 2
# atoms a unit cell of LAMMPS's cubic lattice styles (src/lattice.cpp)
BASIS = {"sc": 1, "bcc": 2, "fcc": 4, "diamond": 8}


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict      # the workload's entry in BENCHMARK.json
    config: dict
    mix: dict
    bench: dict      # the whole of BENCHMARK.json
    config_dir: Path   # where the deck and data files lie

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
    path = Path(bench_path).parent / conf["file"]
    config = json.loads(path.read_text())
    mix = json.loads((MIXES / f"{entry['traffic']}.json").read_text())
    return Cell(workload, entry, config, mix, bench, path.parent)


def deck_seed(seed: int) -> int:
    return 1 + seed % SEED_RANGE


def potential(config: dict, config_dir: Path, directory: Path):
    """The path of the configuration's potential file, provided in
    `directory` under its `file_token` name, or None where the
    configuration has no `potential`. `{"kind": k, ...}` is written by
    `write(path, spec)` of `potentials/<k>.py`; `{"file": f}` is the data
    file `f` beside the configuration, copied."""
    spec = config.get("potential")
    if spec is None:
        return None
    path = Path(directory) / config["pair"]["file_token"]
    if "kind" in spec:
        return lookup.module(POTENTIALS, spec["kind"],
                             f"potential kind {spec['kind']!r}").write(
                                 path, spec)
    if "file" in spec:
        source = Path(config_dir) / spec["file"]
        if not source.is_file():
            raise FileNotFoundError(f"potential file: no file {source}")
        shutil.copyfile(source, path)
        return str(path)
    raise ValueError("a potential names a `kind` or a `file`")


def make_deck(config: dict, seed: int, potential_path: str | None,
              config_dir: Path):
    """(setup lines, run steps): the deck text of `config_dir` with the
    run's seed and the potential, without its last `run` line."""
    text = (Path(config_dir) / config["deck"]).read_text()
    lines = text.splitlines()
    out, run_steps = [], None
    token = config["pair"].get("file_token")
    for line in lines:
        w = line.split("#")[0].split()
        if w[:1] == ["velocity"] and w[2:3] == ["create"]:
            w[4] = str(deck_seed(seed))
            line = " ".join(w)
        elif token and token in w:
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


def basis(config: dict) -> int:
    """Atoms a unit cell of the configuration's lattice style."""
    style = config["lattice"]["style"]
    if style not in BASIS:
        raise ValueError(f"lattice style {style!r}: the benchmark knows "
                         f"{', '.join(BASIS)}")
    return BASIS[style]


def box_lengths(config: dict, mix: dict) -> list[float]:
    """Box lengths the deck creates: `cells_per_var` lattice cells times
    each size variable. In lj units the lattice scale is a reduced density
    and a = (basis / scale)^(1/3); in the others it is a."""
    lat = config["lattice"]
    a = ((float(basis(config)) / lat["scale"]) ** (1.0 / 3.0)
         if config["units"] == "lj" else lat["scale"])
    return [n * float(mix["vars"][v]) * a
            for n, v in zip(config["cells_per_var"], "xyz")]


def atoms(config: dict, mix: dict) -> int:
    n = basis(config)
    for c, v in zip(config["cells_per_var"], "xyz"):
        n *= round(c * float(mix["vars"][v]))
    return n
