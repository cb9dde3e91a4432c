"""CPU self-tests of the benchmark's own arithmetic: the pair counter
against brute force, `bound_of` against a hand count, the deck generator,
every configuration against its deck, the potential writer and
BENCHMARK.json's wiring of cells and readers.

    python -m pytest bench_port/tests -q
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port import decks, harness
from bench_port.reference import eam_tables
from bench_port.reference.neighbors import half_pairs, work_counts
from bench_port.roofline import peaks

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())


def brute_pairs(x, prd, cut):
    d = x[:, None, :] - x[None, :, :]
    d = d - prd * np.round(d / prd)
    r2 = (d * d).sum(-1)
    i, j = np.nonzero(np.triu(r2 < cut * cut, k=1))
    return set(zip(i.tolist(), j.tolist()))


@pytest.mark.parametrize("seed,prd,cut", [
    (0, (7.5, 8.2, 9.1), 2.5), (1, (10.0, 7.6, 12.3), 2.5),
    (2, (20.0, 20.0, 20.0), 4.95), (3, (15.0, 16.0, 17.0), 3.1)])
def test_pairs_match_brute_force(seed, prd, cut):
    rng = np.random.default_rng(seed)
    prd = np.array(prd)
    x = rng.uniform(-0.5, 1.5, size=(400, 3)) * prd  # any image
    i, j = half_pairs(torch.tensor(x), torch.tensor(prd), cut)
    got = {(min(a, b), max(a, b)) for a, b in zip(i.tolist(), j.tolist())}
    assert len(got) == i.numel()  # each pair once
    assert got == brute_pairs(x, prd, cut)
    assert work_counts(torch.tensor(x), torch.tensor(prd), cut) == {
        "pairs": len(got), "atoms": 400}


def test_pairs_need_three_cells():
    with pytest.raises(ValueError):
        half_pairs(torch.zeros(2, 3), torch.tensor([5.0, 9.0, 9.0]), 2.5)


def test_fcc_pair_count_by_hand():
    # fcc at a = 1: 12 neighbours at 0.707 and 6 at 1.0, so a cutoff of
    # 1.1 counts 18 / 2 = 9 pairs an atom
    cells = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"),
                     -1).reshape(-1, 1, 3)
    basis = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    x = torch.tensor((cells + basis).reshape(-1, 3))
    assert work_counts(x, torch.tensor([4.0, 4.0, 4.0]), 1.1)[
        "pairs"] == 9 * 256


def test_op_counts_by_hand():
    assert peaks.LJ_PAIR_OPS == 3 + 5 + 1 + 1 + 2 + 4 + 3 + 3 + 3
    assert peaks.EAM_RHO_PAIR_OPS == 9 + 2 + 2 + 87 + 2 == 102
    assert peaks.EAM_FORCE_PAIR_OPS == 9 + 2 + 2 * 86 + 4 + 9 == 196
    assert peaks.EAM_FP_ROW_OPS == 2 + 1 + 2 + 242 + 2 == 249


def test_bound_of_by_hand():
    # 1e6 pairs x 25 ops = 2.5e7 ops: 2.5e7 / 67e12 s = 0.373 us;
    # 1e6 bytes / 3.35e12 = 0.299 us: operations bound
    b = peaks.bound_of(1_000_000 * 25, 1_000_000, "float32")
    assert b["bound_by"] == "operations"
    assert b["bound_s"] == pytest.approx(2.5e7 / 67e12, rel=1e-12)
    # 1e8 bytes: 29.85 us, bytes bound
    b = peaks.bound_of(1_000_000 * 25, 100_000_000, "float32")
    assert b["bound_by"] == "bytes"
    assert b["bound_s"] == pytest.approx(1e8 / 3.35e12, rel=1e-12)
    # rows: 1000 rows x 249 ops added to the pairs' operations, in f64
    b = peaks.bound_of(10 * 100 + 1000 * 249, 0, "float64")
    assert b["bound_s"] == pytest.approx((1000 + 249_000) / 34e12)


def test_kernel_bound_reads_the_work_files():
    # lj_cell_force on 1,024,000 atoms and 28.3M pairs: 7.075e8 ops at
    # 67 TFLOP/s (10.56 us) against 24.576 MB at 3.35 TB/s (7.34 us)
    b = peaks.kernel_bound("lj_cell_force", {"pairs": 28_300_000,
                                             "atoms": 1_024_000}, "float32")
    assert b["bound_by"] == "operations"
    assert b["bound_s"] == pytest.approx(28_300_000 * 25 / 67e12)
    w = peaks.kernel_work("eam_cell_rho")
    assert (w["pair_ops"], w["row_ops"]) == (102, 249)
    assert peaks.kernel_work("no_such_kernel") is None


def test_kernel_share_is_silent_without_the_kernel():
    traced = {"kernels": {"lj_cell_force": {"total_s": 2e-3, "calls": 2}}}
    counts = {"pairs": 1000, "atoms": 100}
    share = peaks.kernel_share("lj_cell_force", traced, counts, "float32")
    bound = peaks.kernel_bound("lj_cell_force", counts, "float32")
    assert share == pytest.approx(100 * bound["bound_s"] / 1e-3)
    assert peaks.kernel_share("eam_cell_rho", traced, counts,
                              "float32") is None


def test_deck_generator():
    config = json.loads((ROOT / "configs" / "eam-cu.json").read_text())
    lines, steps = decks.make_deck(config, 2**31 + 5, "/x/pot.eam",
                                   decks.CONFIGS)
    assert steps == config["run"] == 100
    vel = [ln for ln in lines if ln.startswith("velocity")]
    assert vel == [f"velocity all create 1600.0 {(2**31 + 5) % (2**31 - 2) + 1}"
                   " loop geom"]
    assert "pair_coeff 1 1 /x/pot.eam" in lines
    assert not any(ln.split()[:1] == ["run"] for ln in lines)
    assert decks.deck_seed(0) == 1 and decks.deck_seed(2**31 - 3) == 2**31 - 2


def check_deck(config: dict, text: str):
    """The configuration's numbers against the words of its deck."""
    def words(cmd):
        return next(ln.split()[1:] for ln in text.splitlines()
                    if ln.split()[:1] == [cmd])

    assert words("units") == [config["units"]]
    assert words("lattice") == [config["lattice"]["style"],
                                repr(config["lattice"]["scale"])]
    assert float(words("velocity")[2]) == config["velocity"]["temp"]
    assert int(words("velocity")[3]) == config["velocity"]["seed"]
    nb = config["neighbor"]
    assert float(words("neighbor")[0]) == nb["skin"]
    mod = dict(zip(words("neigh_modify")[0::2], words("neigh_modify")[1::2]))
    assert (int(mod["every"]), int(mod["delay"]), mod["check"] == "yes") == (
        nb["every"], nb["delay"], nb["check"])
    assert int(words("run")[0]) == config["run"]
    if "timestep" in text:
        assert float(words("timestep")[0]) == config["timestep"]
    if "thermo " in text:
        assert int(words("thermo")[0]) == config["thermo"]
    assert words("pair_style")[0] == config["pair"]["style"]
    if config["pair"]["style"] == "lj/cut":
        assert [float(v) for v in words("pair_style")[1:]] == [
            config["pair"]["cutoff"]]
        assert [float(v) for v in words("pair_coeff")[2:]] == [
            config["pair"]["epsilon"], config["pair"]["sigma"],
            config["pair"]["cutoff"]]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_numbers_match_the_deck(entry):
    path = ROOT.parent / entry["file"]
    config = json.loads(path.read_text())
    check_deck(config, (path.parent / config["deck"]).read_text())


def test_mix_sizes():
    config = json.loads((ROOT / "configs" / "lj-melt.json").read_text())
    for mix, n in (("scaled-32x", 1_024_000), ("published-32k", 32_000)):
        m = json.loads((ROOT / "mixes" / f"{mix}.json").read_text())
        assert decks.atoms(config, m) == n
    m = json.loads((ROOT / "mixes" / "scaled-32x.json").read_text())
    a = (4 / 0.8442) ** (1 / 3)
    assert decks.box_lengths(config, m) == pytest.approx([80 * a, 40 * a,
                                                          80 * a])


def test_potential_file_and_tables(tmp_path):
    spec = json.loads((ROOT / "configs" / "eam-cu.json").read_text())
    path = decks.potential(spec, decks.CONFIGS, tmp_path)
    assert Path(path) == tmp_path / "Cu_u3.eam"
    head = Path(path).read_text().splitlines()
    assert head[1].split()[:3] == ["29", "63.55", "3.615"]
    assert head[2].split()[0] == "500" and head[2].split()[2:] == [
        "500", "0.01", "4.95"]
    t = eam_tables.build(path, spec["math"])
    assert t["cutoff"] == 4.95 and t["mass"] == 63.55
    assert len(t["g"]) == 29 and len(t["F"]) == 81 and len(t["a"]) == 28
    # the fits follow the splines: rho at 2.556 A (the first fcc shell);
    # a degree-28 fit of the steep (a/r)^6 from 1.485 A agrees to ~3.4e-6
    rho_c = eam_tables.spline(eam_tables.resample(
        eam_tables.read_funcfl(path)["rhor"], 0.01, 499, 0.01), 0.01)
    want = eam_tables.spline_value(rho_c, 0.01, np.array([2.556]))[0][0]
    u_lo, u_hi = t["u_range"]
    tt = (2 * 2.556 ** 2 - u_lo - u_hi) / (u_hi - u_lo)
    got = np.polynomial.chebyshev.chebval(tt, t["g"])
    assert got == pytest.approx(want, rel=1e-5)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_wiring():
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        decks.load_cell(ROOT.parent / "BENCHMARK.json", w["name"])
        e2e, layer = harness.cell_metrics(BENCH, w["name"])
        assert any(m["name"] == "setup_s" for m in e2e) and len(e2e) >= 2
        assert layer
    for m in BENCH["per_layer"]:
        assert NAME.match(m["name"])
        assert set(m["workloads"]) <= cells
        harness.reader(m["name"])  # a reader file exists
        moved = next(e for e in BENCH["end_to_end"]
                     if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for c in BENCH["configs"]:
        assert (ROOT.parent / c["file"]).exists()
