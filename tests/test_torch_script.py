"""PyTorch port, the input-deck entry point (script.LammpsScript, cli)
against the JAX package's interpreter.

CPU, fp64. The deck is the examples/melt deck of tests/test_script.py,
carried inline, and a shorter cut of it. Thermo rows are compared at rel
1e-10 (the packages sum forces in another order). The in.eam-style deck
is held against JAX in test_torch_eam_step.py, beside the JAX sorted EAM
run it shares.

The JAX side runs the melt deck in list mode "cell": its default ("auto"
-> "sorted") runs the Pallas kernels in interpret mode, about 35 s of
compiles here. On this 3x3x3-cell grid the cell and sorted modes bin the
same atoms into the same cells, so they find the same pairs and give the
same rows to rounding; the sorted layout's own parity with JAX sorted mode
is held by test_torch_lj_melt.py.
"""

import jax.numpy as jnp
import pytest
import torch

from lammps_kokkos_port_tpu.script import LammpsScript as JaxScript
from lammps_kokkos_port_tpu_torch import cli
from lammps_kokkos_port_tpu_torch.script import LammpsScript, ScriptError

RTOL = 1e-10
KEYS = ("temp", "epair", "emol", "etotal", "press")

MELT_DECK = """
units           lj
atom_style      atomic
lattice         fcc 0.8442
region          box block 0 6 0 6 0 6
create_box      1 box
create_atoms    1 box
mass            1 1.0
velocity        all create 3.0 87287 loop geom
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
neigh_modify    every 20 delay 0 check no
fix             1 all nve
thermo          50
run             50
"""

# the melt deck cut to 20 steps (the cell-mode plain force pass is slow on
# a CPU), in one segment: an overflow retry re-bins from the segment's
# start, and a retry from an unwrapped mid-run snapshot diverges between
# the packages (ROADMAP.md, fault F4)
SHORT_MELT_DECK = MELT_DECK.replace("thermo          50\nrun             50",
                                    "thermo          20\nrun             20")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs: the suite runs in
    several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_deck(script_cls, text, **kw):
    """Run deck text line by line; returns (script, thermo rows)."""
    s = script_cls(**kw)
    rows = []
    emit = s._emit_thermo_row
    s._emit_thermo_row = lambda *a: rows.append(emit(*a)) or rows[-1]
    for line in text.strip().splitlines():
        s.one(line)
    return s, rows


def assert_rows_match(rows, ref_rows):
    assert [r["step"] for r in rows] == [r["step"] for r in ref_rows]
    for r, rr in zip(rows, ref_rows):
        for k in KEYS:
            assert r[k] == pytest.approx(rr[k], rel=RTOL, abs=1e-12), (
                r["step"], k)


def thermo_lines(script):
    """Header, rows and the neighbor-build line; not the timings."""
    return [ln for ln in script._log_lines
            if not ln.startswith(("Loop time", "Performance"))]


@pytest.fixture(scope="module")
def jax_short_melt():
    return run_deck(JaxScript, SHORT_MELT_DECK, dtype=jnp.float64,
                    list_mode="cell")


@pytest.fixture(scope="module")
def port_short_melt():
    return {mode: run_deck(LammpsScript, SHORT_MELT_DECK,
                           dtype=torch.float64, list_mode=mode)
            for mode in ("auto", "cell")}


def test_melt_deck_step0_golden():
    """examples/melt step 0 (log.8Apr21.melt.g++.1): 864 atoms at the
    golden's T and density give its intensive thermo."""
    s, rows = run_deck(LammpsScript, MELT_DECK, dtype=torch.float64)
    assert s.sim.list_mode == "sorted"  # "auto" takes the sorted layout
    assert rows[0]["temp"] == pytest.approx(3.0, abs=1e-12)
    assert rows[0]["epair"] == pytest.approx(-6.7733681, abs=2e-7)
    assert s._log_lines[1].split()[:3] == ["0", "3", "-6.7733681"]
    assert [r["step"] for r in rows] == [0, 50]


@pytest.mark.parametrize("mode", ["auto", "cell"])
def test_melt_deck_matches_jax(jax_short_melt, port_short_melt, mode):
    """The same deck through both interpreters: the same header, rows at
    rel 1e-10 and the same neighbor-build count."""
    js, jrows = jax_short_melt
    s, rows = port_short_melt[mode]
    assert s.sim.list_mode == ("sorted" if mode == "auto" else "cell")
    assert_rows_match(rows, jrows)
    lines, jlines = thermo_lines(s), thermo_lines(js)
    assert lines[0] == jlines[0] == "Step Temp E_pair E_mol TotEng Press"
    assert lines[-1] == jlines[-1] == (
        "Neighbor list builds = 2  Dangerous builds = 0")


def test_cell_mode_matches_auto(port_short_melt):
    """list_mode="cell" (the K6 path) prints the rows of "auto"."""
    (_, auto_rows), (_, cell_rows) = (port_short_melt["auto"],
                                      port_short_melt["cell"])
    assert_rows_match(cell_rows, auto_rows)


CONTROL_DECK = """
variable        n index 2
variable        a equal 3*$n
variable        i loop 3
label           top
print           "iter $i of ${n}: $(v_a*v_i)"
next            i
jump            SELF top
if "$n < 2" then "print low" elif "$n < 4" "print mid" else "print high"
include         INC
print           "done $(2^3)"
"""


def test_control_flow_and_var_override_match_jax(tmp_path):
    """label/jump/next, if/elif/else, include, equal-style variables and a
    -var override print what the JAX interpreter prints."""
    inc = tmp_path / "inc.in"
    inc.write_text('variable s string hello\nprint "from include: ${s}"\n')
    deck = tmp_path / "in.control"
    deck.write_text(CONTROL_DECK.replace("INC", str(inc)))
    out = {}
    for name, cls, dt in (("port", LammpsScript, torch.float64),
                          ("jax", JaxScript, jnp.float64)):
        s = cls(dtype=dt, var_overrides={"n": "3"})
        s.file(str(deck))
        out[name] = s._log_lines
    assert out["port"] == out["jax"]
    assert out["port"] == ["iter 1 of 3: 9", "iter 2 of 3: 18",
                           "iter 3 of 3: 27", "mid", "from include: hello",
                           "done 8"]


def test_unknown_command_raises():
    with pytest.raises(ScriptError, match="definitely_not_a_command"):
        LammpsScript().one("definitely_not_a_command 1 2 3")


@pytest.mark.parametrize("line,what", [
    ("fix 1 all nvt temp 1.0 1.0 0.1", "fix style nvt"),
    ("pair_style lj/cut/coul/long 10.0", "pair_style lj/cut/coul/long"),
    ("boundary p p f", "boundary p p f"),
    ("compute 1 all temp", "'compute'"),
])
def test_unported_command_raises_naming_it(line, what):
    with pytest.raises(ScriptError, match=what):
        LammpsScript().one(line)


def test_cli_runs_a_deck(tmp_path, capsys):
    """`python -m lammps_kokkos_port_tpu_torch.cli -in deck -device cpu`:
    -var, -log and -fp64 as the JAX cli takes them."""
    deck = tmp_path / "in.melt"
    deck.write_text(MELT_DECK.replace("block 0 6 0 6 0 6",
                                      "block 0 $n 0 $n 0 $n")
                    .replace("thermo          50\nrun             50",
                             "thermo          5\nrun             5"))
    log = tmp_path / "log.melt"
    assert cli.main(["-in", str(deck), "-device", "cpu", "-fp64",
                     "-var", "n", "6", "-log", str(log)]) == 0
    text = log.read_text().splitlines()
    assert text[0] == "Step Temp E_pair E_mol TotEng Press"
    assert text[1].split()[:3] == ["0", "3", "-6.7733681"]
    assert text[3].startswith("Loop time of ")
    assert text[3].endswith("for 5 steps with 864 atoms")
    assert "Loop time of " in capsys.readouterr().out
    if not torch.cuda.is_available():
        # the default device is the card: no silent run on the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["-in", str(deck)])
