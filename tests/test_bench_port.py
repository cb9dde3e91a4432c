"""The benchmark's own CPU tests (bench_port/tests), collected here so that
the suite runs them, each under its own name.

Two of them run a cell through `harness.run_cell`, whose health checks
include that jax is not imported. This suite's conftest imports jax, so
those two run in a child interpreter, pytest on that one test alone, and
pass or fail as they do there.
"""

import subprocess
import sys
from pathlib import Path

from bench_port.tests.test_correct import *  # noqa: F401,F403
from bench_port.tests.test_lookup import *  # noqa: F401,F403
from bench_port.tests.test_yardstick import *  # noqa: F401,F403

REPO = Path(__file__).resolve().parents[1]


def _in_child(node: str):
    """bench_port/tests/<node> in a fresh interpreter, which imports no
    jax; its output is shown where it fails."""
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         f"bench_port/tests/{node}"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-6000:] + res.stderr[-3000:]


def test_sound_run_is_correct_and_the_control_is_not():  # noqa: F811
    _in_child("test_correct.py::"
              "test_sound_run_is_correct_and_the_control_is_not")


def test_a_configuration_added_as_files():  # noqa: F811
    _in_child("test_lookup.py::test_a_configuration_added_as_files")
