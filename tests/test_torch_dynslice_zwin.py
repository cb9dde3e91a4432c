"""PyTorch port, P1 and P12: the plain twins of prof/dynslice_kernels and
prof/zwin_kernels against the Pallas bodies of benchmarks/prof/
prof_dynslice.py and prof_zwin_proto.py in interpret mode on the CPU, and
the two entry points.

Both scripts run their benchmark when imported, so only their imports,
upper-case constants and function definitions are loaded (with `ast`), and
their `pl.pallas_call` is put in interpret mode.

- P1 on the script's `starts` and a seeded random `ext`, f32: the three
  bodies at G = 512, where every window fits and all three give 8 times the
  window sums, and at G = 128 (the shape the script's timed loop ran),
  where the rolls wrap and dynamic_slice clamps. rtol 1e-6, atol 1e-6*max
  (the bodies sum the accumulator's 8 equal rows, the twin scales by 8).
- P12 at a reduced shape (NCOL 26, S 64; the script's other shapes), f32,
  on the script's kind of inputs (`zwin_inputs`). rtol 1e-4, atol
  1e-4*max: interpret mode takes the approximate reciprocal in bfloat16
  (about 2^-8 relative) and one Newton step squares that to about 2^-16,
  which the r^-14 and r^-8 terms raise by up to 14x; the twin's reciprocal
  is exact before its Newton step. A few near-coincident pairs put max|f|
  near 1e8, so that atol alone would pass a wrong window: each element is
  also held to its own scale, the sum of the magnitudes of its terms
  (`zwin_reference(..., magnitude=True)`), within 2^-13 (the Newton step
  leaves 7 e^2 <= 7 * 2^-16 of that scale, plus f32 rounding). Planted
  faults (a window start moved by one, a neighbour column off by one) fail
  that check.
- P12 as two gathers (`zwin_gathers` below, a test aid that stays off the
  card path): each forward sum fT*[8k + i, c] over its own atom's lanes,
  and each reaction fL*[c, p] over the own atoms whose windows hold the
  candidate e*[c, p] (the own window of c: chunks k with l = p - G - 8k
  in [0, WS), atoms i < l; for each w the source column c - off_w at its
  row-0 start st: chunks k with p - st - k in [0, WN), all 8 atoms). Held
  against `zwin_reference` and the script's kernel, per element to the
  same scale within SCALED_RTOL, at NCOL 26, 2 and 12. The starts moved by
  one must fail that check.
"""

import ast
import dataclasses
import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lammps_kokkos_port_tpu_torch.prof import dynslice, zwin_proto
from lammps_kokkos_port_tpu_torch.prof import dynslice_kernels as dk
from lammps_kokkos_port_tpu_torch.prof import zwin_kernels as zk

PROF = Path(__file__).resolve().parents[1] / "benchmarks" / "prof"
SMALL = zk.ZwinShape(ncol=26, s=64)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_definitions(name, **constants):
    """The imports, upper-case constants and functions of
    benchmarks/prof/<name>.py, without its module-level run; `constants`
    then replace the script's; `pl.pallas_call` in interpret mode."""
    tree = ast.parse((PROF / f"{name}.py").read_text())
    keep = [node for node in tree.body
            if isinstance(node, (ast.Import, ast.ImportFrom, ast.FunctionDef))
            or (isinstance(node, ast.Assign)
                and all(isinstance(t, (ast.Name, ast.Tuple))
                        and all(n.id.isupper() for n in ast.walk(t)
                                if isinstance(n, ast.Name))
                        for t in node.targets))]
    ns = {"__name__": f"_{name}"}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(PROF / name),
                 "exec"), ns)
    ns.update(constants)
    interp = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                      if not k.startswith("__")})
    interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    ns["pl"] = interp
    return types.SimpleNamespace(**ns)


@pytest.fixture(scope="module")
def ds():
    return load_definitions("prof_dynslice")


def dynslice_body(mod, kern, starts, ext):
    """prof_dynslice.py:52-59, `run`'s pallas_call, on (starts, ext), with
    64-bit types off as the script runs (kern_ds2d's literal start 0 would
    be int64 against the int32 table entry)."""
    with jax.enable_x64(False):
        return _dynslice_call(mod, kern, starts, ext)


def _dynslice_call(mod, kern, starts, ext):
    return pl.pallas_call(
        kern,
        grid=(mod.NCOL,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((mod.NCOL, mod.W), jnp.float32),
        interpret=True,
    )(starts, ext)


@pytest.mark.parametrize("g", [512, 128])
def test_dynslice_twin_matches_the_three_bodies(ds, g):
    assert (ds.G, ds.W, ds.NCH, ds.NCOL) == (dynslice.G, dynslice.W,
                                              dynslice.NCH, dynslice.NCOL)
    starts = dynslice.script_starts("cpu")
    ext = np.random.default_rng(3).standard_normal(
        (ds.NCOL, g)).astype(np.float32)
    twins = {mode: dk.dynslice_reference(starts, torch.from_numpy(ext),
                                         ds.W, mode).numpy()
             for mode in dk.MODES}
    launches = dk.dynslice.launches
    assert np.array_equal(dk.dynslice(starts, torch.from_numpy(ext), ds.W,
                                      "wrap").numpy(), twins["wrap"])
    assert dk.dynslice.launches == launches  # CPU: the plain twin
    for kern, (label, mode) in zip(
            (ds.kern_roll, ds.kern_roll2d, ds.kern_ds2d), dynslice.LABELS):
        ref = np.asarray(dynslice_body(ds, kern, jnp.asarray(starts.numpy()),
                                       jnp.asarray(ext)))
        vmax = np.abs(ref).max()
        np.testing.assert_allclose(twins[mode], ref, rtol=1e-6,
                                   atol=1e-6 * vmax, err_msg=label)
    if g == 512:  # every window fits: the modes agree
        np.testing.assert_array_equal(twins["wrap"], twins["clamp"])
    else:  # wrapped shifts against the row itself, nch times
        assert np.abs(twins["wrap"] - twins["clamp"]).max() > 1.0
        np.testing.assert_allclose(twins["clamp"], 8 * ds.NCH * ext,
                                   rtol=1e-5)


def test_dynslice_checks_its_inputs():
    starts = dynslice.script_starts("cpu")
    ext = torch.ones(128, 64)
    with pytest.raises(ValueError, match="window"):
        dk.dynslice(starts, ext, 128)
    with pytest.raises(ValueError, match="mode"):
        dk.dynslice(starts, torch.ones(128, 512), 128, "roll")
    with pytest.raises(ValueError, match="int32"):
        dk.dynslice(starts.long(), torch.ones(128, 512), 128)


@pytest.fixture(scope="module")
def zw():
    return load_definitions("prof_zwin_proto", NCOL=SMALL.ncol, S=SMALL.s,
                            SE=SMALL.se, NPC=SMALL.npc)


@pytest.fixture(scope="module")
def zwin_case(zw):
    """The script's kernel on seeded inputs at SMALL: (inputs, outputs)."""
    inputs = zk.zwin_inputs(SMALL, seed=0)
    prd = jnp.asarray(np.array([33.6, 33.6, 33.6], np.float32))
    ref = [torch.from_numpy(np.array(a)) for a in
           zw.run(*(jnp.asarray(a.numpy()) for a in inputs), prd)]
    return inputs, ref


SCALED_RTOL = 2.0 ** -13


def test_zwin_twin_matches_the_script_kernel(zw, zwin_case):
    assert (zw.G, zw.WS, zw.WN, zw.NLANE) == (SMALL.g, SMALL.ws, SMALL.wn,
                                              SMALL.nlane)
    assert (zw.CUTSQ, zw.LJ1, zw.LJ2) == (zk.CUTSQ, zk.LJ1, zk.LJ2)
    inputs, ref = zwin_case
    launches = zk.zwin_proto.launches
    got = zk.zwin_proto(*inputs, shape=SMALL)
    assert zk.zwin_proto.launches == launches  # CPU: the plain twin
    assert [a.shape for a in got] == [a.shape for a in ref]
    for name, a, b in zip(("fTx", "fTy", "fTz", "fLx", "fLy", "fLz"), got,
                          ref):
        vmax = b.abs().max().item()
        assert vmax > 0.1, name  # pairs inside the cutoff: live sums
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4 * vmax, err_msg=name)
    scale = zk.zwin_reference(*inputs, shape=SMALL, magnitude=True)
    assert zk.max_scaled_error(got, ref, scale) <= SCALED_RTOL
    # the scale bounds each element
    assert all(bool((b.abs() <= s * (1 + 1e-6)).all())
               for b, s in zip(ref, scale))


@pytest.mark.parametrize("fault", ["start + 1", "neighbour -11"])
def test_zwin_scaled_check_catches_a_planted_fault(zwin_case, fault):
    """The twin with one window start moved by one, or with the column
    -12 read as -11, against the script's kernel: the per-element check
    fails."""
    inputs, ref = zwin_case
    if fault == "start + 1":
        bad = zk.zwin_reference(*inputs[:-1], inputs[-1] + 1, shape=SMALL)
    else:
        bad = zk.zwin_reference(*inputs, shape=dataclasses.replace(
            SMALL, offsets=(1, -1, 12, -11)))
    scale = zk.zwin_reference(*inputs, shape=SMALL, magnitude=True)
    assert zk.max_scaled_error(bad, ref, scale) > 0.1


def test_entry_points_print_every_label(capsys):
    res = dynslice.main(device="cpu", k1=1, k2=2)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu")
    for label, _ in dynslice.LABELS:
        assert sum(ln.startswith(f"{label}: ") and "ns per window" in ln
                   for ln in lines) == 2, label
    assert sum(ln.startswith("as run") for ln in lines) == 1
    assert len(res) == 6
    res = zwin_proto.main(cells=6, device="cpu", k1=1, k2=2)
    out = capsys.readouterr().out
    assert "zwin proto kernel: " in out and "vs lj_cell_force" in out
    assert "0.327" not in out and "atom-steps" not in out
    assert set(res) == {"zwin proto kernel", "lj_cell_force"}


# P12 as the kernel's two gathers (`zwin_gathers`, a test aid that stays
# off the card path), at the small shape, at NCOL 2 (the +1 and -1 windows
# read one column, +-12 the column itself) and NCOL 12 (+-12 the column
# itself): each w stays its own term
GATHER_SHAPES = {"small": SMALL,
                 "ncol 2": zk.ZwinShape(ncol=2, s=64),
                 "ncol 12": zk.ZwinShape(ncol=12, s=64)}


def _fpair(d):
    """The twin's pair math on displacements d [3, ...]: r2 rounded as the
    kernel rounds it, fpair within the cutoff (exact reciprocal, one
    Newton step), 0 outside."""
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    valid = r2 < zk.CUTSQ
    y = 1.0 / torch.where(valid, r2, 1.0)
    r2i = y * (2.0 - r2 * y)
    r6 = r2i * r2i * r2i
    return torch.where(valid, r6 * (zk.LJ1 * r6 - zk.LJ2) * r2i, 0.0)


def zwin_gathers(ex, ey, ez, xT, yT, zT, starts, shape):
    """P12 as the kernel's two gathers, each output computed once from the
    pairs that reach it; returns (fTx, fTy, fTz, fLx, fLy, fLz)."""
    own8, npc, se = zk.OWN, shape.npc, shape.se
    ncol = shape.ncol
    e = torch.stack([ex, ey, ez])             # [3, NCOL, SE]
    o = torch.stack([xT, yT, zT])             # [3, S, NCOL]
    st0 = starts[:, 0, :].long()              # [NCOL, 4]
    col = torch.arange(ncol)
    # forward: own atom r = 8k + i of column c over its lanes
    r = torch.arange(shape.s)
    k, i = r // own8, r % own8
    lane = torch.arange(shape.ws)
    pos = shape.g + own8 * k[:, None] + lane                    # [S, WS]
    cand = e[:, col[None, :, None], pos[:, None, :]]       # [3, S, NCOL, WS]
    d = o[..., None] - cand
    fp = _fpair(d) * (lane[None, :] > i[:, None])[:, None, :]
    fT = (d * fp).sum(-1)
    m = torch.arange(shape.wn)
    for w, off in enumerate(shape.offsets):
        nb = torch.remainder(col + off, ncol)                   # [NCOL]
        pos = st0[None, :, w, None] + k[:, None, None] + m      # [S, NCOL, WN]
        cand = e[:, nb[None, :, None], pos]
        d = o[..., None] - cand
        fT = fT + (d * _fpair(d)).sum(-1)
    # reactions: element (c, p) over the own atoms whose windows hold it
    p = torch.arange(se)
    kk = torch.arange(npc)
    atoms = o.reshape(3, npc, own8, ncol)                   # [3, NPC, 8, NCOL]
    cand = e[..., None, None]                           # [3, NCOL, SE, 1, 1]
    l = p[:, None] - shape.g - own8 * kk[None, :]                # [SE, NPC]
    take = ((l[..., None] > torch.arange(own8)) & (l < shape.ws)[..., None])
    d = atoms.permute(0, 3, 1, 2)[:, :, None] - cand  # [3, NCOL, SE, NPC, 8]
    fL = -(d * _fpair(d) * take).sum((-1, -2))
    for w, off in enumerate(shape.offsets):
        src = torch.remainder(col - off, ncol)
        st = st0[src, w]                                        # [NCOL]
        m = p[None, :, None] - st[:, None, None] - kk  # [NCOL, SE, NPC]
        take = ((m >= 0) & (m < shape.wn))[..., None]
        d = atoms[:, :, :, src].permute(0, 3, 1, 2)[:, :, None] - cand
        fL = fL - (d * _fpair(d) * take).sum((-1, -2))
    return (*fT, *fL)


@pytest.fixture(scope="module", params=sorted(GATHER_SHAPES))
def gathers_case(request):
    """(shape, inputs, the script's kernel's outputs, the twin's scale)."""
    shape = GATHER_SHAPES[request.param]
    zw = load_definitions("prof_zwin_proto", NCOL=shape.ncol, S=shape.s,
                          SE=shape.se, NPC=shape.npc)
    inputs = zk.zwin_inputs(shape, seed=0)
    prd = jnp.asarray(np.array([33.6, 33.6, 33.6], np.float32))
    ref = [torch.from_numpy(np.array(a)) for a in
           zw.run(*(jnp.asarray(a.numpy()) for a in inputs), prd)]
    scale = zk.zwin_reference(*inputs, shape=shape, magnitude=True)
    return shape, inputs, ref, scale


def test_zwin_gathers_match_the_twin_and_the_script_kernel(gathers_case):
    shape, inputs, ref, scale = gathers_case
    got = zwin_gathers(*inputs, shape)
    twin = zk.zwin_reference(*inputs, shape=shape)
    assert [a.shape for a in got] == [a.shape for a in ref]
    assert all(a.abs().max().item() > 0.1 for a in ref)  # live sums
    assert zk.max_scaled_error(got, twin, scale) <= SCALED_RTOL
    assert zk.max_scaled_error(got, ref, scale) <= SCALED_RTOL
    # every position of fL that no window covers is 0 in all three
    for a, b in zip(got[3:], ref[3:]):
        assert torch.equal(a == 0, b == 0)


def test_zwin_gathers_keep_coinciding_sources_apart(gathers_case):
    """At NCOL 2 the +1 and -1 windows read one column and +-12 the column
    itself, at NCOL 12 +-12 the column itself: the match above held each w
    as its own term there. The starts moved by one fail the scaled
    check."""
    shape, inputs, ref, scale = gathers_case
    nsrc = {len({(c - off) % shape.ncol for off in shape.offsets})
            for c in range(shape.ncol)}
    assert nsrc == {2: {2}, 12: {3}, 26: {4}}[shape.ncol]
    moved = zwin_gathers(*inputs[:-1], inputs[-1] + 1, shape)
    assert zk.max_scaled_error(moved, ref, scale) > 0.1
