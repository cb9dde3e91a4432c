"""PyTorch port, the profiling entry points (`prof/`) on the CPU.

- P9: the plain twins of the three ablation kernels against a copy of the
  bodies of benchmarks/prof/prof_sorted_ablate.py (:96-183, below with
  `interpret=True` added; the script builds a 32k-atom simulation when it
  is imported, so it cannot be imported here). The inputs are made so that
  the pair math is live: positions within 0.8-1.2 of the constant
  candidate 3.0 in each axis, ids in [-1, 4]. f64 (the approximate
  variant in f32, whose twin is the exact one): rtol 1e-10 / 1e-4 with
  atol scaled by max|f|, and 5e-2 against the approximate body (see its
  case); asm_only exactly.
- `grid.sorted_planes` builds the scripts' inputs (ids, column and plane
  layouts) from the port's sorted state as the scripts build them from
  the JAX state.
- `timing.slope_ms` runs the iterations it promises.
- `sorted_ablate.main` and `plane_half.main` run end to end at cells 6 on
  the CPU and print every label of their scripts.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lammps_kokkos_port_tpu.ops import pallas_pair as pp
from lammps_kokkos_port_tpu.presets import lj_melt_sim as jax_lj_melt_sim
from lammps_kokkos_port_tpu_torch.presets import lj_melt_sim
from lammps_kokkos_port_tpu_torch.prof import (
    ablate_kernels,
    plane_half,
    sorted_ablate,
    timing,
)
from lammps_kokkos_port_tpu_torch.prof.grid import sorted_planes

KEY = ("lj", 48.0, 24.0, 6.25)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_calls_of(key, nx, ny, nz, cc, dt, prd, gi):
    """benchmarks/prof/prof_sorted_ablate.py:91-183 (the variant kernels
    and make_call), with the script's closure variables as arguments and
    interpret=True; returns each variant's `call` (the script wraps it in
    a scan body)."""
    nxy = nx * ny
    NB = len(pp._HALF)
    full = pl.BlockSpec(memory_space=pltpu.VMEM)
    out_shape = [jax.ShapeDtypeStruct((nxy, nz, cc), dt) for _ in range(3)]

    def asm_only_kernel(prd_ref, gx, gy, gz, gi, fx, fy, fz, cand_scratch):
        pid = pl.program_id(0)
        nxi, nyi = jnp.int32(nx), jnp.int32(ny)
        cx = pid // nyi
        cy = pid - cx * nyi
        zrow = jax.lax.broadcasted_iota(jnp.int32, (nz, 1), 0)
        cols = sorted({(dx, dy) for dx, dy, _ in pp._HALF})
        ncols = {}
        for dx, dy in cols:
            wx = cx + jnp.int32(dx)
            wy = cy + jnp.int32(dy)
            ncx = jax.lax.rem(wx + nxi, nxi)
            ncy = jax.lax.rem(wy + nyi, nyi)
            sx = jnp.where(wx < 0, -prd_ref[0],
                           jnp.where(wx >= nxi, prd_ref[0], 0.0))
            sy = jnp.where(wy < 0, -prd_ref[1],
                           jnp.where(wy >= nyi, prd_ref[1], 0.0))
            ncols[(dx, dy)] = (ncx * nyi + ncy, sx, sy)
        for s_, (dx, dy, dz) in enumerate(pp._HALF):
            ncol, sx, sy = ncols[(dx, dy)]
            for ci, (ref, sh) in enumerate(((gx, sx), (gy, sy), (gz, None),
                                            (gi, None))):
                col = ref[ncol]
                if sh is not None:
                    col = col + sh
                blk = pltpu.roll(col, (-dz) % nz, axis=0) if dz else col
                if ci == 2 and dz != 0:
                    seam = (zrow == (nz - 1 if dz > 0 else 0))
                    blk = blk + jnp.where(
                        seam, jnp.float32(dz) * prd_ref[2], 0.0
                    ).astype(blk.dtype)
                cand_scratch[ci, :, s_ * cc:(s_ + 1) * cc] = blk
        fx[pid] = cand_scratch[0, :, :cc] + cand_scratch[1, :, :cc]
        fy[pid] = cand_scratch[2, :, :cc]
        fz[pid] = cand_scratch[3, :, :cc]

    def pair_only_kernel(approx, prd_ref, gx, gy, gz, gi,
                         fx, fy, fz, cand_scratch):
        pid = pl.program_id(0)
        cutsq = key[-1]
        _, lj1, lj2, _ = key

        @pl.when(pid == 0)
        def _():
            cand_scratch[...] = jnp.zeros_like(cand_scratch) + 3.0

        own_x = gx[pid][:, :, None]
        own_y = gy[pid][:, :, None]
        own_z = gz[pid][:, :, None]
        own_i = gi[pid][:, :, None]
        dxv = own_x - cand_scratch[0][:, None, :]
        dyv = own_y - cand_scratch[1][:, None, :]
        dzv = own_z - cand_scratch[2][:, None, :]
        r2 = dxv * dxv + dyv * dyv + dzv * dzv
        ic = cand_scratch[3]
        valid = jnp.logical_and(
            jnp.logical_and(own_i < ic[:, None, :], own_i >= 0.0),
            r2 < cutsq,
        )
        r2s = jnp.where(valid, r2, 1.0)
        if approx:
            r2inv = pl.reciprocal(r2s, approx=True)
        else:
            r2inv = 1.0 / r2s
        r6inv = r2inv * r2inv * r2inv
        fpair = jnp.where(valid, r6inv * (lj1 * r6inv - lj2) * r2inv, 0.0)
        fij_x = dxv * fpair
        fij_y = dyv * fpair
        fij_z = dzv * fpair
        fx[pid] = jnp.sum(fij_x, axis=-1)
        fy[pid] = jnp.sum(fij_y, axis=-1)
        fz[pid] = jnp.sum(fij_z, axis=-1)

    def make_call(kern, scratch_lanes):
        def call(cgx, cgy, cgz):
            return pl.pallas_call(
                kern,
                grid=(nxy,),
                in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] + [full] * 4,
                out_specs=[full] * 3,
                out_shape=out_shape,
                scratch_shapes=[pltpu.VMEM((4, nz, scratch_lanes), dt)],
                interpret=True,
            )(prd, cgx, cgy, cgz, gi)
        return call

    return {
        "asm_only": make_call(asm_only_kernel, NB * cc),
        "pair_only": make_call(functools.partial(pair_only_kernel, False),
                               NB * cc),
        "pair_only_approx": make_call(
            functools.partial(pair_only_kernel, True), NB * cc),
    }


def _live_inputs(np_dtype, ncells=(3, 3, 3), cc=8, seed=4):
    """Column channels whose pair math is live against the constant 3.0:
    each axis 3 +- [0.8, 1.2], ids in [-1, 4], and a box of 7 per side."""
    nx, ny, nz = ncells
    rng = np.random.default_rng(seed)
    shape = (nx * ny, nz, cc)
    x = [(3.0 + rng.choice([-1, 1], shape) * rng.uniform(0.8, 1.2, shape))
         .astype(np_dtype) for _ in range(3)]
    gi = rng.integers(-1, 5, shape).astype(np_dtype)
    prd = np.full(3, 7.0, dtype=np_dtype)
    return x, gi, prd


@pytest.mark.parametrize("name,body,np_dtype,rtol", [
    ("asm_only", "asm_only", np.float64, 0.0),
    ("pair_only", "pair_only", np.float64, 1e-10),
    # the twin of the approximate variant is the exact math: against the
    # exact body f32 rounding of the sums sets the tolerance; against the
    # approximate body, interpret mode takes the reciprocal in bfloat16
    # (jax's pallas reciprocal lowering), about 2^-8 relative, which the
    # r^-14 and r^-8 terms raise to a few percent
    ("pair_only_approx", "pair_only", np.float32, 1e-4),
    ("pair_only_approx", "pair_only_approx", np.float32, 5e-2),
])
def test_ablation_twins_match_the_script_bodies(name, body, np_dtype, rtol):
    ncells = (3, 3, 3)
    x, gi, prd = _live_inputs(np_dtype, ncells)
    calls = make_calls_of(KEY, *ncells, 8, jnp.dtype(np_dtype),
                          jnp.asarray(prd), jnp.asarray(gi))
    ref = [np.asarray(a) for a in calls[body](*(jnp.asarray(a) for a in x))]
    fn = getattr(ablate_kernels, name)
    args = [torch.from_numpy(a) for a in (*x, gi, prd)]
    launches = fn.launches
    got = [a.numpy() for a in (fn(ncells, *args) if name == "asm_only"
                               else fn(KEY, ncells, *args))]
    assert fn.launches == launches  # CPU: the plain twin
    vmax = max(np.abs(a).max() for a in ref)
    if name != "asm_only":
        assert vmax > 1.0 and np.count_nonzero(ref[0]) > 10  # live math
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * vmax)


def test_approx_takes_float32_only():
    x, gi, prd = _live_inputs(np.float64)
    args = [torch.from_numpy(a) for a in (*x, gi, prd)]
    with pytest.raises(TypeError, match="float32"):
        ablate_kernels.pair_only_approx(KEY, (3, 3, 3), *args)


def test_sorted_planes_are_the_scripts_inputs():
    """The port's sorted state is the JAX state row for row, and the
    planes are what prof_sorted_ablate.py:55-60 / prof_v3_32k.py:27-34
    build from it."""
    ref = jax_lj_melt_sim(cells=6, t_init=1.44, dtype=jnp.float64, every=20,
                          delay=0, check=False)
    ref.setup()
    sim = lj_melt_sim(cells=6, t_init=1.44, dtype=torch.float64, every=20,
                      delay=0, check=False, device="cpu")
    sim.setup()
    sp = sorted_planes(sim)
    p = ref.nl.params
    nx, ny, nz = p.ncells
    cc, cap = p.cell_cap, ref.state.capacity
    st = ref.state
    ids = np.asarray(jnp.where(st.valid_mask, jnp.arange(cap, dtype=jnp.int32),
                               -1).astype(st.dtype))
    g = np.asarray(st.x).reshape(nx * ny, nz, cc, 3)
    g5 = np.asarray(st.x).reshape(nx, ny, nz, cc, 3)
    assert (sp.ncells, sp.cc, sp.cap) == ((nx, ny, nz), cc, cap)
    for d in range(3):
        np.testing.assert_array_equal(sp.col[d].numpy(), g[..., d])
        np.testing.assert_array_equal(sp.plane[d].numpy(), g5[..., d])
    np.testing.assert_array_equal(sp.col[3].numpy(),
                                  ids.reshape(nx * ny, nz, cc))
    np.testing.assert_array_equal(sp.plane[3].numpy(),
                                  ids.reshape(nx, ny, nz, cc))
    np.testing.assert_array_equal(sp.prd.numpy(), np.asarray(st.box.prd))
    assert sp.key == ref.forcefield.pair.kernel_key()


def test_slope_ms_runs_the_iterations():
    calls = []

    def body(c):
        calls.append(1)
        return c + 1

    t = timing.slope_ms(body, torch.zeros(3), k1=2, k2=5, reps=3)
    # one untimed run of k1, then reps pairs of k1 and k2
    assert len(calls) == 2 + 3 * (2 + 5)
    assert np.isfinite(t)


SORTED_ABLATE_LABELS = [
    "natoms=", "step        :", "V0 half     :", "V1 full27   :",
    "V2 asm-only :", "V3 pair-only:", "V4 pair+arcp:", "gather K=96      :",
    "gather K=128      :", "gather K=128 local:",
    "[N,96] XLA full-list force:", "[N,128] XLA full-list force:"]
PLANE_HALF_LABELS = [
    "parity col vs v3:", "column_half 32k:", "plane_half_v3 32k:",
    "v3 shipped     :", "v3 forward-only:"]


def test_entry_points_print_every_label(capsys):
    res = sorted_ablate.main(cells=6, device="cpu", k1=1, k2=2, step_k1=2,
                             step_k2=4)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu")
    for label in SORTED_ABLATE_LABELS:
        assert sum(ln.startswith(label) for ln in lines) == 1, label
    assert len(res) == len(SORTED_ABLATE_LABELS) - 1

    res = plane_half.main(cells=6, device="cpu", k1=1, k2=2, reps=1)
    lines = capsys.readouterr().out.splitlines()
    for label in PLANE_HALF_LABELS:
        assert sum(ln.startswith(label) for ln in lines) == 1, label
    # K8 against the full-stencil kernel on the melt's state, f32
    assert res["parity col vs v3"] < 1e-4


def test_counted_kernels_finds_every_wrapper_once():
    """slope_ms credits graph replays to the counters counted_kernels()
    finds: every loaded wrapper, each once though several modules import
    it."""
    from lammps_kokkos_port_tpu_torch.prof import (  # noqa: F401
        dynslice, kernel_cc32, kernel_v3, zwin_proto)

    fns = timing.counted_kernels()
    assert len(fns) == len({id(f) for f in fns})
    names = {f.__name__ for f in fns}
    assert {"lj_cell_force", "lj_column_force", "lj_plane_half_force",
            "pair_only", "iso_full", "cc32_half", "v3_k1", "v3_k2",
            "dynslice", "zwin_proto"} <= names
