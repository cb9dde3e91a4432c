"""PyTorch port, P2, P5, P8 and P11: the plain twins of the Newton-half
column passes (prof/column_half_kernels) against the scripts' Pallas bodies
in interpret mode on the CPU, the four entry points, and the passes'
launch surface: the z chunks each pass is compiled for
(column_half_kernels.ZB), the bytes each pass's bound counts and the names
its build log's registers are reported under.

The bodies of benchmarks/prof/prof_kernel_iso.py (`build`),
prof_halfv2.py (`make_v2`) and prof_kernel_writeonce.py (`_wo_kernel`)
are loaded from the files (their `main` is guarded, so nothing runs at
import), with `pl.pallas_call` given `interpret=True` where the script's
call has no such flag. The P11 bodies are nested in
prof_zchunk.py's `main` (which builds a 32k-atom simulation), so they are
copied below.

Inputs: the JAX sorted state of the 864-atom melt after setup() (grid
(3, 3, 3) x cc 32, cap 864), positions jittered by a seeded +-0.05, six
rows made padding (id -1 at the distinct PAD_POS sentinels), float ids
`where(valid, row, -1)`, idcap = cap, in the column layout. Tolerances:
f64 rtol 1e-10 with atol 1e-10*max|f| (the sums run in another order).
The approximate-reciprocal bodies run in f32 (their reciprocal does not
lower in f64): interpret mode takes the approximate reciprocal in bfloat16
(about 2^-8 relative) and one Newton step squares that to about 2^-16,
which the r^-14 and r^-8 terms raise by up to 14x; held at rtol 1e-4 with
atol 1e-4*max|f| against the twin, whose reciprocal is exact before its
Newton step.
"""

import functools
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lammps_kokkos_port_tpu.ops import pallas_pair as pp
from lammps_kokkos_port_tpu.presets import lj_melt_sim as jax_lj_melt_sim
from lammps_kokkos_port_tpu_torch.ops import half_kernels as hk
from lammps_kokkos_port_tpu_torch.ops.pair_kernels import lj_cell_force
from lammps_kokkos_port_tpu_torch.ops.sortedforce import PAD_POS, PAD_STEP
from lammps_kokkos_port_tpu_torch.prof import (
    column_half_kernels as chk,
    halfv2,
    kernel_iso,
    kernel_writeonce,
    zchunk,
)

PROF = Path(__file__).resolve().parents[1] / "benchmarks" / "prof"
EPS_F64 = 1e-10
APPROX_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_script(name):
    """benchmarks/prof/<name>.py as a module, its `pl.pallas_call` in
    interpret mode (a call's own `interpret` flag still wins)."""
    spec = importlib.util.spec_from_file_location(f"_{name}",
                                                  PROF / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    interp = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                      if not k.startswith("__")})
    interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = interp
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {name: load_script(name) for name in
            ("prof_kernel_iso", "prof_halfv2", "prof_kernel_writeonce")}


@pytest.fixture(scope="module")
def g():
    """Column channels (numpy, f64), ids, key, grid."""
    sim = jax_lj_melt_sim(cells=6, t_init=1.44, dtype=jnp.float64, every=20,
                          delay=0, check=False)
    sim.setup()
    st, p = sim.state, sim.nl.params
    valid = np.asarray(st.valid_mask)
    x = np.array(st.x)
    rng = np.random.default_rng(11)
    x[valid] += rng.uniform(-0.05, 0.05, (int(valid.sum()), 3))
    cap = st.capacity
    ids = np.where(valid, np.arange(cap), -1).astype(np.float64)
    pads = np.random.default_rng(5).choice(cap, 6, replace=False)
    x[pads] = (PAD_POS + pads * PAD_STEP)[:, None]
    ids[pads] = -1.0
    nx, ny, nz = p.ncells
    cc = p.cell_cap
    col = (nx * ny, nz, cc)
    return dict(key=sim.pair_style.kernel_key(), ncells=tuple(p.ncells),
                cc=cc, cap=cap, prd=np.array(st.box.prd), pads=pads,
                ids=ids, col=[np.ascontiguousarray(x[:, d].reshape(col))
                              for d in range(3)] + [ids.reshape(col)])


def _jax(g, dtype=np.float64):
    return ([jnp.asarray(a.astype(dtype)) for a in g["col"]],
            jnp.asarray(g["prd"].astype(dtype)))


def _args(g, dtype=torch.float64):
    """(key, ncells, idcap, gx, gy, gz, gi, prd) of the wrappers."""
    return (g["key"], g["ncells"], g["cap"],
            *(torch.from_numpy(a).to(dtype) for a in g["col"]),
            torch.from_numpy(g["prd"]).to(dtype))


def _assert_close(got, ref, rtol=EPS_F64):
    fmax = max(np.abs(np.asarray(a)).max() for a in ref)
    assert fmax > 1.0  # jittered: the forces are real
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=rtol * fmax)


def _twin_and_wrapper(name, args, **kw):
    """The twin's result; the CPU wrapper gives the same and launches
    nothing."""
    got = chk.reference(name, *args, **kw)
    fn = chk.PASSES[name]
    launches = fn.launches
    assert all(torch.equal(a, b) or (a.isnan().all() and b.isnan().all())
               for a, b in zip(fn(*args, **kw), got))
    assert fn.launches == launches
    return got


@pytest.mark.parametrize("mode", kernel_iso.MODES)
def test_iso_twins_match_the_script_body(g, scripts, mode):
    (gx, gy, gz, gi), prd = _jax(g)
    nx, ny, nz = g["ncells"]
    _, call = scripts["prof_kernel_iso"].build(
        mode, g["key"], g["ncells"], g["cap"], gi, prd, nx * ny, nz, g["cc"],
        jnp.float64)
    ref = [np.asarray(a) for a in call(gx, gy, gz)]
    got = _twin_and_wrapper(f"iso_{mode}", _args(g))
    if mode == "noassembly":
        # unstaged scratch reads NaN in interpret mode: every output is NaN
        assert all(np.isnan(a).all() for a in ref)
        assert all(a.isnan().all() for a in got)
    else:
        _assert_close(got, ref)


def wo_outputs(wo, key, ncells, idcap, gx, gy, gz, gi, prd):
    """prof_kernel_writeonce.py:113-128 (`wo_half_force` up to its fold),
    interpret=True: the kernel's forward sums and rc."""
    nx, ny, nz = ncells
    nxy, _, cc = gx.shape
    dt = gx.dtype
    kern = functools.partial(wo._wo_kernel, key, nx, ny, nz, cc, idcap)
    full = pl.BlockSpec(memory_space=pltpu.VMEM)
    out_shape = [jax.ShapeDtypeStruct((nxy, nz, cc), dt) for _ in range(3)]
    out_shape.append(
        jax.ShapeDtypeStruct((nxy, 3, nz, len(wo._TARGETS) * cc), dt))
    return pl.pallas_call(
        kern, grid=(nxy,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] + [full] * 4,
        out_specs=[full] * 4, out_shape=out_shape,
        scratch_shapes=[pltpu.VMEM((4, nz, len(pp._HALF) * cc), dt)],
        interpret=True,
    )(prd, gx, gy, gz, gi)


def test_writeonce_twin_matches_the_script_body(g, scripts):
    wo = scripts["prof_kernel_writeonce"]
    assert wo._TARGETS == hk.TARGETS
    (gx, gy, gz, gi), prd = _jax(g)
    ref = [np.asarray(a) for a in wo_outputs(
        wo, g["key"], g["ncells"], g["cap"], gx, gy, gz, gi, prd)]
    args = _args(g)
    *f, rc = _twin_and_wrapper("writeonce", args)
    assert tuple(rc.shape) == ref[3].shape
    _assert_close(f, ref[:3])  # the forward sums
    _assert_close([rc], [ref[3]])  # the target blocks
    # the script's fold (:130-138) of its own outputs
    f = list(ref[:3])
    rc5 = ref[3].reshape(*g["ncells"][:2], 3, g["ncells"][2], 5, g["cc"])
    for t, (dx, dy) in enumerate(wo._TARGETS):
        blk = np.roll(rc5[:, :, :, :, t, :], (dx, dy), axis=(0, 1))
        for ci in range(3):
            f[ci] = f[ci] + blk[:, :, ci].reshape(f[ci].shape)
    _assert_close(chk.wo_half_force(*args), f)


@pytest.mark.parametrize("zb", [2, 4])
def test_halfv2_twin_matches_the_script_body(g, scripts, zb):
    (gx, gy, gz, _), prd = _jax(g)
    v2 = scripts["prof_halfv2"].make_v2(g["key"], g["ncells"], zb=zb)
    ref = v2(gx, gy, gz, prd)
    _assert_close(_twin_and_wrapper("halfv2", _args(g), zb=zb), ref)


@pytest.mark.parametrize("zb", [2, 4])
def test_halfv2_approx_twin_matches_the_script_body(g, scripts, zb):
    (gx, gy, gz, _), prd = _jax(g, np.float32)
    v2 = scripts["prof_halfv2"].make_v2(g["key"], g["ncells"], zb=zb,
                                        approx=True)
    ref = v2(gx, gy, gz, prd)
    got = _twin_and_wrapper("halfv2_approx", _args(g, torch.float32), zb=zb)
    _assert_close(got, ref, APPROX_RTOL)


def zchunk_calls_of(key, ncells, cap, cc, dt, prd, gi):
    """benchmarks/prof/prof_zchunk.py:58-168 (`make`, `asm`, `fwd_kern`,
    `fused_kern`), with main's variables as arguments and interpret=True;
    returns {"fwd": call(zb), "fused": call(zb)}, call(zb)(gx, gy, gz)."""
    nx, ny, nz = ncells
    nxy = nx * ny
    NB = len(pp._HALF)
    NJ = NB * cc
    cutsq = key[-1]
    _, lj1, lj2, _ = key
    full = pl.BlockSpec(memory_space=pltpu.VMEM)
    out_shape = [jax.ShapeDtypeStruct((nxy, nz, cc), dt) for _ in range(3)]

    def make(kern, scratch=True):
        def call(cgx, cgy, cgz):
            return pl.pallas_call(
                kern,
                grid=(nxy,),
                in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] + [full] * 4,
                out_specs=[full] * 3,
                out_shape=out_shape,
                scratch_shapes=(
                    [pltpu.VMEM((4, nz, NJ), dt)] if scratch else []),
                interpret=True,
            )(prd, cgx, cgy, cgz, gi)
        return call

    def asm(pid, prd_ref, gx, gy, gz, gi, cand_scratch, bias_ids):
        """Shared candidate assembly (same as the shipped half kernel)."""
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
                if ci == 3 and s_ > 0 and bias_ids:
                    col = jnp.where(col >= 0.0, col + float(cap), -1.0)
                blk = pltpu.roll(col, (-dz) % nz, axis=0) if dz else col
                if ci == 2 and dz != 0:
                    seam = (zrow == (nz - 1 if dz > 0 else 0))
                    blk = blk + jnp.where(
                        seam, jnp.float32(dz) * prd_ref[2], 0.0
                    ).astype(blk.dtype)
                cand_scratch[ci, :, s_ * cc:(s_ + 1) * cc] = blk
        return ncols

    # ---- forward-only, z-chunked, WITH id compare (Newton-half valid) ----
    def fwd_kern(zb, prd_ref, gx, gy, gz, gi, fx, fy, fz, cand_scratch):
        pid = pl.program_id(0)
        asm(pid, prd_ref, gx, gy, gz, gi, cand_scratch, True)
        for z0 in range(0, nz, zb):
            own_x = gx[pid, z0:z0 + zb][:, :, None]
            own_y = gy[pid, z0:z0 + zb][:, :, None]
            own_z = gz[pid, z0:z0 + zb][:, :, None]
            own_i = gi[pid, z0:z0 + zb][:, :, None]
            dxv = own_x - cand_scratch[0, z0:z0 + zb][:, None, :]
            dyv = own_y - cand_scratch[1, z0:z0 + zb][:, None, :]
            dzv = own_z - cand_scratch[2, z0:z0 + zb][:, None, :]
            r2 = dxv * dxv + dyv * dyv + dzv * dzv
            ic = cand_scratch[3, z0:z0 + zb]
            valid = jnp.logical_and(own_i < ic[:, None, :], r2 < cutsq)
            r2s = jnp.where(valid, r2, 1.0)
            r2i = 1.0 / r2s
            r6 = r2i * r2i * r2i
            fpair = jnp.where(valid, r6 * (lj1 * r6 - lj2) * r2i, 0.0)
            fx[pid, z0:z0 + zb] = jnp.sum(dxv * fpair, axis=-1)
            fy[pid, z0:z0 + zb] = jnp.sum(dyv * fpair, axis=-1)
            fz[pid, z0:z0 + zb] = jnp.sum(dzv * fpair, axis=-1)

    # ---- op-fused: no ids at all (r2>0 kills self), arcp recip,
    #      single select ----
    def fused_kern(zb, prd_ref, gx, gy, gz, gi, fx, fy, fz, cand_scratch):
        pid = pl.program_id(0)
        asm(pid, prd_ref, gx, gy, gz, gi, cand_scratch, False)
        for z0 in range(0, nz, zb):
            own_x = gx[pid, z0:z0 + zb][:, :, None]
            own_y = gy[pid, z0:z0 + zb][:, :, None]
            own_z = gz[pid, z0:z0 + zb][:, :, None]
            dxv = own_x - cand_scratch[0, z0:z0 + zb][:, None, :]
            dyv = own_y - cand_scratch[1, z0:z0 + zb][:, None, :]
            dzv = own_z - cand_scratch[2, z0:z0 + zb][:, None, :]
            r2 = dxv * dxv + dyv * dyv + dzv * dzv
            valid = jnp.logical_and(r2 < cutsq, r2 > 0.0)
            r2s = jnp.maximum(r2, 0.25)
            y = pl.reciprocal(r2s, approx=True)
            r2i = y * (2.0 - r2s * y)
            r6 = r2i * r2i * r2i
            fpair = jnp.where(valid, r6 * (lj1 * r6 - lj2) * r2i, 0.0)
            fx[pid, z0:z0 + zb] = jnp.sum(dxv * fpair, axis=-1)
            fy[pid, z0:z0 + zb] = jnp.sum(dyv * fpair, axis=-1)
            fz[pid, z0:z0 + zb] = jnp.sum(dzv * fpair, axis=-1)

    return {"fwd": lambda zb: make(functools.partial(fwd_kern, zb)),
            "fused": lambda zb: make(functools.partial(fused_kern, zb))}


@pytest.mark.parametrize("name,zb", [("fwd", 2), ("fused", 3)])
def test_zchunk_twins_match_the_script_bodies(g, name, zb):
    np_dt = np.float64 if name == "fwd" else np.float32
    (gx, gy, gz, gi), prd = _jax(g, np_dt)
    calls = zchunk_calls_of(g["key"], g["ncells"], g["cap"], g["cc"],
                            jnp.dtype(np_dt), prd, gi)
    ref = calls[name](zb)(gx, gy, gz)
    dtype = torch.float64 if name == "fwd" else torch.float32
    got = _twin_and_wrapper(f"zchunk_{name}", _args(g, dtype), zb=zb)
    _assert_close(got, ref, EPS_F64 if name == "fwd" else APPROX_RTOL)


def test_equivalences(g):
    """P5 noreverse = P10 = P11 fwd; P5 full = K8; P2 = P8 folded = K1
    (column_half_force_pallas in interpret mode) = the full stencil."""
    args = _args(g)
    key, ncells, cap = args[:3]
    nx, ny, nz = ncells
    plane = [a.reshape(nx, ny, nz, -1) for a in args[3:7]]
    fwd = chk.reference("iso_noreverse", *args)
    p10 = hk.lj_plane_half_fwd_reference(key, ncells, cap, *plane, args[-1])
    assert all(torch.equal(a, b.reshape(a.shape)) for a, b in zip(fwd, p10))
    assert all(torch.equal(a, b) for a, b in
               zip(fwd, chk.reference("zchunk_fwd", *args, zb=1)))
    full = chk.reference("iso_full", *args)
    k8 = hk.lj_plane_half_force_reference(key, ncells, cap, *plane, args[-1])
    assert all(torch.equal(a, b.reshape(a.shape)) for a, b in zip(full, k8))

    v2 = chk.reference("halfv2", *args)
    (gx, gy, gz, gi), prd = _jax(g)
    k1 = pp.column_half_force_pallas(key, ncells, cap, gx, gy, gz, gi, prd)
    _assert_close(v2, k1)
    _assert_close(chk.wo_half_force(*args), v2)
    _assert_close(chk.reference("iso_batched", *args), full)
    f27 = lj_cell_force(key, ncells, *(a.reshape(-1, g["cc"])
                                       for a in args[3:6]), args[-1])
    real = g["ids"] >= 0
    for d in range(3):
        flat = v2[d].reshape(-1).numpy()
        np.testing.assert_allclose(flat[real], f27[d].reshape(-1)[real],
                                   rtol=EPS_F64, atol=EPS_F64)
        np.testing.assert_array_equal(flat[g["pads"]], 0.0)


def test_inputs_are_validated(g):
    args = _args(g)
    # a z chunk no kernel instance is compiled for, on the CPU as well
    for name, zb in (("halfv2", 0), ("halfv2", 1), ("zchunk_fwd", 5),
                     ("iso_full", 2)):
        with pytest.raises(ValueError, match="is not compiled"):
            chk.PASSES[name](*args, zb=zb)
    with pytest.raises(ValueError, match="exceed"):
        chk.writeonce(*args[:2], 2 ** 53, *args[3:])
    with pytest.raises(ValueError, match="column channels"):
        chk.iso_full(*args[:3], *(a.reshape(9, -1) for a in args[3:7]),
                     args[-1])
    small = [torch.zeros(3, 1, 4, dtype=torch.float64)] * 4
    with pytest.raises(ValueError, match="nz >= 3"):
        chk.iso_redonly(args[0], (1, 3, 1), 12, *small, args[-1])


LABELS = {
    kernel_iso: ["full        :", "batched     :", "redonly     :",
                 "noreverse   :", "noassembly  :"],
    kernel_writeonce: ["parity fx:", "parity fy:", "parity fz:",
                       "V0 shipped half :", "W  write-once   :"],
    halfv2: ["v2 zb=2 approx=False: max abs err",
             "v2 zb=2 approx=True: max abs err", "V0 half        :",
             "v2 zb=2 approx=False: ", "v2 zb=2 approx=True: ",
             "v2 zb=4 approx=False: ", "v2 zb=4 approx=True: "],
    zchunk: ["fwd zb= 3        :", "fwd zb= 4        :",
             "fwd zb= 2        :", "fwd zb= 1        :",
             "fused zb= 3      :", "fused zb= 2      :",
             "fused zb= 1      :"],
}


def test_entry_points_print_every_label(capsys):
    res = {}
    for mod, labels in LABELS.items():
        res[mod] = mod.main(cells=6, device="cpu", k1=1, k2=2, reps=1)
        lines = capsys.readouterr().out.splitlines()
        assert lines[0].startswith("device: cpu")
        for label in labels:
            assert any(ln.startswith(label) for ln in lines), label
        assert all(np.isfinite(v) for v in res[mod].values())
    # the same forces, summed in other orders: the melt's lattice forces
    # cancel to f32 rounding
    assert res[kernel_iso]["parity vs full"] < 1e-4
    assert max(res[kernel_writeonce][f"parity f{n}"] for n in "xyz") < 1e-4
    assert res[halfv2]["v2 zb=2 approx=True err"] < 1e-4


# the passes whose mask reads no ids
ID_FREE = {"halfv2", "halfv2_approx", "zchunk_fused"}


@pytest.mark.parametrize("name", sorted(chk.SPECS))
def test_z_chunks_are_validated(name):
    """None is the default block of four cells; every compiled chunk is
    taken as given; any other raises, on the CPU as on the card."""
    assert chk.cells_per_block(name) == chk.DEFAULT_ZB == 4
    for zb in chk.ZB[name]:
        assert chk.cells_per_block(name, zb) == zb
    for zb in (0, 5, 13):
        with pytest.raises(ValueError, match="is not compiled"):
            chk.cells_per_block(name, zb)


def test_z_chunks_are_the_entry_points():
    """prof.halfv2 asks for 2 and 4; prof.zchunk for nz (12 at the 20-cell
    melt, 3 at the 6-cell one), 4, 2 and 1; no other pass takes one."""
    assert chk.ZB["halfv2"] == chk.ZB["halfv2_approx"] == (2, 4)
    for name in ("zchunk_fwd", "zchunk_fused"):
        assert set(chk.ZB[name]) == {1, 2, 3, 4, 12}
    assert all(chk.ZB[n] == (4,) for n in chk.SPECS
               if not n.startswith(("halfv2", "zchunk")))


@pytest.mark.parametrize("name", sorted(chk.SPECS))
def test_bound_counts_inputs_and_outputs_only(name):
    """Each pass's bound moves its input planes once (x, y, z and, where
    its mask reads them, the ids) and its outputs once (three force
    planes; P8's rc, 15 more): at the 32k grid, (12, 12, 12) x cc 32 in
    f32, 7 planes take 0.000462 ms at 3.35 TB/s."""
    planes = chk.bound_planes(name)
    want = (6 if name in ID_FREE else 7) + (15 if name == "writeonce" else 0)
    assert planes == want
    rows = 12 ** 3 * 32
    ms = rows * planes * 4 / 3.35e12 * 1e3
    expected = {6: 0.000396, 7: 0.000462, 22: 0.001453}[planes]
    assert round(ms, 6) == expected


def test_instance_registers_name_each_kernel():
    """The build log's registers, in order, under each instance's
    template arguments (in the form cu++filt prints them) or its raw
    name."""
    log = "\n".join([
        "ptxas info    : Compiling entry function 'void <unnamed>::"
        "column_half_kernel<float, (<unnamed>::Mask)2, (bool)1, (<unnamed>"
        "::Land)3, (int)12>(<unnamed>::Args<T1>)' for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "ptxas info    : Used 64 registers, 384 bytes cmem[0]",
        "ptxas info    : Compiling entry function 'void <unnamed>::"
        "column_half_kernel<double, (<unnamed>::Mask)4, (bool)0, (<unnamed>"
        "::Land)1, (int)4>(<unnamed>::Args<T1>)' for 'sm_90a'",
        "ptxas info    : Used 56 registers, 384 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Zfold' for 'sm_90a'",
        "ptxas info    : Used 20 registers, 380 bytes cmem[0]"])
    assert chk.instance_registers(log) == [
        ("f32 slot approx target zb=12", 64),
        ("f64 unstaged row zb=4", 56), ("_Zfold", 20)]
