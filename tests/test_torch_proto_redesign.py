"""PyTorch port, the formulations of csrc/zwin_proto.cu (P12) and of P6
k2 on the column walk (csrc/lj_column_full.cu), and prof/proto_redesign's
surface, on the CPU.

- P12 as two gathers (`zwin_gathers` below, a test aid that stays off the
  card path): each forward sum fT*[8k + i, c] over its own atom's lanes,
  and each reaction fL*[c, p] over the own atoms whose windows hold the
  candidate e*[c, p] (the own window of c: chunks k with l = p - G - 8k
  in [0, WS), atoms i < l; for each w the source column c - off_w at its
  row-0 start st: chunks k with p - st - k in [0, WN), all 8 atoms). Held
  against `zwin_reference` and against the script's Pallas kernel in
  interpret mode (loaded as tests/test_torch_dynslice_zwin.py loads it),
  per element to the sum of the magnitudes of its terms within
  SCALED_RTOL, at the small shape (NCOL 26, S 64), at NCOL 2 (the +1 and
  -1 windows read one column, +-12 the column itself) and NCOL 12 (+-12
  the column itself): each w stays its own term. The starts moved by one
  must fail that check.
- P6 k2's twin, `v3_reference(grouped=True)`, against the script's
  `k2_kernel` in interpret mode (the copy in
  tests/test_torch_prof_cc32_v3.py) on the grids the column walk is held
  on beyond the melt: 1, 2 and 3 cells per dim and cc 64 (lattice grids,
  pads interleaved, float ids), f64, rtol 1e-10 with atol 1e-10*max: the
  sums run in another order.
- prof/proto_redesign: its argument checks, the earlier tree's entry
  points it binds (each one this tree's sources still export) and the
  other P12 designs it builds from this tree's source.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_kokkos_port_tpu_torch.ops import cuda_build
from lammps_kokkos_port_tpu_torch.prof import full_redesign as fr
from lammps_kokkos_port_tpu_torch.prof import planted
from lammps_kokkos_port_tpu_torch.prof import proto_redesign as pr
from lammps_kokkos_port_tpu_torch.prof import v3_kernels
from lammps_kokkos_port_tpu_torch.prof import zwin_kernels as zk
from test_torch_dynslice_zwin import SCALED_RTOL, load_definitions
from test_torch_prof_cc32_v3 import v3_calls_of

SHAPES = {"small": zk.ZwinShape(ncol=26, s=64),
          "ncol 2": zk.ZwinShape(ncol=2, s=64),
          "ncol 12": zk.ZwinShape(ncol=12, s=64)}
KEY = ("lj", 48.0, 24.0, 6.25)
EDGE_GRIDS = [((1, 1, 1), 16), ((2, 2, 4), 32), ((3, 3, 3), 32),
              ((3, 3, 4), 64)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture(scope="module", params=sorted(SHAPES))
def zwin_case(request):
    """(shape, inputs, the script's kernel's outputs, the twin's scale)."""
    shape = SHAPES[request.param]
    zw = load_definitions("prof_zwin_proto", NCOL=shape.ncol, S=shape.s,
                          SE=shape.se, NPC=shape.npc)
    inputs = zk.zwin_inputs(shape, seed=0)
    prd = jnp.asarray(np.array([33.6, 33.6, 33.6], np.float32))
    ref = [torch.from_numpy(np.array(a)) for a in
           zw.run(*(jnp.asarray(a.numpy()) for a in inputs), prd)]
    scale = zk.zwin_reference(*inputs, shape=shape, magnitude=True)
    return shape, inputs, ref, scale


def test_zwin_gathers_match_the_twin_and_the_script_kernel(zwin_case):
    shape, inputs, ref, scale = zwin_case
    got = zwin_gathers(*inputs, shape)
    twin = zk.zwin_reference(*inputs, shape=shape)
    assert [a.shape for a in got] == [a.shape for a in ref]
    assert all(a.abs().max().item() > 0.1 for a in ref)  # live sums
    assert zk.max_scaled_error(got, twin, scale) <= SCALED_RTOL
    assert zk.max_scaled_error(got, ref, scale) <= SCALED_RTOL
    # every position of fL that no window covers is 0 in all three
    for a, b in zip(got[3:], ref[3:]):
        assert torch.equal(a == 0, b == 0)


def test_zwin_gathers_keep_coinciding_sources_apart(zwin_case):
    """At NCOL 2 the +1 and -1 windows read one column and +-12 the column
    itself, at NCOL 12 +-12 the column itself: the match above held each w
    as its own term there. The starts moved by one fail the scaled
    check."""
    shape, inputs, ref, scale = zwin_case
    nsrc = {len({(c - off) % shape.ncol for off in shape.offsets})
            for c in range(shape.ncol)}
    assert nsrc == {2: {2}, 12: {3}, 26: {4}}[shape.ncol]
    moved = zwin_gathers(*inputs[:-1], inputs[-1] + 1, shape)
    assert zk.max_scaled_error(moved, ref, scale) > 0.1


def _edge_grid(ncells, cc):
    """A lattice grid (jittered atoms at random lanes among pads, float
    ids) as the column walk's tests build it, f64: ([gx, gy, gz, gi], prd)."""
    ncell = ncells[0] * ncells[1] * ncells[2]
    counts = [(c * 5) % (min(cc, 32) // 2) + 2 for c in range(ncell)]
    if cc > 32:
        counts[ncell // 2] = 40  # two row passes of one warp
    g, prd, valid = planted.lattice_grid(ncells, cc, counts, 5,
                                         torch.float64, "cpu")
    ids = torch.where(valid, torch.arange(valid.numel()).reshape(
        valid.shape), -1).to(torch.float64)
    shape = (ncells[0] * ncells[1], ncells[2], cc)
    col = [a.reshape(shape) for a in (*g, ids)]
    return col, prd


@pytest.mark.parametrize("ncells,cc", EDGE_GRIDS)
def test_k2_twin_matches_the_script_body_on_edge_grids(ncells, cc):
    col, prd = _edge_grid(ncells, cc)
    calls = v3_calls_of(KEY, ncells, cc, jnp.float64,
                        jnp.asarray(prd.numpy()), jnp.asarray(col[3].numpy()))
    ref = [torch.from_numpy(np.array(a)) for a in
           calls["k2"](*(jnp.asarray(a.numpy()) for a in col[:3]))]
    args = (KEY, ncells, *col, prd)
    twin = v3_kernels.v3_reference(*args, grouped=True)
    launches = v3_kernels.v3_k2.launches
    got = v3_kernels.v3_k2(*args)
    assert v3_kernels.v3_k2.launches == launches  # CPU: the plain twin
    assert all(torch.equal(a, b) for a, b in zip(got, twin))
    vmax = max(a.abs().max().item() for a in ref)
    assert vmax > 0.01  # pairs within the cutoff
    for a, b in zip(twin, ref):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10 * vmax)
    # the same forces as k1, summed in another order
    for a, b in zip(twin, v3_kernels.v3_reference(*args)):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10 * vmax)


def _parent_dir(tmp_path, skip=()):
    for src in cuda_build.CSRC.iterdir():
        if src.name not in skip:
            shutil.copy(src, tmp_path / src.name)
    return tmp_path


def test_parent_entries_name_every_contender():
    """Every contender has an earlier-tree entry point named in one of
    this tree's sources (the column passes share their signatures; P12's
    name stays, its earlier signature adds the strips)."""
    assert set(pr.PARENT_ENTRIES) == {*pr.COLUMN, "P12"}
    for name, (src, stem, types, dts) in pr.PARENT_ENTRIES.items():
        text = pr.SOURCES[src].read_text()
        for dt in dts:
            assert f"{stem}_{dt}" in text, (name, stem, dt)
    assert len(pr.PARENT_ENTRIES["P12"][2]) == 14 + 9 + 3 + 1


def test_parent_strips_at_the_script_shape():
    """The earlier P12's strips: the own strip 8 (NPC - 1) + WS = 280 and
    four neighbour strips NPC - 1 + WN = 87 (628 floats a component)."""
    assert pr.parent_strip_len(zk.ZwinShape()) == 280 + 4 * 87
    assert zk.ZwinShape().lane_pairs == 144 * 32 * 8 * 256


def test_parent_sources_are_checked(tmp_path):
    """--parent must be a directory holding the script's sources and the
    headers; a missing one is named."""
    with pytest.raises(FileNotFoundError, match="not a directory"):
        fr.parent_sources(tmp_path / "absent", pr.SOURCES)
    parent = _parent_dir(tmp_path, skip=("zwin_proto.cu",))
    with pytest.raises(FileNotFoundError, match="zwin_proto.cu"):
        fr.parent_sources(parent, pr.SOURCES)
    shutil.copy(zk.SOURCE, parent / zk.SOURCE.name)
    assert fr.parent_sources(parent, pr.SOURCES) == {
        name: parent / name for name in pr.SOURCES}


def test_headers_are_required(tmp_path):
    for name, src in pr.SOURCES.items():
        shutil.copy(src, tmp_path / name)
    with pytest.raises(FileNotFoundError, match="headers"):
        fr.parent_sources(tmp_path, pr.SOURCES)


@pytest.mark.parametrize("rounds,inner", [(0, 20), (5, 0)])
def test_counts_are_checked_before_the_card(tmp_path, rounds, inner):
    with pytest.raises(ValueError, match="rounds and inner"):
        pr.main(str(_parent_dir(tmp_path)), rounds=rounds, inner=inner)


def test_missing_parent_raises_before_the_card(tmp_path):
    with pytest.raises(FileNotFoundError):
        pr.main(str(tmp_path / "absent"))


@pytest.mark.parametrize("name", sorted({**pr.VARIANTS, **pr.ABLATIONS}))
def test_designs_assemble(name, tmp_path):
    """Each other P12 design (and each ablation) is this tree's
    zwin_proto.cu with lines replaced: each line must be there once, the
    headers beside it."""
    lines = {**pr.VARIANTS, **pr.ABLATIONS}[name]
    out = pr.variant_source(tmp_path, lines)
    text, original = out.read_text(), zk.SOURCE.read_text()
    for old, new in lines:
        assert original.count(old + "\n") == 1 and new + "\n" in text
        original = original.replace(old + "\n", new + "\n")
    assert text == original
    assert {p.name for p in tmp_path.glob("*.cuh")} == {
        p.name for p in cuda_build.CSRC.glob("*.cuh")}
