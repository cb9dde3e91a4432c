"""PyTorch port, the sorted layout's re-bin on the CPU: the plain versions'
gate, the slot order the card's kernels follow, and the generic segment's
own copies.

On the card `needs_rebuild`, `rebuild_if` and `rebuild_state` launch the
kernels of ops/rebin_kernels (csrc/sorted_rebin.cu), which
tests/test_torch_rebin_cuda.py holds bit for bit to the plain versions
held here. The kernels do the re-bin only where the rebuild flag is set,
in place, so the segment runner starts from its own copies
(`sortedforce.segment_copies`). f64 and f32, no JAX: exact comparisons.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from lammps_kokkos_port_tpu_torch.integrate.verlet import make_step_segment
from lammps_kokkos_port_tpu_torch.ops import cuda_build, rebin_kernels
from lammps_kokkos_port_tpu_torch.ops import sortedforce as sf
from lammps_kokkos_port_tpu_torch.presets import lj_melt_sim

DTYPES = [torch.float64, torch.float32]
STATE_FIELDS = ("x", "v", "f", "type", "tag", "image", "mask")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sorted_melt(dtype, slack=24, check=False):
    """The 2,048-atom melt sorted on a 4 x 4 x 4 grid whose cells have
    `slack` rows of room (so a jitter of most of a cell overflows none),
    with `ago` and `nbuilds` as device tensors, as inside a segment."""
    sim = lj_melt_sim(cells=8, t_init=1.44, dtype=dtype, check=check,
                      every=1, delay=0, device="cpu")
    sim.setup()
    p = dataclasses.replace(sim.nl.params,
                            cell_cap=sim.nl.params.cell_cap + slack)
    st, nl = sf.build(sf.expand_state(sim.state, p), p)
    nl = dataclasses.replace(nl, ago=torch.tensor(3), nbuilds=torch.tensor(2),
                             xhold=st.x.clone())
    return sim, st, nl


def _jittered(st, nl, frac=0.9, seed=3):
    """Valid rows moved by up to +-frac/2 of a cell in each axis: many
    cross a cell face, some the box's faces."""
    gen = torch.Generator().manual_seed(seed)
    edge = (st.box.prd.double()
            / torch.tensor(nl.params.ncells, dtype=torch.float64)).min()
    jit = (torch.rand(st.x.shape, generator=gen, dtype=torch.float64)
           - 0.5) * frac * edge
    return st.replace(x=torch.where(st.valid_mask[:, None],
                                    (st.x.double() + jit).to(st.dtype),
                                    st.x))


def _assert_same(a, b, fields=STATE_FIELDS):
    for k in fields:
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("dtype", DTYPES)
def test_rebuild_if_flag_false_leaves_state(dtype):
    """A step that does not rebuild: every array as it was, the list's
    xhold and overflow too; `ago` counts on, `nbuilds` stays."""
    _, st, nl = _sorted_melt(dtype)
    moved = _jittered(st, nl)
    out, cl = sf.rebuild_if(moved, nl, torch.tensor(False))
    _assert_same(out, moved)
    assert torch.equal(cl.xhold, nl.xhold)
    assert int(cl.ago) == 4 and int(cl.nbuilds) == 2
    assert not bool(cl.overflow)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rebuild_if_flag_true_is_rebuild_state(dtype):
    """A rebuild step equals `rebuild_state` on the wrapped state, row for
    row; xhold is the new positions, ago 0, nbuilds one more."""
    _, st, nl = _sorted_melt(dtype)
    moved = _jittered(st, nl)
    out, cl = sf.rebuild_if(moved, nl, torch.tensor(True))
    x, image = moved.box.wrap(moved.x, moved.image)
    ref, rcl = sf.rebuild_state(moved.replace(x=x, image=image), nl)
    _assert_same(out, ref, STATE_FIELDS[:1] + STATE_FIELDS[2:] + ("v",))
    assert torch.equal(cl.xhold, out.x)
    assert int(cl.ago) == 0 and int(cl.nbuilds) == int(rcl.nbuilds) == 3
    assert not bool(cl.overflow) and not bool(rcl.overflow)
    # atoms moved between cells and across the box's faces
    assert not torch.equal(out.tag, moved.tag)
    assert not torch.equal(out.image, moved.image)


def _slots_by_stream(state, p):
    """The kernels' slot order formed by a sort: each valid row's new cell
    and its stream (its move, (dx+1)*9 + (dy+1)*3 + (dz+1)), then within
    each new cell the rows ordered by (stream, row). Returns the forward
    destinations ([rows], -1 on pads) and whether any cell overflowed."""
    nx, ny, nz = p.ncells
    cc = p.cell_cap
    dims = torch.tensor([nx, ny, nz])
    lamda = state.box.to_lamda(state.x)
    frac = torch.clamp(lamda - torch.floor(lamda), 0.0, 1.0 - 1e-7)
    c_new = torch.minimum(torch.clamp(torch.floor(
        frac * dims.to(frac.dtype)).long(), min=0), dims - 1).numpy()
    rows = np.arange(state.capacity)
    cell = rows // cc
    c_old = np.stack([cell // (ny * nz), (cell // nz) % ny, cell % nz], 1)
    n = np.array([nx, ny, nz])
    d = c_new - c_old
    d = np.where(d > n // 2, d - n, np.where(d < -(n // 2), d + n, d))
    valid = state.valid_mask.numpy()
    assert np.abs(d[valid]).max() <= 1
    stream = (d[:, 0] + 1) * 9 + (d[:, 1] + 1) * 3 + (d[:, 2] + 1)
    dest = (c_new[:, 0] * ny + c_new[:, 1]) * nz + c_new[:, 2]
    order = np.lexsort((rows[valid], stream[valid], dest[valid]))
    vrows, vdest = rows[valid][order], dest[valid][order]
    first = np.searchsorted(vdest, vdest, side="left")
    slot = np.arange(len(vrows)) - first
    out = np.full(state.capacity, -1)
    out[vrows] = vdest * cc + slot
    return out, bool(slot.max() >= cc)


@pytest.mark.parametrize("dtype", DTYPES)
def test_slot_order_is_stream_then_rank(dtype):
    """The order the move kernel writes a cell in (the streams in order,
    each stream's rows in their old order: ballots and popcounts, no
    atomics) is the plain version's permutation, at a cell_cap that takes
    the kernel's warp three passes (72 rows)."""
    _, st, nl = _sorted_melt(dtype)
    assert nl.params.cell_cap > 64
    moved = _jittered(st, nl)
    x, image = moved.box.wrap(moved.x, moved.image)
    wrapped = moved.replace(x=x, image=image)
    newpos, overflow = sf._local_perm(wrapped, nl.params)
    want, over = _slots_by_stream(wrapped, nl.params)
    valid = wrapped.valid_mask.numpy()
    assert not bool(overflow) and not over
    np.testing.assert_array_equal(newpos.numpy()[valid], want[valid])


def test_segment_copies_own_their_arrays():
    """The segment's copies: equal values in storage of their own, the
    counters as int64 tensors, `short_need` shared (the host reads it after
    a short-list overflow)."""
    _, st, nl = _sorted_melt(torch.float64)
    nl = dataclasses.replace(nl, ago=5, nbuilds=7)
    own, cl = sf.segment_copies(st, nl)
    for k in ("type", "tag", "image", "mask"):
        a, b = getattr(st, k), getattr(own, k)
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), k
    for a, b in ((nl.xhold, cl.xhold), (nl.overflow, cl.overflow)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert cl.ago.dtype == cl.nbuilds.dtype == torch.int64
    assert (int(cl.ago), int(cl.nbuilds)) == (5, 7)
    assert cl.short_need is nl.short_need


def test_segment_leaves_the_callers_state():
    """A generic segment (`check yes`, every 1) with rebuilds in it leaves
    the state and list it was given as they were: the grow-retry's
    snapshot and a thermo row's state stay intact."""
    sim, st, nl = _sorted_melt(torch.float64, check=True)
    nl = dataclasses.replace(nl, ago=0, nbuilds=1)
    sim.state, sim.nl = st, nl
    sim.presetup_forces()
    st = sim.state
    before = {k: getattr(st, k).clone() for k in STATE_FIELDS}
    xhold, overflow = nl.xhold.clone(), nl.overflow.clone()
    runner = make_step_segment(sim.integrator, sim.force_fn)
    out, cl = runner(st, nl, 40)
    assert int(cl.nbuilds) > 1  # the segment rebuilt
    for k, a in before.items():
        assert torch.equal(getattr(st, k), a), k
    assert torch.equal(nl.xhold, xhold) and torch.equal(nl.overflow,
                                                        overflow)
    assert (nl.ago, nl.nbuilds) == (0, 1)


def test_kernel_entry_points_refuse_cpu_tensors():
    """ops/rebin_kernels takes CUDA tensors only: no fallback on the CPU
    (ops/sortedforce sends CPU tensors to the plain versions)."""
    _, st, nl = _sorted_melt(torch.float64)
    for call in (lambda: rebin_kernels.needs_rebuild(st, nl),
                 lambda: rebin_kernels.rebuild_if(st, nl,
                                                  torch.tensor(True)),
                 lambda: rebin_kernels.rebuild_state(st, nl)):
        with pytest.raises(NotImplementedError, match="no kernel"):
            call()


def test_pad_sentinels_match_the_source():
    """csrc/sorted_rebin.cu writes ops/sortedforce's pad sentinels."""
    text = rebin_kernels.SOURCE.read_text()
    pos = re.search(r"kPadPos = ([0-9.e+]+);", text).group(1)
    step = re.search(r"kPadStep = ([0-9.e+]+);", text).group(1)
    assert float(pos) == sf.PAD_POS and float(step) == sf.PAD_STEP


def test_build_brings_the_companions(tmp_path, monkeypatch):
    """A build that starts nvcc for a source also starts it for a missing
    companion (the re-bin kernels), in the same batch; a source on disk
    starts nothing."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    src, companion = tmp_path / "k.cu", tmp_path / "rebin.cu"
    src.write_text("int a;\n")
    companion.write_text("int b;\n")
    monkeypatch.setattr(cuda_build, "COMPANIONS", (companion,))
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    started = []

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            started.append(cmd[-1])

        def communicate(self):
            return "ptxas info\n", None

        def poll(self):
            return 0

    monkeypatch.setattr(cuda_build.subprocess, "Popen", FakeNvcc)
    assert list(cuda_build.build(src)) == ["k.cu"]
    assert started == [str(src), str(companion)]
    assert cuda_build.lib_path(companion).exists()
    started.clear()
    cuda_build.build(src)
    assert started == []
