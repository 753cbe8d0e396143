"""Port parity: block-DIA plans, assembly, matvecs and the band-sweep kernel.

The port builds its plans with PyTorch (on the model's device); here they
are held equal to the JAX package's numpy plans entry for entry.  The JAX
Pallas band sweep runs once, in interpret mode; the CUDA kernel runs only
on a card (``cuda``-marked, skips without one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err, rng, to_numpy

import fenris_tpu.elasticity as jel
import fenris_tpu.sparse.block_dia as jbd
import fenris_tpu.sparse.dia_kernel as jdk
import fenris_tpu_torch.elasticity as tel
import fenris_tpu_torch.ops.dia_sweep as tds
import fenris_tpu_torch.sparse.block_dia as tbd
import fenris_tpu_torch.sparse.dia_kernel as tdk
from fenris_tpu.mesh.procedural import create_unit_box_uniform_hex_mesh_3d as jax_box
from fenris_tpu.solid import LameParameters as JaxLame
from fenris_tpu.solid import NeoHookeanMaterial as JaxNeoHookean
from fenris_tpu_torch.mesh import Mesh
from fenris_tpu_torch.reference_elements import HEX8
from fenris_tpu_torch.solid import LameParameters as TorchLame
from fenris_tpu_torch.solid import NeoHookeanMaterial as TorchNeoHookean


def _box_cells(res):
    m = jax_box(res)
    return np.asarray(m.cells), m.num_vertices


def _plane_swapped_box():
    """res-6 box with node planes z = 0 and z = 2 renumbered into each other.

    Three slot-signature classes of 108, 72 and 36 elements (distinct
    counts, so the class ranking has no ties) and extra node deltas.
    """
    cells, N = _box_cells(6)
    return _PLANE_SWAP[cells], N


_PLANE_SWAP = np.arange(7**3)  # node renumbering of the plane-swapped res-6 box
_PLANE_SWAP[:49], _PLANE_SWAP[98:147] = np.arange(98, 147), np.arange(49)


def _rolled_box():
    """res-3 box plus rolled copies of 5 and 7 cells: classes of 27, 7 and 5 elements."""
    cells, N = _box_cells(3)
    extra = [np.roll(cells[:5], 2, axis=1), np.roll(cells[5:12], 4, axis=1)]
    return np.concatenate([cells] + extra, axis=0), N


CASES = {
    "box": lambda: _box_cells(4) + ({},),
    "plane_swapped": lambda: _plane_swapped_box() + ({},),
    "plane_swapped_2_classes": lambda: _plane_swapped_box() + ({"max_classes": 2},),
    "rolled_1_class": lambda: _rolled_box() + ({"max_classes": 1},),
    "max_diagonals": lambda: _box_cells(4) + ({"max_diagonals": 7},),
    "min_fill": lambda: _plane_swapped_box() + ({"min_fill": 0.2},),
}


def _plans(case, s=3):
    cells, N, kw = CASES[case]()
    pkw = {k: kw[k] for k in ("max_diagonals", "min_fill") if k in kw}
    ekw = {k: kw[k] for k in ("max_classes",) if k in kw}
    jp = jbd.block_dia_assembly_plan(cells, N, s, **pkw)
    tp = tbd.block_dia_assembly_plan(cells, N, s, device="cpu", **pkw)
    return cells, N, jp, tp, jbd.band_expand_plan(cells, jp, **ekw), tbd.band_expand_plan(cells, tp, **ekw)


@pytest.mark.parametrize("case", list(CASES))
def test_assembly_and_expand_plans_equal_jax(case):
    cells, N, jp, tp, je, te = _plans(case)
    assert tp.offsets == jp.offsets and tp.num_nodes == jp.num_nodes and tp.rem_k == jp.rem_k
    assert tp.fill == pytest.approx(jp.fill, rel=1e-15)
    assert tp.base.dtype == torch.int32 and np.array_equal(to_numpy(tp.base), np.asarray(jp.base))
    if jp.rem_k:
        assert np.array_equal(to_numpy(tp.rem_neighbors), np.asarray(jp.rem_neighbors))
    else:
        assert tp.rem_neighbors is None
    assert (te is None) == (je is None)
    if je is None:
        return
    assert te.num_classes == je.num_classes and te.coverage == pytest.approx(je.coverage)
    np.testing.assert_array_equal(to_numpy(te.class_mask), np.asarray(je.class_mask))
    np.testing.assert_array_equal(to_numpy(te.cols), np.asarray(je.cols))
    np.testing.assert_array_equal(to_numpy(te.dense_operators(3)), np.asarray(je.M))
    if je.slow_idx is None:
        assert te.slow_idx is None
    else:
        np.testing.assert_array_equal(to_numpy(te.slow_idx), np.asarray(je.slow_idx))


def test_plan_cases_cover_classes_slow_path_and_remainder():
    *_, tp, _, te = _plans("plane_swapped")
    assert te.num_classes == 3 and te.slow_idx is None
    *_, te2 = _plans("plane_swapped_2_classes")
    assert te2.num_classes == 2 and len(te2.slow_idx) == 36
    *_, te3 = _plans("rolled_1_class")
    assert te3.num_classes == 1 and len(te3.slow_idx) == 12
    assert _plans("max_diagonals")[3].rem_k > 0 and _plans("min_fill")[3].rem_k > 0


@pytest.mark.parametrize(
    "case, route",
    [(c, "flat") for c in ("box", "plane_swapped_2_classes", "rolled_1_class", "max_diagonals", "min_fill")]
    # max_diagonals=7 leaves no element whole on the bands: no expansion plan, in JAX as here
    + [(c, "expand") for c in ("box", "plane_swapped_2_classes", "rolled_1_class", "min_fill")],
)
def test_assemble_block_dia_matches_jax(case, route):
    cells, N, jp, tp, je, te = _plans(case)
    E, n = cells.shape
    A_el = rng(4).standard_normal((E, 3 * n, 3 * n))
    kw = dict(expand=(je, te)) if route == "expand" else {}
    ref = jbd.assemble_block_dia(jp, jnp.asarray(A_el), num_chunks=3, expand=kw.get("expand", (None,))[0])
    got = tbd.assemble_block_dia(tp, torch.as_tensor(A_el), num_chunks=3, expand=kw.get("expand", (None, None))[1])
    assert got.offsets == ref.offsets
    # f64, another summation order
    assert rel_err(np.asarray(ref.bands), got.bands) < 1e-13
    assert (got.remainder is None) == (ref.remainder is None)
    if ref.remainder is not None:
        assert rel_err(np.asarray(ref.remainder.blocks), got.remainder.blocks) < 1e-13
        np.testing.assert_array_equal(to_numpy(got.remainder.neighbors), np.asarray(ref.remainder.neighbors))


def _model_pair(mesh="box", **kw):
    """The same Neo-Hookean model in JAX and in the port (f64), on a res-4 box or the plane-swapped box."""
    from fenris_tpu.mesh import Mesh as JaxMesh

    jm = jax_box(4 if mesh == "box" else 6)
    cells, points = np.asarray(jm.cells), np.asarray(jm.points)
    if mesh == "plane_swapped":
        cells, _ = _plane_swapped_box()
        moved = np.empty_like(points)
        moved[_PLANE_SWAP] = points  # node i is now numbered _PLANE_SWAP[i]
        points = moved
        jm = JaxMesh(points, cells, jm.element)
    common = dict(dirichlet_nodes=np.arange(25))
    j = jel.HyperelasticModel(mesh=jm, material=JaxNeoHookean(), params=JaxLame(384.0, 577.0), **common, **kw)
    t = tel.HyperelasticModel(
        mesh=Mesh(points, cells, HEX8), material=TorchNeoHookean(),
        params=TorchLame(384.0, 577.0), dtype=torch.float64, device="cpu", **common, **kw,
    )
    return j, t


# exact DIA on the box; spilled deltas, two classes and a slow subset on the plane-swapped box
MODEL_CASES = {"exact": ("box", {}), "remainder": ("plane_swapped", {"min_fill": 0.2})}


@pytest.mark.parametrize("case", list(MODEL_CASES))
@pytest.mark.parametrize("route", ["materialized", "streamed", "streamed_capped"])
def test_model_band_assembly_matches_jax(route, case, monkeypatch):
    """Materialized, streamed and capped-stream band assembly == the JAX model's."""
    if route == "streamed_capped":
        # a stream chunk below the model's chunk (the capped-budget branch)
        for mod in (tel, jel):
            monkeypatch.setattr(mod, "_STREAM_EXPAND_BUDGET_BYTES", 1.0)
            monkeypatch.setattr(mod, "_STREAM_CHUNK_FLOOR", 7)
    mesh, plan_kw = MODEL_CASES[case]
    kw = {} if route == "materialized" else {"chunk_size": 13 if route == "streamed" else 33}
    jm, tm = _model_pair(mesh, **kw)
    expand = tm.block_dia_expand_plan(**plan_kw)
    assert expand is not None
    if route != "materialized":
        assert tm.chunk_size < tm.mesh.num_cells
    if route == "streamed_capped":
        assert tm._stream_chunk(expand) == 7
    if case == "remainder":
        assert expand.slow_idx is not None and tm.block_dia_plan(**plan_kw).rem_k > 0
    u = rng(5).standard_normal(tm.space.num_dofs) * 0.01
    ref = jm.assemble_hessian_block_dia(jnp.asarray(u), **plan_kw)
    got = tm.assemble_hessian_block_dia(torch.as_tensor(u), **plan_kw)
    assert got.offsets == ref.offsets
    # f64, another summation order: roundoff only
    assert rel_err(np.asarray(ref.bands), got.bands) < 1e-12
    assert (got.remainder is None) == (ref.remainder is None)
    if ref.remainder is not None:
        assert rel_err(np.asarray(ref.remainder.blocks), got.remainder.blocks) < 1e-12


@pytest.fixture(scope="module")
def operators():
    """A JAX/port pair of assembled operators: exact DIA and one with a remainder."""
    out = {}
    for name, (mesh, kw) in MODEL_CASES.items():
        jm, tm = _model_pair(mesh)
        u = rng(6).standard_normal(tm.space.num_dofs) * 0.01
        out[name] = (jm.assemble_hessian_block_dia(jnp.asarray(u), **kw), tm.assemble_hessian_block_dia(torch.as_tensor(u), **kw))
    return out


@pytest.mark.parametrize("name", ["exact", "remainder"])
def test_matvecs_and_operator_match_jax(operators, name):
    jm, tm = operators[name]
    assert (tm.remainder is None) == (name == "exact")
    N, s = tm.num_nodes, tm.solution_dim
    v = rng(7).standard_normal(N * s)
    x2 = np.ascontiguousarray(v.reshape(N, s).T)
    ref_dof = np.asarray(jbd.block_dia_matvec(jm, jnp.asarray(v)))
    ref_cm = np.asarray(jbd.block_dia_matvec_cm(jm, jnp.asarray(x2)))
    # f64: the same products, summed in the same order up to rounding
    assert rel_err(ref_dof, tbd.block_dia_matvec(tm, torch.as_tensor(v))) < 1e-12
    assert rel_err(ref_dof, tm @ torch.as_tensor(v)) < 1e-12
    assert rel_err(ref_cm, tbd.block_dia_matvec_cm(tm, torch.as_tensor(x2))) < 1e-12
    for kernel in ("auto", True, False):
        op_cm = tdk.block_dia_operator(tm, layout="component", kernel=kernel)
        op_dof = tdk.block_dia_operator(tm, kernel=kernel)
        assert rel_err(ref_cm, op_cm(torch.as_tensor(x2))) < 1e-12
        assert rel_err(ref_dof, op_dof(torch.as_tensor(v))) < 1e-12
    jop = jdk.block_dia_operator(jm, layout="component", pallas=False)
    assert rel_err(np.asarray(jop(jnp.asarray(x2))), tdk.block_dia_operator(tm, layout="component")(torch.as_tensor(x2))) < 1e-12
    with pytest.raises(ValueError, match="layout"):
        tdk.block_dia_operator(tm, layout="rows")


def test_dia_sweep_plain_matches_pallas_interpret(operators, monkeypatch):
    """The plain band sweep against the TPU windowed kernel itself (interpret mode, f32)."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    jm, tm = operators["exact"]
    N, s = tm.num_nodes, tm.solution_dim
    bands32 = np.asarray(jm.bands, np.float32)
    x2 = rng(8).standard_normal((s, N)).astype(np.float32)
    jm32 = jm._replace(bands=jnp.asarray(bands32))
    p = jdk.pack_block_dia_windowed(jm32, lanes=128)  # multi-step grid, halo across chunks
    ref = np.asarray(jdk.packed_dia_matvec_wm(p, jnp.asarray(x2), interpret=True))
    got = tds.dia_sweep_plain(torch.as_tensor(bands32), tm.offsets, torch.as_tensor(x2))
    # f32 roundoff, another summation order
    assert rel_err(ref, got) < 1e-5


def test_dia_sweep_ragged_scalar_matches_jax():
    """s = 1, offsets wider than N's ends: zero padding outside [0, N)."""
    N, offsets = 500, (-19, -5, -1, 0, 1, 5, 19)
    g = rng(9)
    bands, v = g.standard_normal((len(offsets), N)), g.standard_normal(N)
    ref = jbd.block_dia_matvec(jbd.BlockDiaMatrix(offsets, jnp.asarray(bands), N, 1, None), jnp.asarray(v))
    got = tds.dia_sweep(torch.as_tensor(bands), offsets, torch.as_tensor(v).reshape(1, N))
    assert rel_err(np.asarray(ref), got.reshape(-1)) < 1e-14
    assert torch.equal(tds.dia_sweep_plain(torch.as_tensor(bands)[:0], (), torch.zeros(1, N, dtype=torch.float64)),
                       torch.zeros(1, N, dtype=torch.float64))


def test_dia_sweep_wrapper_takes_plain_version_on_cpu_and_refuses_other_devices(operators):
    _, tm = operators["exact"]
    x2 = torch.as_tensor(rng(10).standard_normal((3, tm.num_nodes)))
    before = tds.dia_sweep.launches
    assert torch.equal(tds.dia_sweep(tm.bands, tm.offsets, x2), tds.dia_sweep_plain(tm.bands, tm.offsets, x2))
    assert tds.dia_sweep.launches == before
    assert not tdk.kernel_applicable(tm)  # CPU bands: the plain path
    meta = torch.empty((27 * 9, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tds.dia_sweep(meta, tm.offsets, torch.empty((3, 8), device="meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["exact", "remainder"])
def test_dia_sweep_kernel_matches_plain_on_card(operators, name, cuda_device):
    _, tm = operators[name]
    bands = tm.bands.to(device=cuda_device, dtype=torch.float32)
    x2 = torch.as_tensor(rng(11).standard_normal((3, tm.num_nodes)), dtype=torch.float32, device=cuda_device)
    got = tds.dia_sweep(bands, tm.offsets, x2)
    again = tds.dia_sweep(bands, tm.offsets, x2)
    torch.cuda.synchronize()
    # f32 roundoff (FMA contraction)
    assert rel_err(to_numpy(tds.dia_sweep_plain(bands, tm.offsets, x2)), got) < 1e-5
    assert torch.equal(got, again)
