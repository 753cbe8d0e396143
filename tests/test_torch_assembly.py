"""Port parity: meshes, dof maps, element assemblers and the stiffness kernel.

The JAX package (f64 on the CPU) and the port run on the same numpy
inputs.  The JAX Pallas stiffness kernel runs once, in interpret mode; the
CUDA kernel runs only on a card: its tests are in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import LAM, MU, rel_err, rng, to_numpy

import fenris_tpu.assembly.global_ as jglobal
import fenris_tpu.assembly.local as jlocal
import fenris_tpu.mesh.procedural as jproc
import fenris_tpu_torch.assembly.global_ as tglobal
import fenris_tpu_torch.assembly.local as tlocal
import fenris_tpu_torch.mesh.procedural as tproc
import fenris_tpu_torch.ops.stiffness_pairs as tsk
from fenris_tpu.fem import FemSpace as JaxSpace
from fenris_tpu.operators import LaplaceOperator as JaxLaplace
from fenris_tpu.quadrature.canonical import canonical_stiffness as jax_canonical
from fenris_tpu.quadrature.tensor import hexahedron_gauss as jax_hex_gauss
from fenris_tpu.solid import LameParameters as JaxLame
from fenris_tpu.solid import LinearElasticMaterial as JaxLinear
from fenris_tpu.solid import MaterialEllipticOperator as JaxMaterialOp
from fenris_tpu.solid import NeoHookeanMaterial as JaxNeoHookean
from fenris_tpu_torch.fem import FemSpace as TorchSpace
from fenris_tpu_torch.operators import LaplaceOperator as TorchLaplace
from fenris_tpu_torch.quadrature import canonical_stiffness as torch_canonical
from fenris_tpu_torch.quadrature import hexahedron_gauss as torch_hex_gauss
from fenris_tpu_torch.solid import LameParameters as TorchLame
from fenris_tpu_torch.solid import LinearElasticMaterial as TorchLinear
from fenris_tpu_torch.solid import MaterialEllipticOperator as TorchMaterialOp
from fenris_tpu_torch.solid import NeoHookeanMaterial as TorchNeoHookean

OPERATORS = {
    "neo_hookean": (lambda: JaxMaterialOp(JaxNeoHookean(), dim=3), lambda: TorchMaterialOp(TorchNeoHookean(), dim=3)),
    "linear": (lambda: JaxMaterialOp(JaxLinear(), dim=3), lambda: TorchMaterialOp(TorchLinear(), dim=3)),
    "laplace": (JaxLaplace, TorchLaplace),
}


def _params(kind):
    if kind == "laplace":
        return None, None
    return JaxLame(MU, LAM), TorchLame(MU, LAM)


def _perturbed_box(res=3, seed=0):
    """Box hex mesh with interior nodes moved by up to 20% of a cell (non-affine cells)."""
    jm, tm = jproc.create_unit_box_uniform_hex_mesh_3d(res), tproc.create_unit_box_uniform_hex_mesh_3d(res)
    X = np.asarray(jm.points) + rng(seed).uniform(-0.2, 0.2, jm.points.shape) / res
    return X[np.asarray(jm.cells)], np.asarray(jm.cells)


def _tabs(rule="canonical"):
    jel = jproc.create_unit_box_uniform_hex_mesh_3d(1).element
    tel = tproc.create_unit_box_uniform_hex_mesh_3d(1).element
    if rule == "canonical":
        return jlocal.tabulate(jel, jax_canonical(jel)), tlocal.tabulate(tel, torch_canonical("hex8"))
    return jlocal.tabulate(jel, jax_hex_gauss(rule)), tlocal.tabulate(tel, torch_hex_gauss(rule))


@pytest.mark.parametrize("res", [1, 3])
def test_box_mesh_dofs_and_cell_points_match_jax(res):
    jm, tm = jproc.create_unit_box_uniform_hex_mesh_3d(res), tproc.create_unit_box_uniform_hex_mesh_3d(res)
    assert tm.num_cells == jm.num_cells and tm.num_vertices == jm.num_vertices and tm.dim == jm.dim
    assert np.array_equal(tm.cells, np.asarray(jm.cells)) and tm.cells.dtype == np.int32
    np.testing.assert_array_equal(tm.points, np.asarray(jm.points))
    np.testing.assert_array_equal(tm.cell_points(), np.asarray(jm.cell_points()))
    np.testing.assert_array_equal(
        tglobal.element_dof_indices(tm.cells, 3), jglobal.element_dof_indices(np.asarray(jm.cells), 3)
    )
    js, ts = JaxSpace.create(jm, solution_dim=3), TorchSpace.create(tm, 3, dtype=torch.float64, device="cpu")
    assert ts.num_dofs == js.num_dofs
    np.testing.assert_array_equal(to_numpy(ts.X_geo), np.asarray(js.X_geo))
    np.testing.assert_array_equal(to_numpy(ts.dofs), np.asarray(js.dofs))
    u = rng(1).standard_normal(js.num_dofs)
    np.testing.assert_array_equal(to_numpy(ts.local_dofs(torch.as_tensor(u))), np.asarray(js.local_dofs(jnp.asarray(u))))


def test_rectangular_mesh_matches_jax():
    jm = jproc.create_rectangular_uniform_hex_mesh(0.5, 3, 2, 1, 2)
    tm = tproc.create_rectangular_uniform_hex_mesh(0.5, 3, 2, 1, 2)
    np.testing.assert_array_equal(tm.cells, np.asarray(jm.cells))
    np.testing.assert_array_equal(tm.points, np.asarray(jm.points))


def test_assemble_vector_matches_jax_and_is_order_fixed():
    cells = np.asarray(jproc.create_unit_box_uniform_hex_mesh_3d(3).cells)
    dofs = jglobal.element_dof_indices(cells, 3)
    f_el = rng(2).standard_normal(dofs.shape)
    ref = np.asarray(jglobal.assemble_vector(jnp.asarray(f_el), dofs, 64 * 3))
    got = tglobal.assemble_vector(torch.as_tensor(f_el), dofs, 64 * 3)
    assert rel_err(ref, got) < 1e-14
    # the layers partition the rows and never repeat a target
    plan = tglobal.scatter_plan(torch.as_tensor(dofs))
    assert plan.layers is not None and len(plan.layers) == 8
    seen = torch.cat(plan.layers).sort().values
    assert torch.equal(seen, torch.arange(dofs.size))
    for sel in plan.layers:
        ids = plan.ids[sel]
        assert len(torch.unique(ids)) == len(ids)
    assert tglobal.scatter_plan(torch.arange(10)).layers is None


@pytest.mark.parametrize("kind", ["neo_hookean", "linear", "laplace"])
def test_element_vectors_matrices_and_pairs_match_jax(kind):
    Xe, cells = _perturbed_box()
    jtab, ttab = _tabs()
    jop, top = OPERATORS[kind][0](), OPERATORS[kind][1]()
    jp, tp = _params(kind)
    s = top.solution_dim
    E = Xe.shape[0]
    u_el = rng(3).uniform(-0.02, 0.02, (E, 8, s))
    Xj, Xt = jnp.asarray(Xe), torch.as_tensor(Xe)
    uj, ut = jnp.asarray(u_el), torch.as_tensor(u_el)
    # f64, another summation order: roundoff only
    ref = jlocal.assemble_element_elliptic_vectors(Xj, uj, jop, jp, jtab)
    assert rel_err(ref, tlocal.assemble_element_elliptic_vectors(Xt, ut, top, tp, ttab)) < 1e-12
    ref = jlocal.assemble_element_elliptic_matrices(Xj, uj, jop, jp, jtab)
    assert rel_err(ref, tlocal.assemble_element_elliptic_matrices(Xt, ut, top, tp, ttab)) < 1e-12
    got = tlocal.assemble_element_elliptic_matrices(Xt, ut, top, tp, ttab, chunk=10)
    assert rel_err(ref, got) < 1e-12
    ref = jlocal.assemble_element_elliptic_matrices_pairs(Xj, uj, jop, jp, jtab)
    got = tlocal.assemble_element_elliptic_matrices_pairs(Xt, ut, top, tp, ttab)
    assert rel_err(ref, got) < 1e-12
    e = jlocal.compute_element_elliptic_energy(Xj, uj, jop, jp, jtab)
    assert rel_err(e, tlocal.compute_element_elliptic_energy(Xt, ut, top, tp, ttab)) < 1e-12


@pytest.mark.parametrize("kind", ["linear", "laplace"])
def test_affine_constant_contraction_path_matches_jax(kind):
    """A one-point rule makes hex8 'affine': both packages take the hoisted projector."""
    Xe, _ = _perturbed_box(2)
    jtab, ttab = _tabs(rule=1)
    assert tlocal._affine_geometry(ttab) and jlocal._affine_geometry(jtab)
    jop, top = OPERATORS[kind][0](), OPERATORS[kind][1]()
    jp, tp = _params(kind)
    Xj, Xt = jnp.asarray(Xe), torch.as_tensor(Xe)
    ref = jlocal.assemble_element_elliptic_matrices_pairs(Xj, None, jop, jp, jtab)
    assert rel_err(ref, tlocal.assemble_element_elliptic_matrices_pairs(Xt, None, top, tp, ttab)) < 1e-12
    ref = jlocal.assemble_element_elliptic_matrices(Xj, None, jop, jp, jtab)
    assert rel_err(ref, tlocal.assemble_element_elliptic_matrices(Xt, None, top, tp, ttab)) < 1e-12


def test_source_vectors_match_jax():
    Xe, _ = _perturbed_box()
    jtab, ttab = _tabs()
    Xj, Xt = jnp.asarray(Xe), torch.as_tensor(Xe)
    ref = jlocal.assemble_element_source_vectors(
        Xj, lambda x, p: jnp.stack([x[0], -2.0 + 0 * x[0], x[2] * x[1]]), None, 3, jtab
    )
    got = tlocal.assemble_element_source_vectors(
        Xt, lambda x, p: torch.stack([x[0], -2.0 + 0 * x[0], x[2] * x[1]]), None, 3, ttab
    )
    assert rel_err(ref, got) < 1e-12
    ref = jlocal.assemble_element_source_vectors(Xj, lambda x, p: jnp.array([0.0, 0.0, -4.0]), None, 3, jtab)
    assert rel_err(ref, tlocal.assemble_element_source_vectors(Xt, np.array([0.0, 0.0, -4.0]), None, 3, ttab)) < 1e-12


def test_per_element_params_refused():
    Xe, _ = _perturbed_box(1)
    _, ttab = _tabs()
    top = OPERATORS["linear"][1]()
    params = TorchLame(torch.full((Xe.shape[0],), MU), LAM)
    with pytest.raises(NotImplementedError, match="per-element"):
        tlocal.assemble_element_elliptic_matrices(torch.as_tensor(Xe), None, top, params, ttab)


@pytest.fixture
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


def test_stiffness_plain_matches_pallas_interpret():
    """The plain version against the TPU kernel itself (interpret mode, f32)."""
    from fenris_tpu.ops.stiffness_kernel import stiffness_pairs_pallas

    Xe, _ = _perturbed_box(2)
    jtab, ttab = _tabs()
    jop, top = OPERATORS["linear"][0](), OPERATORS["linear"][1]()
    jp, tp = _params("linear")
    X32 = Xe.astype(np.float32)
    ref = stiffness_pairs_pallas(jnp.asarray(X32), jop, jp, jtab, interpret=True)
    got = tsk.stiffness_pairs_plain(torch.as_tensor(X32), top, tp, ttab)
    # f32 roundoff, another summation order (the tolerance of test_stiffness_kernel.py)
    assert rel_err(np.asarray(ref), got) < 5e-6


@pytest.mark.parametrize("kind", ["linear", "laplace"])
def test_stiffness_wrapper_takes_plain_version_on_cpu(kind):
    Xe, _ = _perturbed_box(2)
    _, ttab = _tabs()
    top = OPERATORS[kind][1]()
    tp = _params(kind)[1]
    Xt = torch.as_tensor(Xe, dtype=torch.float32)
    before = tsk.stiffness_pairs.launches
    got = tlocal.assemble_element_elliptic_matrices_pairs(Xt, None, top, tp, ttab, kernel=True)
    assert torch.equal(got, tsk.stiffness_pairs_plain(Xt, top, tp, ttab))
    assert tsk.stiffness_pairs.launches == before
    # the gate is for CUDA tensors only; on the CPU "auto" is the plain path
    assert not tsk.supports_stiffness_kernel(top, tp, ttab, Xt)
    s, E = top.solution_dim, Xe.shape[0]
    g = to_numpy(got).reshape(s, s, 8, 8, E)
    for i in range(s):
        for j in range(i + 1, s):  # mirror blocks are exact node transposes
            np.testing.assert_array_equal(g[j, i], g[i, j].transpose(1, 0, 2))


def _direct_pairs_emulation(X, op, params, tab):
    """float64 emulation of ``csrc/stiffness_pairs.cu`` on the inputs its wrapper hands it.

    Per quadrature point J, J^-1, w|det| and the physical gradients
    ``G_q = dphi_q J^-1``; per node pair ``M_ab = Σ_q w|det| G_q[a] G_q[b]ᵀ``;
    per computed pair p (row-major, upper only for symmetric operators) the
    block entries ``C^p : M_ab``, i.e. ``Σ_q (w|det| G_q) C^p G_qᵀ``; the
    mirror block (j, i) of a symmetric operator is the node transpose of
    (i, j).
    """
    tables, C, meta = tsk._constants(op, params, tab)
    m, n, q, d, s, sym = (meta[k] for k in ("m", "n", "q", "d", "s", "sym"))
    gd = torch.as_tensor(tables[: q * m * d]).reshape(q, m, d)
    dphi = torch.as_tensor(tables[q * m * d : q * (m + n) * d]).reshape(q, n, d)
    w = torch.as_tensor(tables[q * (m + n) * d :])
    assert w.shape == (q,)
    X = torch.as_tensor(X, dtype=torch.float64)
    J = torch.einsum("qml,emk->eqkl", gd, X)
    G = torch.einsum("qbl,eqlk->eqbk", dphi, torch.linalg.inv(J))
    wG = G * (w * torch.linalg.det(J).abs())[..., None, None]
    M = torch.einsum("eqak,eqbl->abkle", wG, G)
    pairs = [(i, j) for i in range(s) for j in range(s) if not sym or i <= j]
    assert C.shape == (len(pairs), d, d)
    out = torch.zeros((s * s, n * n, X.shape[0]), dtype=torch.float64)
    for (i, j), Cp in zip(pairs, torch.as_tensor(C)):
        A = torch.einsum("kl,abkle->abe", Cp, M)
        out[i * s + j] = A.reshape(n * n, -1)
        if sym and i != j:
            out[j * s + i] = A.transpose(0, 1).reshape(n * n, -1)
    return out


@pytest.mark.parametrize("kind", ["linear", "laplace"])
def test_direct_stiffness_formula_matches_jax_pairs(kind):
    """The stiffness kernel's arithmetic (direct per-point G C Gᵀ, its constant tables and mirror
    layout) against the JAX XLA pairs path, f64 on a perturbed res-2 box."""
    Xe, _ = _perturbed_box(2)
    jtab, ttab = _tabs()
    jop, top = OPERATORS[kind][0](), OPERATORS[kind][1]()
    jp, tp = _params(kind)
    ref = jlocal.assemble_element_elliptic_matrices_pairs(jnp.asarray(Xe), None, jop, jp, jtab, pallas=False)
    # f64, another summation order: roundoff only
    assert rel_err(np.asarray(ref), _direct_pairs_emulation(Xe, top, tp, ttab)) < 1e-12


def test_stiffness_kernel_gate():
    """What the kernel is instantiated for: d in (2, 3), 1, 3, 4, 6 or 9 pairs, a gradient table that
    fits in shared memory; never a CPU or f64 tensor."""
    _, ttab = _tabs()
    lin, lap = OPERATORS["linear"][1](), OPERATORS["laplace"][1]()
    assert tsk._fits(lin, ttab) and tsk._fits(lap, ttab)

    class FourComponents:
        solution_dim, symmetric, constant_contraction = 4, True, True  # 10 upper pairs

    assert not tsk._fits(FourComponents(), ttab)
    assert tsk._smem_bytes(8, 8, 8, 3) == 4 * (8 * 8 * 32 * 4 + 8 * 3 * 32 + 8 * 16 * 3 + 8)
    assert not tsk.supports_stiffness_kernel(lin, _params("linear")[1], ttab, torch.zeros((4, 8, 3)))


def test_stiffness_wrapper_refuses_other_devices_and_nonconstant_operators():
    _, ttab = _tabs()
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tsk.stiffness_pairs(torch.empty((4, 8, 3), device="meta"), OPERATORS["linear"][1](), _params("linear")[1], ttab)
    with pytest.raises(ValueError, match="constant"):
        tsk.stiffness_pairs_plain(torch.zeros((4, 8, 3)), OPERATORS["neo_hookean"][1](), _params("linear")[1], ttab)
