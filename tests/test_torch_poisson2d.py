"""Port parity: the 2D slice — meshes, the Poisson MMS gates on three routes, subdivided rules and
the element-stiffness kernel's plain version and arithmetic at d = 2.

The JAX package (f64 on the CPU) and the port (``device="cpu"``) run on
the same numpy inputs.  The 2D producers and ``split_into_triangles``
give JAX's cells exactly and its points within 1e-15.  The four
``poisson2d_mms_*`` gates (tests/test_convergence.py:28-78) run the port
alone at resolutions 1-8 against ``tests/reference_values/`` within 1%,
with sources written in torch, on the CSR route (``fem.solve_poisson``,
JAX's route) and on the two others; ``solve_poisson``'s ``u`` is held
against JAX's on a res-4 tri6 mesh (1e-10).  The stiffness plain version
and an f64 emulation of ``csrc/stiffness_pairs.cu``'s node-pair rounds are
held against JAX's XLA pairs path (the reference JAX's own kernel test
uses) on quad4, quad9, tri3 and tri6 at s = 1 and 2.
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_stiffness_elements import kernel_emulation
from torch_parity import LAM, MU, rel_err, rng

import fenris_tpu.assembly.local as jlocal
import fenris_tpu.fem as JF
import fenris_tpu.quadrature as JQ
import fenris_tpu_torch.fem as TF
import fenris_tpu_torch.ops.stiffness_pairs as tsk
import fenris_tpu_torch.quadrature as TQ
from fenris_tpu.mesh import Mesh as JaxMesh
from fenris_tpu.mesh import procedural as JP
from fenris_tpu.mesh.convert import convert_mesh as jax_convert
from fenris_tpu.operators import LaplaceOperator as JaxLaplace
from fenris_tpu.reference_elements import element as jax_element
from fenris_tpu.solid import LameParameters as JaxLame
from fenris_tpu.solid import LinearElasticMaterial as JaxLinear
from fenris_tpu.solid import MaterialEllipticOperator as JaxMaterialOp
from fenris_tpu_torch.assembly.local import tabulate
from fenris_tpu_torch.mesh import Mesh
from fenris_tpu_torch.mesh import procedural as TP
from fenris_tpu_torch.mesh.convert import convert_mesh
from fenris_tpu_torch.operators import LaplaceOperator
from fenris_tpu_torch.quadrature import canonical_stiffness
from fenris_tpu_torch.reference_elements import QUAD4, element
from fenris_tpu_torch.solid import LameParameters, LinearElasticMaterial, MaterialEllipticOperator

PI = np.pi
REFERENCE = Path(__file__).parent / "reference_values"
EXAMPLE = Path(__file__).parents[1] / "examples" / "poisson2d_torch.py"
ELEMENTS_2D = ["quad4", "quad8", "quad9", "tri3", "tri6"]
ROUTES = {"csr": TF.solve_poisson, "assembled": TF.solve_poisson_assembled,
          "matrix_free": TF.solve_poisson_matrix_free}
# the reference gates (tests/test_convergence.py:28-78): rule and error rule by element
GATE = {
    "quad4": (lambda q: q.quadrilateral_gauss(2), lambda q: q.quadrilateral_gauss(6)),
    "quad9": (lambda q: q.quadrilateral_gauss(2), lambda q: q.quadrilateral_gauss(6)),
    "tri3": (lambda q: q.total_order.triangle(0), lambda q: q.total_order.triangle(6)),
    "tri6": (lambda q: q.total_order.triangle(2), lambda q: q.total_order.triangle(6)),
}


def torch_mesh(name, res):
    base = (TP.create_unit_square_uniform_tri_mesh_2d if name.startswith("tri") else
            TP.create_unit_square_uniform_quad_mesh_2d)(res)
    return base if name in ("tri3", "quad4") else convert_mesh(base, name)


def jax_mesh(name, res):
    base = (JP.create_unit_square_uniform_tri_mesh_2d if name.startswith("tri") else
            JP.create_unit_square_uniform_quad_mesh_2d)(res)
    return base if name in ("tri3", "quad4") else jax_convert(base, name)


# -- the 2D MMS problem (tests/mms_common.py:17-30) ------------------------------------------


def u_exact(x):
    return torch.sin(PI * x[0]) * torch.sin(PI * x[1])


def u_exact_grad(x):
    return PI * torch.stack([torch.cos(PI * x[0]) * torch.sin(PI * x[1]), torch.sin(PI * x[0]) * torch.cos(PI * x[1])])


def source(x, p):
    return 2.0 * PI * PI * u_exact(x)


def jax_u_exact(x):
    return jnp.sin(PI * x[0]) * jnp.sin(PI * x[1])


def jax_u_exact_grad(x):
    return PI * jnp.array([jnp.cos(PI * x[0]) * jnp.sin(PI * x[1]), jnp.sin(PI * x[0]) * jnp.cos(PI * x[1])])


def jax_source(x, p):
    return 2.0 * PI * PI * jax_u_exact(x)


def dirichlet_nodes(points):
    """Nodes with ||x - 0.5||_inf > 0.4999 (poisson_mms_common.rs:122-135)."""
    return np.flatnonzero(np.abs(points - 0.5).max(axis=1) > 0.4999)


# -- meshes -------------------------------------------------------------------------------------


@pytest.mark.parametrize("res", [1, 3, 6])
def test_unit_square_meshes_match_jax(res):
    for name in ("quad4", "tri3"):
        tm, jm = torch_mesh(name, res), jax_mesh(name, res)
        assert tm.element is element(name)
        np.testing.assert_array_equal(tm.cells, np.asarray(jm.cells))
        assert np.abs(tm.points - np.asarray(jm.points)).max() <= 1e-15
        np.testing.assert_array_equal(tm.diameters(), jm.diameters())


def test_rectangular_quad_mesh_matches_jax():
    tm = TP.create_rectangular_uniform_quad_mesh_2d(0.3, 2, 3, 2, top_left=(1.0, 2.0))
    jm = JP.create_rectangular_uniform_quad_mesh_2d(0.3, 2, 3, 2, top_left=(1.0, 2.0))
    np.testing.assert_array_equal(tm.cells, np.asarray(jm.cells))
    assert np.abs(tm.points - np.asarray(jm.points)).max() <= 1e-15
    empty = TP.create_rectangular_uniform_quad_mesh_2d(1.0, 0, 2, 2)
    assert empty.num_cells == 0 and empty.points.shape == (0, 2)


@pytest.mark.parametrize("shape", ["convex", "concave"])
def test_split_into_triangles_matches_jax(shape):
    """Convex quads split along (0, 2); the quads around a centre node pulled towards a corner are
    concave there and split at that corner."""
    base = TP.create_unit_square_uniform_quad_mesh_2d(2)
    pts = base.points + rng(2).uniform(-0.05, 0.05, base.points.shape)
    if shape == "concave":
        pts[4] = (0.12, 0.9)  # the centre node, inside the top-left quad's triangle (0, 0.5), (0.5, 1), (0, 1)
    tm = Mesh(pts, base.cells, QUAD4).split_into_triangles()
    jm = JaxMesh(pts, base.cells, jax_element("quad4")).split_into_triangles()
    np.testing.assert_array_equal(tm.cells, np.asarray(jm.cells))
    convex_split = base.cells[:, [0, 1, 2, 0, 2, 3]].reshape(-1, 3)
    assert np.array_equal(tm.cells, convex_split) == (shape == "convex")
    with pytest.raises(ValueError, match="quad4"):
        tm.split_into_triangles()


# -- Poisson ------------------------------------------------------------------------------------


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("name", list(GATE))
def test_poisson2d_mms_gate(name, route):
    """The reference's gate at resolutions 1-8 (tests/test_convergence.py's truncated sweep)."""
    reference = json.loads((REFERENCE / f"poisson2d_mms_{name}_summary.json").read_text())
    rule, err_rule = (f(TQ) for f in GATE[name])
    resolutions, l2, h1 = [], [], []
    for res in (1, 2, 4, 8):
        mesh = torch_mesh(name, res)
        r = ROUTES[route](mesh, rule, err_rule, source, u_exact, u_exact_grad, dirichlet_nodes(mesh.points),
                          dtype=torch.float64, device="cpu")
        resolutions.append(float(mesh.diameters().max()))
        l2.append(r.l2_error)
        h1.append(r.h1_seminorm_error)
    np.testing.assert_allclose(resolutions, reference["resolutions"][:4], rtol=1e-12)
    for ours, ref in zip(l2, reference["L2_errors"]):
        assert abs(ours - ref) <= 0.01 * abs(ref), (ours, ref)
    for ours, ref in zip(h1, reference["H1_seminorm_errors"]):
        assert abs(ours - ref) <= 0.01 * abs(ref), (ours, ref)


def test_solve_poisson_matches_jax():
    """The CSR route against JAX's ``solve_poisson`` on a res-4 tri6 mesh, f64."""
    jm, tm = jax_mesh("tri6", 4), torch_mesh("tri6", 4)
    nd = dirichlet_nodes(tm.points)
    ref = JF.solve_poisson(jm, JQ.total_order.triangle(2), JQ.total_order.triangle(6), jax_source, jax_u_exact,
                           jax_u_exact_grad, nd)
    got = TF.solve_poisson(tm, TQ.total_order.triangle(2), TQ.total_order.triangle(6), source, u_exact, u_exact_grad,
                           nd, dtype=torch.float64, device="cpu")
    assert rel_err(np.asarray(ref.u), got.u) <= 1e-10
    assert abs(got.l2_error - ref.l2_error) <= 1e-10 * ref.l2_error
    assert abs(got.h1_seminorm_error - ref.h1_seminorm_error) <= 1e-10 * ref.h1_seminorm_error
    assert got.cg_iterations == ref.cg_iterations


def test_solve_poisson_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    mesh = torch_mesh("quad4", 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TF.solve_poisson(mesh, TQ.quadrilateral_gauss(2), TQ.quadrilateral_gauss(6), source)


@pytest.mark.parametrize("matrix_free", [False, True])
def test_poisson2d_example_runs(matrix_free, capsys):
    """examples/poisson2d_torch.py at res 4 on the CPU: it prints dofs, CG iterations and errors."""
    spec = importlib.util.spec_from_file_location("poisson2d_torch", EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    result = example.main(4, matrix_free=matrix_free, device="cpu", dtype=torch.float64)
    out = capsys.readouterr().out
    assert "dofs:          25" in out and "CG iterations:" in out
    assert abs(result.l2_error / 0.030180169603514505 - 1) <= 0.01  # poisson2d_mms_quad4_summary.json at res 4


# -- quadrature ---------------------------------------------------------------------------------


@pytest.mark.parametrize("pieces", [1, 2, 5])
def test_subdivided_rules_match_jax(pieces):
    for t, j in ((TQ.subdivide_univariate(TQ.gauss(3), pieces), JQ.subdivide.subdivide_univariate(JQ.gauss(3), pieces)),
                 (TQ.subdivide_triangle(TQ.total_order.triangle(2), pieces),
                  JQ.subdivide.subdivide_triangle(JQ.total_order.triangle(2), pieces))):
        assert t.points.shape == j.points.shape
        assert np.abs(t.points - j.points).max() <= 1e-15 and np.abs(t.weights - j.weights).max() <= 1e-15
    with pytest.raises(ValueError):
        TQ.subdivide_triangle(TQ.total_order.triangle(2), 0)


# -- the element-stiffness kernel at d = 2 ------------------------------------------------------


def operator2d(kind):
    if kind == "laplace":
        return (JaxLaplace(), None), (LaplaceOperator(), None)
    return ((JaxMaterialOp(JaxLinear(), dim=2), JaxLame(MU, LAM)),
            (MaterialEllipticOperator(LinearElasticMaterial(), dim=2), LameParameters(MU, LAM)))


def element_coordinates_2d(name, seed=0):
    """Geometry coordinates ``[E, m, 2]`` of a res-3 square of the element, every node moved by up to
    10% of a cell (non-affine quads)."""
    mesh = torch_mesh(name, 3)
    pts = mesh.points + rng(seed).uniform(-0.033, 0.033, mesh.points.shape)
    return pts[mesh.cells[:, : element(name).geometry.num_nodes]]


@pytest.mark.parametrize("kind", ["linear", "laplace"])
@pytest.mark.parametrize("name", ["quad4", "quad9", "tri3", "tri6"])
def test_stiffness_plain_and_kernel_emulation_match_jax_pairs_2d(name, kind):
    """s = 2 (linear elasticity) and s = 1, f64."""
    X = element_coordinates_2d(name)
    (jop, jp), (op, params) = operator2d(kind)
    jtab = jlocal.tabulate(jax_element(name), JQ.canonical_stiffness(name))
    tab = tabulate(element(name), canonical_stiffness(name))
    ref = np.asarray(jlocal.assemble_element_elliptic_matrices_pairs(jnp.asarray(X), None, jop, jp, jtab,
                                                                     pallas=False))
    got = tsk.stiffness_pairs_plain(torch.as_tensor(X), op, params, tab)
    assert rel_err(ref, got) <= 1e-12
    assert rel_err(ref, kernel_emulation(X, op, params, tab)) <= 1e-12


def test_stiffness_kernel_takes_every_2d_element_in_one_chunk():
    """Every 2D element's gradient table fits one block at s = 1 and 2, built once (no point chunks), as
    many blocks an SM as its launch bound asks for; quad8's emulation against the plain version."""
    for name in ELEMENTS_2D:
        tab = tabulate(element(name), canonical_stiffness(name))
        q, m, d = tab.geo_dphi.shape
        assert d == 2
        for kind in ("linear", "laplace"):
            op, params = operator2d(kind)[1]
            assert tsk._fits(op, tab), (name, kind)
            lay = tsk.launch_layout(op, params, tab)
            assert lay["form"] == ("scalar" if kind == "laplace" else "isotropic") and lay["tile"] > 0
            assert 0 < lay["shared_bytes"] <= tsk._MAX_SMEM and lay["blocks_per_sm"] >= lay["launch_bound"], lay
        assert tsk._smem_bytes(m, tab.dphi.shape[1], q, d) == 4 * (q * ((2 * tab.dphi.shape[1]) | 1) * 32 + 2 * m * 32
                                                                 + (5 * 32 if m == 3 else 0))
    X = element_coordinates_2d("quad8", seed=1)
    op, params = operator2d("linear")[1]
    tab = tabulate(element("quad8"), canonical_stiffness("quad8"))
    ref = tsk.stiffness_pairs_plain(torch.as_tensor(X), op, params, tab)
    assert rel_err(ref, kernel_emulation(X, op, params, tab)) <= 1e-12


def test_stiffness_kernel_tables_are_copied_once_per_content():
    """The wrapper's device tables: one copy per table content and device, shared by later calls."""
    tab = tabulate(element("tri6"), canonical_stiffness("tri6"))
    op, params = operator2d("linear")[1]
    tables = tsk._constants(op, params, tab)[0]
    first = tsk.device_tables(tables, torch.device("cpu"))
    assert tsk.device_tables(tables.copy(), torch.device("cpu")) is first
    assert first.dtype == torch.float32 and torch.equal(first, torch.as_tensor(tables, dtype=torch.float32))
    other = tsk._constants(op, params, tabulate(element("tri3"), canonical_stiffness("tri3")))[0]
    assert tsk.device_tables(other, torch.device("cpu")) is not first
