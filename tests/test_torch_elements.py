"""Port parity: the 3D higher-order elements, their rules, meshes and the Poisson gate on them.

The JAX package (``fenris_tpu``, f64 on the CPU) and the port run on the
same numpy inputs: tabulations of every element at its canonical rules,
the quadrature tables and collapsed rules, the BCC tet meshes and the
order-elevated meshes (tet10/tet20/hex20/hex27), their diameters, and
``solve_poisson_assembled`` on tet10 and hex20.  The MMS gate runs the
port alone against ``tests/reference_values/poisson3d_mms_*_summary.json``
at the first two resolutions, with sources written in torch.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import LAM, MU, rel_err, rng

import fenris_tpu.fem as JF
import fenris_tpu.quadrature as JQ
from fenris_tpu.elasticity import HyperelasticModel as JaxModel
from fenris_tpu.assembly.local import tabulate as jax_tabulate
from fenris_tpu.mesh import procedural as JP
from fenris_tpu.mesh.convert import convert_mesh as jax_convert
from fenris_tpu.mesh.refinement import refine_uniformly as jax_refine
from fenris_tpu.reference_elements import element as jax_element
from fenris_tpu.solid import LameParameters as JaxLame
from fenris_tpu.solid import NeoHookeanMaterial as JaxNeoHookean
import fenris_tpu_torch.fem as TF
import fenris_tpu_torch.quadrature as TQ
from fenris_tpu_torch.assembly.local import tabulate
from fenris_tpu_torch.interop import hyperelastic_model_from_arrays, mesh_from_arrays
from fenris_tpu_torch.mesh import procedural as TP
from fenris_tpu_torch.mesh.convert import convert_mesh
from fenris_tpu_torch.mesh.refinement import refine_uniformly
from fenris_tpu_torch.reference_elements import ELEMENTS, element

PI = np.pi
REFERENCE = Path(__file__).parent / "reference_values"
ALL_ELEMENTS = ["seg2", "seg3", "tri3", "tri6", "quad4", "quad8", "quad9",
                "tet4", "tet10", "tet20", "hex8", "hex20", "hex27"]
ELEMENTS_3D = ["tet4", "tet10", "tet20", "hex20", "hex27"]
# the reference gate's rules (tests/test_convergence.py:95-138): (element, rule, error rule)
GATE = {
    "tet4": (lambda q: q.total_order.tetrahedron(0), lambda q: q.total_order.tetrahedron(6)),
    "tet10": (lambda q: q.total_order.tetrahedron(2), lambda q: q.total_order.tetrahedron(6)),
    "tet20": (lambda q: q.total_order.tetrahedron(4), lambda q: q.total_order.tetrahedron(6)),
    "hex20": (lambda q: q.hexahedron_gauss(4), lambda q: q.hexahedron_gauss(6)),
    "hex27": (lambda q: q.hexahedron_gauss(4), lambda q: q.hexahedron_gauss(6)),
}


# the base (corner) element and unit-cube or unit-square producer of each element family
BASE = {"tet": ("tet4", "create_unit_box_uniform_tet_mesh_3d"), "hex": ("hex8", "create_unit_box_uniform_hex_mesh_3d"),
        "tri": ("tri3", "create_unit_square_uniform_tri_mesh_2d"),
        "quad": ("quad4", "create_unit_square_uniform_quad_mesh_2d")}


def base_element(name):
    return BASE[name.rstrip("0123456789")][0]


def torch_mesh(name, res):
    base_name, producer = BASE[name.rstrip("0123456789")]
    base = getattr(TP, producer)(res)
    return base if name == base_name else convert_mesh(base, name)


def jax_mesh(name, res):
    base_name, producer = BASE[name.rstrip("0123456789")]
    base = getattr(JP, producer)(res)
    return base if name == base_name else jax_convert(base, name)


# -- the MMS problem (tests/mms_common.py:32-54) ---------------------------------------------


def u_exact(x):
    return torch.sin(PI * x[0]) * torch.sin(PI * x[1]) * torch.sin(PI * x[2])


def u_exact_grad(x):
    s, c = torch.sin(PI * x), torch.cos(PI * x)
    return PI * torch.stack([c[0] * s[1] * s[2], s[0] * c[1] * s[2], s[0] * s[1] * c[2]])


def source(x, p):
    return 3.0 * PI * PI * u_exact(x)


def jax_u_exact(x):
    return jnp.sin(PI * x[0]) * jnp.sin(PI * x[1]) * jnp.sin(PI * x[2])


def jax_u_exact_grad(x):
    s, c = jnp.sin(PI * x), jnp.cos(PI * x)
    return PI * jnp.array([c[0] * s[1] * s[2], s[0] * c[1] * s[2], s[0] * s[1] * c[2]])


def jax_source(x, p):
    return 3.0 * PI * PI * jax_u_exact(x)


def dirichlet_nodes(points):
    return np.flatnonzero(np.abs(points - 0.5).max(axis=1) > 0.4999)


# -- elements and rules ------------------------------------------------------------------


@pytest.mark.parametrize("name", ALL_ELEMENTS)
def test_element_tables_and_tabulations_match_jax(name):
    """Nodes, topology, geometry element and the tabulations at both canonical rules."""
    te, je = element(name), jax_element(name)
    np.testing.assert_array_equal(te.nodes, je.nodes)
    assert (te.num_vertices, te.degree, te.edges, te.faces, te.geometry.name) == \
        (je.num_vertices, je.degree, je.edges, je.faces, je.geometry.name)
    for which in ("canonical_mass", "canonical_stiffness"):
        trule, jrule = getattr(TQ, which)(name), getattr(JQ, which)(name)
        assert np.abs(trule.points - jrule.points).max() <= 1e-14
        assert np.abs(trule.weights - jrule.weights).max() <= 1e-14
        t, j = tabulate(te, trule), jax_tabulate(je, jrule)
        for field in ("phi", "dphi", "geo_phi", "geo_dphi"):
            assert np.abs(getattr(t, field) - getattr(j, field)).max() <= 1e-12, field
    phi, _ = te.tabulate(te.nodes)  # a Lagrange basis: the identity at the nodes
    assert np.abs(phi - np.eye(te.num_nodes)).max() <= 1e-12
    assert sorted(ELEMENTS) == sorted(ALL_ELEMENTS)


@pytest.mark.parametrize("domain", ["tri", "quad", "tet", "hex"])
def test_total_order_rules_match_jax(domain):
    """Tabulated strengths and, past the tables, the collapsed (tri, tet) or Gauss (quad, hex) rules."""
    fn = {"tri": "triangle", "quad": "quadrilateral", "tet": "tetrahedron", "hex": "hexahedron"}[domain]
    for strength in range(0, 15):
        t, j = getattr(TQ.total_order, fn)(strength), getattr(JQ.total_order, fn)(strength)
        assert t.points.shape == j.points.shape, strength
        assert np.abs(t.points - j.points).max() <= 1e-14 and np.abs(t.weights - j.weights).max() <= 1e-14
    assert TQ.polyquad.available_strengths(domain) == JQ.polyquad.available_strengths(domain)


# -- meshes --------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ELEMENTS_3D + ["tri6", "quad8", "quad9"])
def test_procedural_and_converted_meshes_match_jax(name):
    tm, jm = torch_mesh(name, 2), jax_mesh(name, 2)
    np.testing.assert_array_equal(tm.cells, jm.cells)
    assert np.abs(tm.points - jm.points).max() <= 1e-15
    np.testing.assert_array_equal(tm.diameters(), jm.diameters())
    # the corner vertices keep their indices
    base = torch_mesh(base_element(name), 2)
    np.testing.assert_array_equal(tm.cells[:, : base.cells.shape[1]], base.cells)
    carried = mesh_from_arrays(np.asarray(jm.points), np.asarray(jm.cells), jm.element.name)
    assert carried.element is element(name) and np.array_equal(carried.cells, tm.cells)


def test_rectangular_tet_mesh_matches_jax():
    tm = TP.create_rectangular_uniform_tet_mesh(0.5, 2, 1, 3, 2)
    jm = JP.create_rectangular_uniform_tet_mesh(0.5, 2, 1, 3, 2)
    np.testing.assert_array_equal(tm.cells, jm.cells)
    assert np.abs(tm.points - jm.points).max() <= 1e-15
    # its refinement (tet4 refines since the port has tri3/quad4/tet4 refinement) equals JAX's too
    rm, rjm = refine_uniformly(tm), jax_refine(jm)
    np.testing.assert_array_equal(rm.cells, rjm.cells)
    np.testing.assert_array_equal(rm.points, rjm.points)


def test_tet10_model_carried_across_matches_jax():
    """A Neo-Hookean model on a tet10 mesh (subparametric geometry, canonical rule) carried across
    with ``element=``: residual and Hessian action against the JAX model, f64."""
    jmesh = jax_mesh("tet10", 1)
    fixed = np.flatnonzero(np.asarray(jmesh.points)[:, 2] < 1e-12)
    jm = JaxModel(mesh=jmesh, material=JaxNeoHookean(), params=JaxLame(MU, LAM), dirichlet_nodes=fixed,
                  body_force=lambda x, p: jnp.array([0.0, 0.0, -4.0], dtype=x.dtype), dtype=jnp.float64)
    tm = hyperelastic_model_from_arrays(np.asarray(jmesh.points), np.asarray(jmesh.cells), MU, LAM, fixed,
                                        np.array([0.0, 0.0, -4.0]), element="tet10", dtype=torch.float64,
                                        device="cpu")
    assert tm.mesh.element is element("tet10") and tm.space.X_geo.shape[1:] == (4, 3)
    g = rng(5)
    u, v = g.uniform(-0.01, 0.01, tm.space.num_dofs), g.standard_normal(tm.space.num_dofs)
    assert rel_err(np.asarray(jm.residual(jnp.asarray(u))), tm.residual(torch.as_tensor(u))) <= 1e-12
    ref = jm.hessian_vector_product(jnp.asarray(u), jnp.asarray(v))
    assert rel_err(np.asarray(ref), tm.hessian_vector_product(torch.as_tensor(u), torch.as_tensor(v))) <= 1e-12


# -- Poisson -------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tet10", "hex20"])
def test_poisson_assembled_matches_jax(name):
    tm, jm = torch_mesh(name, 2), jax_mesh(name, 2)
    nd = dirichlet_nodes(tm.points)
    rule, err = GATE[name]
    kw = dict(rel_tolerance=1e-12)
    ref = JF.solve_poisson_assembled(jm, rule(JQ), err(JQ), jax_source, jax_u_exact, jax_u_exact_grad, nd, **kw)
    got = TF.solve_poisson_assembled(tm, rule(TQ), err(TQ), source, u_exact, u_exact_grad, nd,
                                     dtype=torch.float64, device="cpu", **kw)
    assert rel_err(np.asarray(ref.u), got.u) <= 1e-8
    assert abs(got.l2_error - ref.l2_error) <= 1e-8 * ref.l2_error
    assert abs(got.h1_seminorm_error - ref.h1_seminorm_error) <= 1e-8 * ref.h1_seminorm_error
    assert got.cg_iterations == ref.cg_iterations


@pytest.mark.parametrize("name", ELEMENTS_3D)
def test_poisson_mms_gate_truncated(name):
    """The reference's gate (tests/test_convergence.py:95-138) at resolutions 1-2, on the assembled
    route with sparse deltas in the block-ELL remainder (min_fill 0.05, as on the card), and the
    matrix-free route's solution against it at the last resolution."""
    reference = json.loads((REFERENCE / f"poisson3d_mms_{name}_summary.json").read_text())
    rule, err = GATE[name]
    diam, l2, h1 = [], [], []
    for res in (1, 2):
        mesh = torch_mesh(name, res)
        nd = dirichlet_nodes(mesh.points)
        r = TF.solve_poisson_assembled(mesh, rule(TQ), err(TQ), source, u_exact, u_exact_grad, nd,
                                       min_fill=0.05, dtype=torch.float64, device="cpu")
        diam.append(float(mesh.diameters().max()))
        l2.append(r.l2_error)
        h1.append(r.h1_seminorm_error)
    np.testing.assert_allclose(diam, reference["resolutions"][:2], rtol=1e-12)
    for ours, ref in zip(l2 + h1, reference["L2_errors"][:2] + reference["H1_seminorm_errors"][:2]):
        assert abs(ours - ref) <= 0.01 * abs(ref), (ours, ref)
    mf = TF.solve_poisson_matrix_free(mesh, rule(TQ), err(TQ), source, None, None, nd,
                                      dtype=torch.float64, device="cpu")
    assert rel_err(r.u, mf.u) <= 1e-8


# -- the small API gaps: Gauss-Lobatto, prism and pyramid rules, Rule.integrate, phi/dphi, has_energy ---------------


def test_gauss_lobatto_and_integrate_match_jax():
    for n in (2, 3, 4, 7, 12):
        t, j = TQ.gauss_lobatto(n), JQ.gauss_lobatto(n)
        np.testing.assert_array_equal(t.weights, j.weights)
        np.testing.assert_array_equal(t.points, j.points)
        assert t.points[0, 0] == -1.0 and t.points[-1, 0] == 1.0
        f = lambda p: p[0] ** (2 * n - 3) + p[0] ** (2 * n - 4)  # noqa: E731
        assert t.integrate(f) == j.integrate(f)
        assert abs(t.integrate(f) - 2.0 / (2 * n - 3)) < 1e-13  # exact to degree 2n - 3
    with pytest.raises(ValueError):
        TQ.gauss_lobatto(1)


@pytest.mark.parametrize("domain", ["pri", "prism", "pyr", "pyramid", "segment", "tri", "quad", "tet", "hex"])
def test_prism_pyramid_and_for_domain_match_jax(domain):
    """Tabulated strengths and the collapsed prism and pyramid rules past the tables, bitwise."""
    for strength in (0, 3, 10, 25):
        t, j = TQ.total_order.for_domain(domain, strength), JQ.total_order.for_domain(domain, strength)
        np.testing.assert_array_equal(t.weights, j.weights)
        np.testing.assert_array_equal(t.points, j.points)
    if domain in ("pri", "pyr"):
        fn = {"pri": "prism_collapsed", "pyr": "pyramid_collapsed"}[domain]
        for strength in (1, 4, 9):
            t, j = getattr(TQ.simplex, fn)(strength), getattr(JQ.simplex, fn)(strength)
            np.testing.assert_array_equal(t.weights, j.weights)
            np.testing.assert_array_equal(t.points, j.points)
            # x^a z^b monomials integrate exactly: the volumes (prism 4, pyramid 8/3) at degree 0
            vol = 4.0 if domain == "pri" else 8.0 / 3.0
            assert abs(t.integrate(lambda p: 1.0) - vol) < 1e-13


@pytest.fixture(scope="module")
def jax_bases():
    """Points ``[2, 5, d]`` per element and JAX's ``phi``/``dphi`` there, all elements in one trace."""
    pts = {name: rng(11).uniform(-1.0, 1.0, size=(2, 5, element(name).ref_dim)) for name in ALL_ELEMENTS}
    ref = jax.jit(lambda p: {n: (jax_element(n).phi(x), jax_element(n).dphi(x)) for n, x in p.items()})(
        {n: jnp.asarray(x) for n, x in pts.items()})
    return pts, ref


@pytest.mark.parametrize("name", ALL_ELEMENTS)
def test_phi_dphi_on_tensors_match_jax(name, jax_bases):
    """``ReferenceElement.phi``/``dphi`` on a batch ``[2, 5, d]`` of points, against JAX's and the host
    tabulation, in f64 and f32."""
    te = element(name)
    xi = jax_bases[0][name]
    phi, dphi = te.phi(torch.as_tensor(xi)), te.dphi(torch.as_tensor(xi))
    assert phi.shape == (2, 5, te.num_nodes) and dphi.shape == (2, 5, te.num_nodes, te.ref_dim)
    ref_phi, ref_dphi = jax_bases[1][name]
    assert np.abs(phi.numpy() - np.asarray(ref_phi)).max() <= 1e-13
    assert np.abs(dphi.numpy() - np.asarray(ref_dphi)).max() <= 1e-12
    tphi, tdphi = te.tabulate(xi.reshape(-1, te.ref_dim))
    assert np.abs(phi.numpy().reshape(tphi.shape) - tphi).max() <= 1e-13
    assert np.abs(dphi.numpy().reshape(tdphi.shape) - tdphi).max() <= 1e-12
    phi32 = te.phi(torch.as_tensor(xi, dtype=torch.float32))
    assert phi32.dtype == torch.float32 and np.abs(phi32.numpy() - phi.numpy()).max() <= 1e-5
    assert te.is_affine == (name in ("seg2", "tri3", "tet4"))


def test_has_energy_matches_jax():
    from fenris_tpu.operators import EllipticOperator as JaxElliptic
    from fenris_tpu.operators import LaplaceOperator as JaxLaplace
    from fenris_tpu.solid import MaterialEllipticOperator as JaxMaterialOperator
    from fenris_tpu_torch.operators import EllipticOperator, LaplaceOperator, operator_from_energy
    from fenris_tpu_torch.solid import MaterialEllipticOperator, NeoHookeanMaterial

    class GOnly(EllipticOperator):
        def g(self, G, params):
            return G

    class JaxGOnly(JaxElliptic):
        def g(self, G, params):
            return G

    assert LaplaceOperator().has_energy() == JaxLaplace().has_energy() is True
    assert GOnly().has_energy() == JaxGOnly().has_energy() is False
    # an energy that needs its parameters still has one (the probe passes params=None)
    assert MaterialEllipticOperator(NeoHookeanMaterial(), dim=3).has_energy() is True
    assert JaxMaterialOperator(JaxNeoHookean(), dim=3).has_energy() is True
    assert operator_from_energy(lambda G, p: (G * G).sum()).has_energy() is True
