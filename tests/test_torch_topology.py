"""Port parity: face elements, mesh topology and transforms, surface geometry and loads, mass matrices,
the element-minor layout, tri3/quad4/tet4 refinement with the tet4 V-cycle, and the SDF meshes.

The JAX package and the port run on the same numpy meshes and inputs;
topology arrays must be equal, float results agree to 1e-12 in f64 and
the V-cycle to 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import LAM, MU, rel_err, rng

from fenris_tpu import quadrature as jq
from fenris_tpu.assembly import global_ as jax_global
from fenris_tpu.assembly import local as jax_local
from fenris_tpu.elasticity import HyperelasticModel as JaxModel
from fenris_tpu.integrate import volume_form as jax_volume_form
from fenris_tpu.mesh import convert as jax_convert
from fenris_tpu.mesh import procedural as jax_procedural
from fenris_tpu.mesh import refinement as jax_refinement
from fenris_tpu.multigrid import GeometricMGPreconditioner as JaxMG
from fenris_tpu.reference_elements import ELEMENTS as JAX_ELEMENTS
from fenris_tpu.solid import LameParameters as JaxLame
from fenris_tpu.solid import LinearElasticMaterial as JaxLinear
from fenris_tpu.solid import MaterialEllipticOperator as JaxOperator
from fenris_tpu.solid import NeoHookeanMaterial as JaxNeoHookean
from fenris_tpu_torch import quadrature as tq
from fenris_tpu_torch.assembly import global_ as torch_global
from fenris_tpu_torch.assembly import local as torch_local
from fenris_tpu_torch.elasticity import HyperelasticModel
from fenris_tpu_torch.integrate import volume_form
from fenris_tpu_torch.mesh import Mesh
from fenris_tpu_torch.mesh import procedural
from fenris_tpu_torch.mesh.refinement import prolongation_for_refinement, refine_uniformly, refine_uniformly_repeat
from fenris_tpu_torch.multigrid import GeometricMGPreconditioner
from fenris_tpu_torch.reference_elements import ELEMENTS
from fenris_tpu_torch.solid import LameParameters, LinearElasticMaterial, MaterialEllipticOperator, NeoHookeanMaterial


def _port(jm) -> Mesh:
    return Mesh(jm.points, jm.cells, ELEMENTS[jm.element.name])


def _jax_mesh(name):
    """A small JAX mesh of each element: boxes and squares at res 2, converted to the higher orders."""
    base = {"hex": jax_procedural.create_unit_box_uniform_hex_mesh_3d(2),
            "tet": jax_procedural.create_unit_box_uniform_tet_mesh_3d(1),
            "qua": jax_procedural.create_unit_square_uniform_quad_mesh_2d(2),
            "tri": jax_procedural.create_unit_square_uniform_tri_mesh_2d(2)}[name[:3]]
    return base if base.element.name == name else jax_convert.convert_mesh(base, name)


def _equal_meshes(got, ref):
    np.testing.assert_array_equal(got.points, ref.points)
    np.testing.assert_array_equal(got.cells, ref.cells)
    assert got.cells.dtype == ref.cells.dtype and got.element.name == ref.element.name


@pytest.mark.parametrize("name", sorted(JAX_ELEMENTS))
def test_face_nodes_match_jax(name):
    fel, jfel = ELEMENTS[name].face_element(), JAX_ELEMENTS[name].face_element()
    assert (fel and fel.name) == (jfel and jfel.name)
    assert ELEMENTS[name].face_nodes() == JAX_ELEMENTS[name].face_nodes()


@pytest.mark.parametrize("name", ["hex8", "hex20", "tet10", "quad9", "tri6"])
def test_boundary_queries_match_jax(name):
    jm = _jax_mesh(name)
    tm = _port(jm)
    for query in ("find_boundary_faces", "find_boundary_cells", "find_boundary_vertices"):
        got, ref = getattr(tm, query)(), getattr(jm, query)()
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == ref.dtype, query
    _equal_meshes(tm.boundary_mesh(), jm.boundary_mesh())
    _equal_meshes(tm.extract_surface_mesh(), jm.extract_surface_mesh())
    keep = rng(2).permutation(tm.num_cells)[: tm.num_cells // 2]
    _equal_meshes(tm.keep_cells(keep), jm.keep_cells(keep))


@pytest.mark.parametrize("name", ["hex8", "tet4"])
def test_boundary_queries_of_an_empty_mesh_match_jax(name):
    """``keep_cells([])``: the face mask is reshaped by the face count, so a mesh without cells gives JAX's
    empty arrays (it raised before)."""
    jm = _jax_mesh(name).keep_cells([])
    tm = _port(_jax_mesh(name)).keep_cells([])
    for query in ("find_boundary_faces", "find_boundary_cells", "find_boundary_vertices"):
        got, ref = getattr(tm, query)(), getattr(jm, query)()
        assert got.shape == ref.shape and got.dtype == ref.dtype and got.size == 0, query


def test_boundary_mesh_of_tet20_raises():
    with pytest.raises(ValueError, match="tet20"):
        _port(_jax_mesh("tet20")).boundary_mesh()


def test_transforms_match_jax():
    jm = _jax_mesh("tet10")
    tm = _port(jm)
    _equal_meshes(tm.transform_points(lambda p: p**2 + 1.0), jm.transform_points(lambda p: p**2 + 1.0))
    _equal_meshes(tm.translate([1.0, -2.0, 0.5]), jm.translate([1.0, -2.0, 0.5]))
    _equal_meshes(tm.scale(3.0), jm.scale(3.0))
    _equal_meshes(tm.with_element("tet10"), jm.with_element("tet10"))
    assert repr(tm) == repr(jm)


@pytest.mark.parametrize("name", ["tri3", "quad4", "tet4"])
def test_refinement_matches_jax(name):
    jm = _jax_mesh(name)
    tm = _port(jm)
    for _ in range(2):
        parents, weights = prolongation_for_refinement(tm)
        jparents, jweights = jax_refinement.prolongation_for_refinement(jm)
        np.testing.assert_array_equal(parents, jparents)
        np.testing.assert_array_equal(weights, jweights)
        assert parents.dtype == jparents.dtype
        tm, jm = refine_uniformly(tm), jax_refinement.refine_uniformly(jm)
        _equal_meshes(tm, jm)


class _Circle:
    """A signed distance function of the JAX package's duck type: ``bounding_box``, ``eval``, ``gradient``."""

    center, radius = np.array([0.3, -0.2]), 0.7

    def bounding_box(self):
        return self.center - self.radius, self.center + self.radius

    def eval(self, p):
        return np.linalg.norm(p - self.center, axis=1) - self.radius

    def gradient(self, p):
        d = p - self.center
        return d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("fn", ["voxelize_sdf_2d", "approximate_quad_mesh_for_sdf_2d",
                                "approximate_triangle_mesh_for_sdf_2d"])
def test_sdf_meshes_match_jax(fn):
    _equal_meshes(getattr(procedural, fn)(_Circle(), 0.13), getattr(jax_procedural, fn)(_Circle(), 0.13))


def test_voxelized_bounding_box_matches_jax():
    args = ([-0.4, 0.1], [1.3, 0.9], 0.07)
    _equal_meshes(procedural.voxelize_bounding_box_2d(*args), jax_procedural.voxelize_bounding_box_2d(*args))
    with pytest.raises(ValueError, match="positive"):
        procedural.voxelize_bounding_box_2d([0, 0], [1, 1], 0.0)


def test_volume_form_of_surface_jacobians_matches_jax():
    """quad4 faces in 3D: sqrt(det(JᵀJ)) at each point of a 3-point Gauss rule, on distorted faces."""
    jm = _jax_mesh("hex8")
    faces = jm.boundary_mesh()
    X = faces.points[faces.cells] + 0.05 * rng(4).standard_normal(faces.cells.shape + (3,))
    tab = torch_local.tabulate(ELEMENTS["quad4"], tq.quadrilateral_gauss(3))
    J = torch_local.jacobians(torch.as_tensor(X), tab.geo_dphi)
    assert tuple(J.shape[-2:]) == (3, 2)
    assert rel_err(jax.jit(jax_volume_form)(jnp.asarray(J.numpy())), volume_form(J)) <= 1e-12


def _geometry(name, seed=5):
    """A distorted mesh of ``name`` and its geometry nodes ``[E, m, d]``."""
    jm = _jax_mesh(name)
    m = ELEMENTS[name].geometry.num_nodes
    X = jm.points[jm.cells[:, :m]]
    return jm, X + 0.02 * rng(seed).standard_normal(X.shape)


@pytest.mark.parametrize("density", ["scalar", "per_element"])
@pytest.mark.parametrize("s", [1, 3])
def test_mass_matrices_match_jax(density, s):
    jm, X = _geometry("hex20")
    rho = 2.5 if density == "scalar" else rng(6).uniform(1.0, 3.0, jm.num_cells)
    jtab = jax_local.tabulate(jm.element, jq.hexahedron_gauss(3))
    tab = torch_local.tabulate(ELEMENTS["hex20"], tq.hexahedron_gauss(3))
    ref = jax.jit(lambda X, rho: jax_local.assemble_element_mass_matrices(X, rho, s, jtab))(jnp.asarray(X),
                                                                                            jnp.asarray(rho))
    got = torch_local.assemble_element_mass_matrices(torch.as_tensor(X), rho, s, tab)
    assert tuple(got.shape) == (jm.num_cells, 20 * s, 20 * s)
    assert rel_err(ref, got) <= 1e-12


def _traction(lib):
    """A traction varying over the face, with a per-face parameter scaling it."""
    if lib is jnp:
        return lambda x, p: p * jnp.stack([x[0] * x[1], 1.0 + x[2], -x[0]])
    return lambda x, p: p * torch.stack([x[0] * x[1], 1.0 + x[2], -x[0]])


def test_surface_source_vectors_match_jax():
    jm = _jax_mesh("tet10")
    faces = jm.boundary_mesh()
    X = jm.points[faces.cells[:, :3]] + 0.01 * rng(7).standard_normal((faces.num_cells, 3, 3))
    p = rng(8).uniform(0.5, 1.5, faces.num_cells)
    jtab = jax_local.tabulate(faces.element, jq.canonical_mass("tri6"))
    tab = torch_local.tabulate(ELEMENTS["tri6"], tq.canonical_mass("tri6"))
    ref = jax.jit(lambda X, p: jax_local.assemble_element_surface_source_vectors(X, _traction(jnp), p, 3, jtab))(
        jnp.asarray(X), jnp.asarray(p))
    got = torch_local.assemble_element_surface_source_vectors(torch.as_tensor(X), _traction(torch), p, 3, tab)
    assert tuple(got.shape) == (faces.num_cells, 18)
    assert rel_err(ref, got) <= 1e-12


def test_surface_traction_load():
    """``tests/test_assembly.py::test_surface_traction_load`` on the port: traction on the top face of a cube
    sums to traction x area and loads only top-face nodes."""
    mesh = procedural.create_unit_box_uniform_hex_mesh_3d(2)
    surf = mesh.boundary_mesh()
    top = np.flatnonzero((np.abs(mesh.points[surf.cells][:, :, 2] - 1.0) < 1e-12).all(axis=1))
    faces = surf.cells[top]
    tab = torch_local.tabulate(surf.element, tq.quadrilateral_gauss(2))
    traction = np.array([0.0, 0.0, -7.5])
    b_el = torch_local.assemble_element_surface_source_vectors(
        torch.as_tensor(mesh.points[faces]), lambda x, p: torch.as_tensor(traction, dtype=x.dtype), None, 3, tab)
    b = torch_global.assemble_vector(b_el, torch.as_tensor(torch_global.element_dof_indices(faces, 3)),
                                     mesh.num_vertices * 3)
    totals = b.numpy().reshape(-1, 3).sum(axis=0)
    assert np.abs(totals - traction).max() < 1e-12  # area = 1
    loaded = np.flatnonzero(np.abs(b.numpy()) > 1e-14) // 3
    assert (np.abs(mesh.points[np.unique(loaded), 2] - 1.0) < 1e-12).all()
    jtab = jax_local.tabulate(JAX_ELEMENTS["quad4"], jq.quadrilateral_gauss(2))
    jb_el = jax.jit(lambda X: jax_local.assemble_element_surface_source_vectors(
        X, lambda x, p: jnp.asarray(traction, dtype=x.dtype), None, 3, jtab))(jnp.asarray(mesh.points[faces]))
    ref = jax_global.assemble_vector(jb_el, jnp.asarray(jax_global.element_dof_indices(faces, 3)),
                                     mesh.num_vertices * 3)
    assert rel_err(ref, b) <= 1e-12


def test_em_layout_matches_jax():
    jm, X = _geometry("tet4")
    u = 0.01 * rng(9).standard_normal((jm.num_cells, 4, 3))
    jtab = jax_local.tabulate(jm.element, jq.canonical_stiffness("tet4"))
    tab = torch_local.tabulate(ELEMENTS["tet4"], tq.canonical_stiffness("tet4"))
    mu = rng(10).uniform(0.5, 1.5, jm.num_cells) * MU
    ref = jax.jit(lambda X, u, mu: jax_local.assemble_element_elliptic_matrices_em(
        X, u, JaxOperator(JaxNeoHookean()), JaxLame(mu, LAM), jtab))(jnp.asarray(X), jnp.asarray(u), jnp.asarray(mu))
    got = torch_local.assemble_element_elliptic_matrices_em(
        torch.as_tensor(X), torch.as_tensor(u), MaterialEllipticOperator(NeoHookeanMaterial()),
        LameParameters(torch.as_tensor(mu), LAM), tab)
    assert tuple(got.shape) == (12, 12, jm.num_cells)
    assert rel_err(ref, got) <= 1e-12


def _fixed(points):
    return np.flatnonzero(np.asarray(points)[:, 0] < 1e-12)


def test_tet4_vcycle_matches_jax():
    """One V-cycle over a two-level tet4 hierarchy (BCC res 1 and its refinement, unbanded) against JAX's."""
    jcoarse = jax_procedural.create_unit_box_uniform_tet_mesh_3d(1)
    jfine = jax_refinement.refine_uniformly_repeat(jcoarse, 1)
    coarse = _port(jcoarse)
    fine = refine_uniformly_repeat(coarse, 1)
    r = rng(11).standard_normal(3 * fine.num_vertices)
    jmodel = JaxModel(mesh=jfine, dirichlet_nodes=_fixed(jfine.points), material=JaxLinear(), params=JaxLame(MU, LAM))
    jmg = JaxMG(jmodel, jcoarse, 1, coarse_iters=4)
    ref = np.asarray(jax.jit(lambda v: jmg(v))(jnp.asarray(r)))
    model = HyperelasticModel(mesh=fine, dirichlet_nodes=_fixed(fine.points), material=LinearElasticMaterial(),
                              params=LameParameters(MU, LAM), dtype=torch.float64, device="cpu")
    got = GeometricMGPreconditioner(model, coarse, 1, coarse_iters=4)(torch.as_tensor(r))
    assert rel_err(ref, got) <= 1e-10
