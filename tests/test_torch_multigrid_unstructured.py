"""Port parity: hex8 refinement, the vectorised RCM and the unstructured geometric multigrid.

The JAX package (``fenris_tpu.mesh.refinement``, ``fenris_tpu.mesh.reorder``,
``fenris_tpu.multigrid``) and the port run in f64 on the same numpy
meshes; the port's models get ``device="cpu"``.  The Newton solve with the
V-cycle runs in the port only, against the port's Jacobi solve (as
``tests/test_multigrid.py`` checks the JAX package), so that no second JAX
solve is compiled.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import LAM, MU, rel_err, rng

from fenris_tpu.elasticity import HyperelasticModel as JaxModel
from fenris_tpu.mesh import Mesh as JaxMesh
from fenris_tpu.mesh.procedural import create_unit_box_uniform_hex_mesh_3d as jax_box
from fenris_tpu.mesh.refinement import prolongation_for_refinement as jax_prolongation
from fenris_tpu.mesh.refinement import refine_uniformly_repeat as jax_refine
from fenris_tpu.mesh.reorder import reverse_cuthill_mckee as jax_rcm
from fenris_tpu.multigrid import GeometricMGPreconditioner as JaxMG
from fenris_tpu.multigrid import rcm_refined_hierarchy as jax_hierarchy
from fenris_tpu.reference_elements import HEX8 as JAX_HEX8
from fenris_tpu.solid import LameParameters as JaxLame
from fenris_tpu.solid import LinearElasticMaterial as JaxLinear
from fenris_tpu_torch.elasticity import HyperelasticModel
from fenris_tpu_torch.mesh import Mesh
from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d as box
from fenris_tpu_torch.mesh.refinement import prolongation_for_refinement, refine_uniformly, refine_uniformly_repeat
from fenris_tpu_torch.mesh.reorder import cuthill_mckee, reorder_mesh, reverse_cuthill_mckee
from fenris_tpu_torch.multigrid import (
    GeometricMGPreconditioner,
    _prolong_unstructured,
    _restrict_unstructured,
    _RestrictPlan,
    rcm_refined_hierarchy,
)
from fenris_tpu_torch.optimize import NEWTON_CONVERGED
from fenris_tpu_torch.reference_elements import QUAD8
from fenris_tpu_torch.solid import LameParameters, LinearElasticMaterial, NeoHookeanMaterial


def _fixed(points):
    return np.flatnonzero(np.asarray(points)[:, 0] < 1e-12)


@pytest.mark.parametrize("levels", [1, 2])
def test_refinement_matches_jax(levels):
    tm, jm = box(2), jax_box(2)
    for _ in range(levels):
        parents, weights = prolongation_for_refinement(tm)
        jparents, jweights = jax_prolongation(jm)
        np.testing.assert_array_equal(parents, jparents)
        np.testing.assert_array_equal(weights, jweights)
        assert parents.dtype == jparents.dtype
        tm, jm = refine_uniformly(tm), jax_refine(jm, 1)
        np.testing.assert_array_equal(tm.points, jm.points)
        np.testing.assert_array_equal(tm.cells, jm.cells)
    np.testing.assert_array_equal(refine_uniformly_repeat(box(2), levels).cells, tm.cells)


def test_refinement_of_unported_elements_raises():
    """Elements without a refinement rule (here quad8) raise the JAX package's ``ValueError``."""
    mesh = Mesh(np.array([[0, 0], [1, 0], [1, 1], [0, 1], [0.5, 0], [1, 0.5], [0.5, 1], [0, 0.5]], float),
                np.array([[0, 1, 2, 3, 4, 5, 6, 7]]), QUAD8)
    for fn in (refine_uniformly, prolongation_for_refinement):
        with pytest.raises(ValueError, match="quad8"):
            fn(mesh)


@pytest.mark.parametrize("kind", ["refined", "relabelled", "components"])
def test_vectorised_rcm_matches_jax(kind):
    tm = refine_uniformly(box(3))
    if kind == "relabelled":
        p = rng(5).permutation(tm.num_vertices)
        inv = np.empty_like(p)
        inv[p] = np.arange(len(p))
        tm = Mesh(tm.points[p], inv[tm.cells], tm.element)
    elif kind == "components":  # two boxes and three vertices in no cell: the seeding of each component
        small = box(2)
        shift = tm.num_vertices + 3
        tm = Mesh(np.concatenate([tm.points, np.zeros((3, 3)), small.points + 2.0]),
                  np.concatenate([tm.cells, small.cells + shift]), tm.element)
    np.testing.assert_array_equal(reverse_cuthill_mckee(tm, device="cpu"), jax_rcm(JaxMesh(tm.points, tm.cells, JAX_HEX8)))


def test_transfers_are_adjoint():
    coarse = box(2)
    parents, weights = prolongation_for_refinement(coarse)
    g = rng(3)
    u_c = torch.as_tensor(g.standard_normal((coarse.num_vertices, 3)))
    r_f = torch.as_tensor(g.standard_normal((len(parents), 3)))
    prolonged = _prolong_unstructured(torch.as_tensor(parents).long(), torch.as_tensor(weights), u_c)
    restricted = _restrict_unstructured(_RestrictPlan(parents, weights, torch.float64, "cpu"), r_f,
                                        coarse.num_vertices)
    lhs, rhs = float((prolonged * r_f).sum()), float((u_c * restricted).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(1.0, abs(lhs))


_JAX_OUT = {}
COARSE_ITERS = 4  # fewer coarse sweeps than the default 40 keep JAX's unrolled V-cycle quick to compile


def _jax_vcycle(r):
    """JAX's V-cycle (refinement ordering) on ``r`` at coarse res 2, two levels, computed once."""
    if not _JAX_OUT:
        coarse = jax_box(2)
        fine = jax_refine(coarse, 2)
        model = JaxModel(mesh=fine, dirichlet_nodes=_fixed(fine.points), material=JaxLinear(),
                         params=JaxLame(MU, LAM))
        mg = JaxMG(model, coarse, 2, coarse_iters=COARSE_ITERS)
        _JAX_OUT["out"] = np.asarray(jax.jit(lambda v: mg(v))(jnp.asarray(r)))
    return _JAX_OUT["out"]


@pytest.mark.parametrize("variant", ["plain", "rcm_banded"])
def test_vcycle_matches_jax(variant):
    """One V-cycle against JAX's.  The RCM/banded one is held against JAX's V-cycle relabeled by the
    hierarchy's permutation (which must be JAX's), the equivalence ``tests/test_multigrid.py`` pins
    between JAX's own two variants: M_rcm(P r) == P M_plain(r)."""
    coarse = box(2)
    n_dofs = 3 * refine_uniformly_repeat(coarse, 2).num_vertices
    r = rng(7).standard_normal(n_dofs)
    ref = _jax_vcycle(r)
    kw = dict(material=LinearElasticMaterial(), params=LameParameters(MU, LAM), dtype=torch.float64, device="cpu")
    if variant == "plain":
        fine = refine_uniformly_repeat(coarse, 2)
        mg = GeometricMGPreconditioner(HyperelasticModel(mesh=fine, dirichlet_nodes=_fixed(fine.points), **kw),
                                       coarse, 2, coarse_iters=COARSE_ITERS)
        got = mg(torch.as_tensor(r))
    else:
        fine, perm = rcm_refined_hierarchy(coarse, 2, device="cpu")
        np.testing.assert_array_equal(perm, jax_hierarchy(jax_box(2), 2)[1])
        dof_perm = (3 * perm[:, None] + np.arange(3)).reshape(-1)
        model = HyperelasticModel(mesh=fine, dirichlet_nodes=_fixed(fine.points), banded=True, banded_r_nodes=1024,
                                  **kw)
        mg = GeometricMGPreconditioner(model, coarse, 2, coarse_iters=COARSE_ITERS, fine_permutation=perm,
                                       banded=True)
        got, ref = mg(torch.as_tensor(r[dof_perm])), ref[dof_perm]
    assert rel_err(ref, got) <= 1e-10


def test_newton_solve_with_mg_matches_jacobi():
    """``tests/test_multigrid.py::test_unstructured_mg_in_newton_solve`` on the port."""
    coarse = box(2)
    fine = refine_uniformly_repeat(coarse, 1)
    kw = dict(mesh=fine, material=NeoHookeanMaterial(), params=LameParameters(384.0, 577.0),
              dirichlet_nodes=_fixed(fine.points), body_force=np.array([0.0, 0.0, -80.0]), dtype=torch.float64,
              device="cpu")
    m_j, m_m = HyperelasticModel(**kw), HyperelasticModel(**kw)
    mg = GeometricMGPreconditioner(m_m, coarse, 1, coarse_iters=30)
    r_j = m_j.solve(tolerance=1e-9)
    r_m = m_m.solve(tolerance=1e-9, preconditioner=mg)
    assert r_j.status == NEWTON_CONVERGED and r_m.status == NEWTON_CONVERGED
    assert float(r_j.residual_norm) < 1e-9 and float(r_m.residual_norm) < 1e-9
    np.testing.assert_allclose(r_m.x.numpy(), r_j.x.numpy(), rtol=0, atol=1e-7)


def test_hierarchy_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rcm_refined_hierarchy(box(1), 1)


@pytest.mark.parametrize("entry", [cuthill_mckee, reverse_cuthill_mckee, reorder_mesh],
                         ids=["cm", "rcm", "reorder_mesh"])
def test_rcm_defaults_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(box(1))
