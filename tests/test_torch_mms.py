"""Port parity: the nonlinear MMS (``solid/mms.py``), the F-based material wrappers, ``operator_from_energy``,
the finite-difference approximations, the structured model's ``internal_forces``/``to_mesh`` and the
cantilever example.

The JAX package and the port run in f64 on the same seeded numpy inputs:
pointwise functions agree to 1e-12, the structured MMS solve at c = 4 to
1e-9 and the cantilever's tip deflection at resolution 1 to 1e-8.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import MATERIALS, MU, LAM, model_pair, rel_err, rng, state

from fenris_tpu.elasticity import HyperelasticModel as JaxModel
from fenris_tpu.mesh import procedural as jax_procedural
from fenris_tpu.operators import operator_from_energy as jax_operator_from_energy
from fenris_tpu.optimize import approximate_gradient_fd as jax_gradient_fd
from fenris_tpu.optimize import approximate_jacobian_fd as jax_jacobian_fd
from fenris_tpu.solid import LameParameters as JaxLame
from fenris_tpu.solid import NeoHookeanMaterial as JaxNeoHookean
from fenris_tpu.solid import lame_from_young_poisson as jax_lame_from_young_poisson
from fenris_tpu.solid.mms import manufactured_body_force as jax_body_force
from fenris_tpu.solid.mms import sine_bubble_displacement as jax_sine_bubble
from fenris_tpu.structured import StructuredHyperelasticModel as JaxStructured
from fenris_tpu_torch.operators import operator_from_energy
from fenris_tpu_torch.optimize import approximate_gradient_fd, approximate_jacobian_fd
from fenris_tpu_torch.solid import LameParameters, NeoHookeanMaterial
from fenris_tpu_torch.solid.mms import manufactured_body_force, sine_bubble_displacement
from fenris_tpu_torch.structured import StructuredHyperelasticModel

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

#: tests/test_mms_nonlinear.py's parameters
PARAMS = (384.614, 576.923)


def test_manufactured_body_force_matches_jax():
    """-Div P of the sine bubble at 20 seeded points of the unit box, and the bubble itself."""
    x = rng(20).uniform(0.0, 1.0, (20, 3))
    jf = jax_body_force(JaxNeoHookean(), JaxLame(*PARAMS), jax_sine_bubble())
    tf = manufactured_body_force(NeoHookeanMaterial(), LameParameters(*PARAMS), sine_bubble_displacement())
    ref = jax.jit(jax.vmap(jf))(jnp.asarray(x))
    got = torch.func.vmap(tf)(torch.as_tensor(x))
    assert rel_err(ref, got) <= 1e-12
    ju, tu = jax_sine_bubble(2.0, (0.1, 0.2, -0.3)), sine_bubble_displacement(2.0, (0.1, 0.2, -0.3))
    assert rel_err(np.stack([np.asarray(ju(jnp.asarray(p))) for p in x]), torch.stack([tu(p) for p in torch.as_tensor(x)])) <= 1e-12


def test_callable_body_force_matches_constant():
    """``tests/test_mms_nonlinear.py::test_callable_body_force_matches_constant`` on the port."""
    kw = dict(cells=(5, 4, 3), spacing=0.25, material=NeoHookeanMaterial(), params=LameParameters(*PARAMS),
              dtype=torch.float64, device="cpu")
    b = np.array([0.3, -0.7, -2.0])
    m0 = StructuredHyperelasticModel(body_force=b, **kw)
    m1 = StructuredHyperelasticModel(body_force=lambda x, p: torch.as_tensor(b, dtype=x.dtype), **kw)
    np.testing.assert_allclose(m1._f_ext.numpy(), m0._f_ext.numpy(), rtol=0, atol=1e-13)


@pytest.mark.parametrize("material", sorted(MATERIALS))
def test_f_based_wrappers_match_jax(material):
    jax_cls, torch_cls = MATERIALS[material]
    g = rng(21)
    F = np.eye(3) + 0.1 * g.standard_normal((4, 3, 3))
    a, b = g.standard_normal((4, 3)), g.standard_normal((4, 3))
    jm, tm = jax_cls(), torch_cls()
    jp, tp = JaxLame(MU, LAM), LameParameters(MU, LAM)
    Ft = torch.as_tensor(F)
    for fn in ("energy_density", "stress"):  # the JAX wrappers take one F at a time: vmapped
        ref = jax.jit(jax.vmap(lambda Fi: getattr(jm, fn)(Fi, jp)))(jnp.asarray(F))
        assert rel_err(ref, getattr(tm, fn)(Ft, tp)) <= 1e-12, fn
    ref = jax.jit(jax.vmap(lambda Fi, ai, bi: jm.stress_contraction(Fi, ai, bi, jp)))(
        jnp.asarray(F), jnp.asarray(a), jnp.asarray(b))
    assert rel_err(ref, tm.stress_contraction(Ft, torch.as_tensor(a), torch.as_tensor(b), tp)) <= 1e-12


def test_operator_from_energy_matches_jax():
    """g and the contraction of a nonquadratic energy, by autodiff on both sides, at seeded gradients."""
    G = 0.3 * rng(22).standard_normal((5, 3, 2))
    jop = jax_operator_from_energy(lambda G, p: p * jnp.sum(G**4) + jnp.sum(G[0] * G[1]), solution_dim=2)
    top = operator_from_energy(lambda G, p: p * torch.sum(G**4) + torch.sum(G[0] * G[1]), solution_dim=2)
    assert top.solution_dim == 2 and top.symmetric
    for fn in ("energy", "g", "contraction"):  # JAX's operator takes one G at a time: vmapped
        ref = jax.jit(jax.vmap(lambda Gi: getattr(jop, fn)(Gi, 1.5)))(jnp.asarray(G))
        assert rel_err(ref, getattr(top, fn)(torch.as_tensor(G), 1.5)) <= 1e-12, fn


def test_fd_approximations_match_jax():
    x = rng(23).uniform(-1.0, 1.0, 4)
    ref = jax_jacobian_fd(lambda v: np.array([v[0] * v[1] + v[2] * v[2] * v[2], v[3] * v[0] * v[0]]), x)
    got = approximate_jacobian_fd(lambda v: torch.stack([v[0] * v[1] + v[2] * v[2] * v[2], v[3] * v[0] * v[0]]), x)
    assert got.shape == (2, 4) and rel_err(ref, got) <= 1e-12
    ref = jax_gradient_fd(lambda v: v[0] * v[1] * v[2] + v[3] * v[3], x)
    got = approximate_gradient_fd(lambda v: v[0] * v[1] * v[2] + v[3] * v[3], x)
    assert got.shape == (4,) and rel_err(ref, got) <= 1e-12


def test_structured_internal_forces_and_to_mesh_match_jax():
    jm, tm = model_pair((3, 2, 4))
    u, _ = state(tm.num_dofs, seed=24)
    got = tm.internal_forces(torch.as_tensor(u))
    assert got.shape == (tm.num_dofs,)
    assert rel_err(jm.internal_forces(jnp.asarray(u)), got) <= 1e-12
    mesh, jmesh = tm.to_mesh(), jm.to_mesh()
    np.testing.assert_array_equal(mesh.points, jmesh.points)
    np.testing.assert_array_equal(mesh.cells, jmesh.cells)
    assert mesh.element.name == "hex8"


def _boundary_mask(c):
    """tests/test_mms_nonlinear.py's full-boundary clamp of a c^3 grid, flat ``[num_nodes * 3]``."""
    m = np.zeros((c + 1,) * 3, dtype=bool)
    m[0], m[-1], m[:, 0], m[:, -1], m[:, :, 0], m[:, :, -1] = (True,) * 6
    return np.repeat(m.reshape(-1), 3)


def test_structured_mms_solve_matches_jax():
    """tests/test_mms_nonlinear.py's Neo-Hookean MMS solve at c = 4: the solution and its L2 error."""
    c = 4
    common = dict(cells=(c, c, c), spacing=1.0 / c, dirichlet_mask=_boundary_mask(c))
    ju = jax_sine_bubble()
    jmodel = JaxStructured(material=JaxNeoHookean(), params=JaxLame(*PARAMS), dtype=jnp.float64,
                           body_force=jax_body_force(JaxNeoHookean(), JaxLame(*PARAMS), ju), **common)
    jres = jmodel.solve(tolerance=1e-11, cg_rel_tolerance=1e-8, max_newton_iterations=20)
    tu = sine_bubble_displacement()
    model = StructuredHyperelasticModel(material=NeoHookeanMaterial(), params=LameParameters(*PARAMS),
                                        dtype=torch.float64, device="cpu",
                                        body_force=manufactured_body_force(NeoHookeanMaterial(),
                                                                           LameParameters(*PARAMS), tu), **common)
    assert rel_err(jmodel._f_ext, model._f_ext) <= 1e-12
    res = model.solve(tolerance=1e-11, cg_rel_tolerance=1e-8, max_newton_iterations=20)
    assert float(res.residual_norm) < 1e-11
    assert rel_err(jres.x, res.x) <= 1e-9
    assert model.l2_error(res.x, tu) == pytest.approx(jmodel.l2_error(jres.x, ju), rel=1e-9)


def test_cantilever_example_matches_jax():
    """examples/hyperelastic_cantilever_torch.py at resolution 1 (two cells, 7 Newton steps) on the CPU in f64
    against the math of examples/hyperelastic_cantilever.py (its model and solve, without the VTU export)."""
    import hyperelastic_cantilever_torch as example

    mesh = jax_procedural.create_rectangular_uniform_hex_mesh(1.0, 2, 1, 1, 1)
    jmodel = JaxModel(mesh=mesh, material=JaxNeoHookean(), params=jax_lame_from_young_poisson(young=5e3, poisson=0.4),
                      dirichlet_nodes=np.flatnonzero(np.abs(mesh.points[:, 0]) < 1e-12),
                      body_force=lambda x, p: jnp.array([0.0, 0.0, -100.0], dtype=x.dtype))
    f0 = float(jnp.linalg.norm(jmodel.residual(jnp.zeros(jmodel.space.num_dofs))))
    jres = jmodel.solve(tolerance=1e-4 * f0, max_newton_iterations=40)
    tip = np.argmax(mesh.points[:, 0])
    ref = np.asarray(jres.x).reshape(-1, 3)[tip]
    res, u, got_tip = example.main(1, device="cpu", dtype=torch.float64)
    assert got_tip == tip and res.status == int(jres.status) == 0
    assert rel_err(ref, u[tip]) <= 1e-8
