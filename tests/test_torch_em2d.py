"""Port parity: the element sweeps and the fused matrix-free model at d = 2.

The port's plain element-minor sweeps (the plain versions of the d = 2
element-sweep kernels) on quad4, quad8, quad9, tri3 and tri6 for the
Neo-Hookean, StVK and linear-elastic materials against JAX's ``local_em``
in f64, op by op (``jax.disable_jit``: tracing its scan over the points
costs seconds an element).  Then the port's fused banded model
(``banded=True, fused_kernels=True``, plain versions on the CPU) on quad9
and tri6 against JAX's unbanded model: f_ext, residual, Jacobi diagonal,
energy and the Hessian action; and its f32 ``solve_mixed`` against JAX's
solution.  The problem is tools/solve_assembled.py's in 2D: Neo-Hookean,
gravity (0, -4), the nodes at x = 0 clamped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import LAM, MATERIALS, MU, rel_err, rng

from fenris_tpu.assembly import local as JL
from fenris_tpu.assembly import local_em as JLE
from fenris_tpu.elasticity import HyperelasticModel as JaxModel
from fenris_tpu.mesh.convert import convert_mesh as jax_convert
from fenris_tpu.mesh.procedural import create_unit_square_uniform_quad_mesh_2d as jax_square
from fenris_tpu.mesh.procedural import create_unit_square_uniform_tri_mesh_2d as jax_tri_square
from fenris_tpu.mesh.reorder import reorder_mesh as jax_reorder_mesh
from fenris_tpu.quadrature.canonical import canonical_stiffness as jax_rule
from fenris_tpu.solid import LameParameters as JaxLame
from fenris_tpu.solid import MaterialEllipticOperator as JaxOp
from fenris_tpu.solid import NeoHookeanMaterial as JaxNeoHookean
from fenris_tpu_torch.assembly import local_em as TLE
from fenris_tpu_torch.assembly.local import tabulate
from fenris_tpu_torch.elasticity import HyperelasticModel as TorchModel
from fenris_tpu_torch.interop import mesh_from_arrays
from fenris_tpu_torch.optimize import NEWTON_CONVERGED
from fenris_tpu_torch.quadrature import canonical_stiffness
from fenris_tpu_torch.reference_elements import element
from fenris_tpu_torch.solid import LameParameters as TorchLame
from fenris_tpu_torch.solid import MaterialEllipticOperator as TorchOp
from fenris_tpu_torch.solid import NeoHookeanMaterial as TorchNeoHookean

ELEMENTS_2D = ["quad4", "quad8", "quad9", "tri3", "tri6"]
BODY = (0.0, -4.0)  # tools/solve_assembled.py's load, in 2D


def jax_square_mesh(name, res):
    base = (jax_tri_square if name.startswith("tri") else jax_square)(res)
    return base if name in ("quad4", "tri3") else jax_convert(base, name)


@pytest.mark.parametrize("material", list(MATERIALS))
@pytest.mark.parametrize("name", ELEMENTS_2D)
def test_2d_sweeps_match_jax(name, material):
    """The element-minor vector and tangent sweeps on 7 perturbed elements of a res-2 square (a ragged
    tile for the kernels' 8 elements), u ~ 1e-2, v ~ N(0, 1), the canonical rule, against JAX in f64."""
    mesh = jax_square_mesh(name, 2)
    g = rng(6)
    m = element(name).geometry.num_nodes
    pts = np.asarray(mesh.points) + g.uniform(-0.05, 0.05, np.asarray(mesh.points).shape)
    cells = np.concatenate([np.asarray(mesh.cells)] * 2)[:7]
    X = np.transpose(pts[cells[:, :m]], (1, 2, 0))
    n = cells.shape[1]
    u, v = g.uniform(-0.01, 0.01, (n, 2, 7)), g.standard_normal((n, 2, 7))
    jtab = JL.tabulate(mesh.element, jax_rule(mesh.element))
    ttab = tabulate(element(name), canonical_stiffness(name))
    Xt, ut, vt = (torch.as_tensor(a) for a in (X, u, v))
    Xj, uj, vj = (jnp.asarray(a) for a in (X, u, v))
    jcls, tcls = MATERIALS[material]
    jop, top = JaxOp(jcls(), dim=2), TorchOp(tcls(), dim=2)
    jp, tp = JaxLame(MU, LAM), TorchLame(MU, LAM)
    with jax.disable_jit():
        f_ref = JLE.assemble_element_elliptic_vectors_em(Xj, uj, jop, jp, jtab)
        hv_ref = JLE.assemble_element_elliptic_tangent_vectors_em(Xj, uj, vj, jop, jp, jtab)
    assert rel_err(f_ref, TLE.assemble_element_elliptic_vectors_em(Xt, ut, top, tp, ttab)) < 1e-12
    assert rel_err(hv_ref, TLE.assemble_element_elliptic_tangent_vectors_em(Xt, ut, vt, top, tp, ttab)) < 1e-12


def _fixed(points):
    return np.flatnonzero(np.asarray(points)[:, 0] < 1e-12)


def _models(name, res, dtype=torch.float64):
    """JAX's unbanded model and the port's fused banded model of the 2D problem on the RCM-reordered
    ``name`` square (the same mesh arrays in both)."""
    jmesh, _ = jax_reorder_mesh(jax_square_mesh(name, res))
    tmesh = mesh_from_arrays(np.asarray(jmesh.points), np.asarray(jmesh.cells), name)
    jm = JaxModel(mesh=jmesh, material=JaxNeoHookean(), params=JaxLame(MU, LAM), dirichlet_nodes=_fixed(tmesh.points),
                  body_force=lambda x, p: jnp.array(BODY, dtype=x.dtype),
                  dtype=jnp.float64 if dtype == torch.float64 else jnp.float32)
    tm = TorchModel(mesh=tmesh, material=TorchNeoHookean(), params=TorchLame(MU, LAM),
                    dirichlet_nodes=_fixed(tmesh.points), body_force=np.asarray(BODY), dtype=dtype, device="cpu",
                    banded=True, fused_kernels=True, banded_r_nodes=1024)
    return jm, tm


@pytest.mark.parametrize("name", ["quad9", "tri6"])
def test_fused_2d_model_matches_jax(name):
    jm, tm = _models(name, 2)
    assert tm._plan.s == 2 and tm._plan.n == tm.mesh.element.num_nodes
    g = rng(8)
    u, v = g.uniform(-0.01, 0.01, tm.space.num_dofs), g.standard_normal(tm.space.num_dofs)
    uj, ut, vt = jnp.asarray(u), torch.as_tensor(u), torch.as_tensor(v)
    # f64, another summation order: roundoff only
    assert rel_err(np.asarray(jm._f_ext), tm._f_ext) < 1e-11
    assert rel_err(np.asarray(jm.residual(uj)), tm.residual(ut)) < 1e-11
    assert rel_err(np.asarray(jm.hessian_diagonal(uj)), tm.hessian_diagonal(ut)) < 1e-11
    assert float(tm.energy(ut)) == pytest.approx(float(jm.energy(uj)), rel=1e-11)
    # forward-mode AD (JAX) against the closed-form tangent of the fused sweep
    assert rel_err(np.asarray(jm.hessian_vector_product(uj, jnp.asarray(v))), tm.hessian_vector_product(ut, vt)) < 1e-11


@pytest.mark.parametrize("name", ["quad9", "tri6"])
def test_fused_2d_solve_mixed_matches_jax(name):
    """The f32 fused model's solve_mixed (f64 outer residual) at res 6 (338 dofs), to 1e-10: JAX's relative
    residual of the solution <= 1e-10, and the displacement within 1e-8 of JAX's f64 solve."""
    jm, _ = _models(name, 6)
    _, tm = _models(name, 6, torch.float32)
    res = tm.solve_mixed(tolerance=1e-10)
    assert res.status == NEWTON_CONVERGED and res.x.dtype == torch.float64
    x = res.x.numpy()
    r0 = float(jnp.linalg.norm(jm.residual(jnp.zeros(jm.space.num_dofs))))
    assert float(jnp.linalg.norm(jm.residual(jnp.asarray(x)))) / r0 <= 1e-10
    jres = jm.solve(tolerance=1e-12, cg_rel_tolerance=1e-10)
    assert rel_err(np.asarray(jres.x), x) < 1e-8
