"""Port parity: the unstructured HyperelasticModel and its assembled solves.

The JAX ``HyperelasticModel`` (f64 or f32 on the CPU) and the port run on
the same mesh, fields and numpy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import LAM, MU, rel_err, rng, to_numpy

import fenris_tpu_torch.ops.dia_sweep as tds
from fenris_tpu.elasticity import HyperelasticModel as JaxModel
from fenris_tpu.mesh.procedural import create_unit_box_uniform_hex_mesh_3d as jax_box
from fenris_tpu.solid import LameParameters as JaxLame
from fenris_tpu.solid import NeoHookeanMaterial as JaxNeoHookean
from fenris_tpu_torch.elasticity import HyperelasticModel as TorchModel
from fenris_tpu_torch.interop import hyperelastic_model_from_arrays
from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d as torch_box
from fenris_tpu_torch.optimize import NEWTON_CONVERGED
from fenris_tpu_torch.solid import LameParameters as TorchLame
from fenris_tpu_torch.solid import NeoHookeanMaterial as TorchNeoHookean

JAX_DTYPES = {torch.float32: jnp.float32, torch.float64: jnp.float64}
BODY = (0.0, 0.0, -4.0)  # tools/solve_assembled.py's load


def _pair(res=3, dtype=torch.float64, body_force=BODY, **kw):
    """The tools/solve_assembled.py model (z = 0 clamped, body force) in JAX and in the port."""
    jmesh, tmesh = jax_box(res), torch_box(res)
    fixed = np.flatnonzero(np.asarray(jmesh.points)[:, 2] < 1e-12)
    jbf = None if body_force is None else (lambda x, p: jnp.array(body_force, dtype=x.dtype))
    jm = JaxModel(mesh=jmesh, material=JaxNeoHookean(), params=JaxLame(MU, LAM), dirichlet_nodes=fixed,
                  body_force=jbf, dtype=JAX_DTYPES[dtype], **kw)
    tm = TorchModel(mesh=tmesh, material=TorchNeoHookean(), params=TorchLame(MU, LAM), dirichlet_nodes=fixed,
                    body_force=None if body_force is None else np.asarray(body_force), dtype=dtype, device="cpu", **kw)
    return jm, tm


def _state(n, seed=0):
    g = rng(seed)
    return g.uniform(-0.01, 0.01, n), g.standard_normal(n)


@pytest.mark.parametrize("chunk_size", [None, 7], ids=["unchunked", "chunked"])
def test_model_operators_match_jax(chunk_size):
    jm, tm = _pair(chunk_size=chunk_size)
    u, v = _state(tm.space.num_dofs)
    uj, ut = jnp.asarray(u), torch.as_tensor(u)
    # f64, another summation order: roundoff only
    assert rel_err(np.asarray(jm._f_ext), tm._f_ext) < 1e-12
    assert rel_err(np.asarray(jm.residual(uj)), tm.residual(ut)) < 1e-12
    assert float(tm.energy(ut)) == pytest.approx(float(jm.energy(uj)), rel=1e-12)
    ref = jm.hessian_vector_product(uj, jnp.asarray(v))
    assert rel_err(np.asarray(ref), tm.hessian_vector_product(ut, torch.as_tensor(v))) < 1e-12
    ref = jm.assemble_hessian_matrices(uj)
    assert rel_err(np.asarray(ref), tm.assemble_hessian_matrices(ut, chunk=chunk_size)) < 1e-12


def test_callable_body_force_matches_jax():
    jm, tm = _pair(body_force=None)
    jm2 = JaxModel(mesh=jm.mesh, material=JaxNeoHookean(), params=JaxLame(MU, LAM),
                   body_force=lambda x, p: jnp.stack([x[0], -2.0 * jnp.ones_like(x[0]), x[2] * x[1]]))
    tm2 = TorchModel(mesh=tm.mesh, material=TorchNeoHookean(), params=TorchLame(MU, LAM), dtype=torch.float64,
                     device="cpu",
                     body_force=lambda x, p: torch.stack([x[0], -2.0 * torch.ones_like(x[0]), x[2] * x[1]]))
    assert rel_err(np.asarray(jm2._f_ext), tm2._f_ext) < 1e-12


@pytest.mark.parametrize("layout", ["dof", "component"])
def test_assembled_operator_is_the_masked_hessian(layout):
    """where(free, A where(free, v, 0), v) == the matrix-free action; Jacobi == JAX's diagonal."""
    jm, tm = _pair(res=4)
    u, v = _state(tm.space.num_dofs, seed=1)
    ut, vt = torch.as_tensor(u), torch.as_tensor(v)
    hvp, inv_diag = tm.assembled_hessian_operator(ut, layout=layout)
    ref = tm.hessian_vector_product(ut, vt)
    jdiag = np.asarray(jm.hessian_diagonal(jnp.asarray(u)))
    N = tm.mesh.num_vertices
    if layout == "component":
        got = hvp(vt.reshape(N, 3).T.contiguous()).T.reshape(-1)
        diag = (1.0 / inv_diag).T.reshape(-1)
    else:
        got, diag = hvp(vt), 1.0 / inv_diag
    # assembly order vs forward-mode AD: f64 roundoff (the JAX test's 1e-11)
    assert rel_err(to_numpy(ref), got) < 1e-11
    assert rel_err(jdiag, diag) < 1e-12
    jhvp, _ = jm.assembled_hessian_operator(jnp.asarray(u))
    assert rel_err(np.asarray(jhvp(jnp.asarray(v))), tm.assembled_hessian_operator(ut)[0](vt)) < 1e-12


def test_residual_and_bands_are_repeatable():
    _, tm = _pair(res=3, chunk_size=5)
    u, _ = _state(tm.space.num_dofs, seed=2)
    ut = torch.as_tensor(u)
    assert torch.equal(tm.residual(ut), tm.residual(ut))
    assert torch.equal(tm.assemble_hessian_block_dia(ut).bands, tm.assemble_hessian_block_dia(ut).bands)


@pytest.mark.parametrize("preconditioner", [None, "jacobi_callable"])
def test_solve_assembled_matches_jax(preconditioner):
    jm, tm = _pair(res=4)
    if preconditioner is None:
        jkw = tkw = {}
    else:
        # a u-independent callable: node-major CG on the dof-layout operator
        d = np.array(jm.hessian_diagonal(jnp.zeros(jm.space.num_dofs)))
        jkw = dict(preconditioner=lambda r: r / jnp.asarray(d))
        tkw = dict(preconditioner=lambda r: r / torch.as_tensor(d))
    rj = jm.solve(tolerance=1e-9, assembled=True, **jkw)
    history = []
    rt = tm.solve(tolerance=1e-9, assembled=True, callback=lambda k, fn, cg: history.append((k, fn, cg)), **tkw)
    assert rt.status == NEWTON_CONVERGED == int(rj.status)
    assert rt.iterations == int(rj.iterations)
    assert rt.residual_norm <= 1e-9
    # converged solutions: f64 CG/Newton paths agree far below the tolerance
    assert rel_err(np.asarray(rj.x), rt.x) < 1e-8
    assert [k for k, _, _ in history] == list(range(rt.iterations + 1))
    assert history[0][2] is None and all(cg.num_iterations > 0 for _, _, cg in history[1:])


def test_solve_mixed_assembled_matches_jax():
    jm, tm = _pair(res=4, dtype=torch.float32)
    rj = jm.solve_mixed(tolerance=1e-10, assembled=True)
    before = tds.dia_sweep.launches
    rt = tm.solve_mixed(tolerance=1e-10, assembled=True)
    assert tds.dia_sweep.launches == before  # CPU: the plain band sweep
    assert rt.status == NEWTON_CONVERGED == int(rj.status)
    assert rt.x.dtype == torch.float64
    # both reach ~1e-11 relative residuals; the f32 inner solves differ in rounding
    assert rel_err(np.asarray(rj.x), rt.x) < 1e-8
    r0 = float(torch.linalg.vector_norm(TorchModel(
        mesh=tm.mesh, material=TorchNeoHookean(), params=TorchLame(MU, LAM), dirichlet_nodes=tm.dirichlet_nodes,
        body_force=np.asarray(BODY), dtype=torch.float64, device="cpu").residual(torch.zeros_like(rt.x))))
    assert rt.residual_norm / r0 <= 1e-10


def test_model_carried_across_matches_jax():
    jm, _ = _pair(res=3)
    tm = hyperelastic_model_from_arrays(
        np.asarray(jm.mesh.points), np.asarray(jm.mesh.cells), jm.params.mu, jm.params.lam,
        jm.dirichlet_nodes, np.asarray(BODY), dtype=torch.float64, device="cpu", chunk_size=11,
    )
    u, _ = _state(tm.space.num_dofs, seed=3)
    assert rel_err(np.asarray(jm.residual(jnp.asarray(u))), tm.residual(torch.as_tensor(u))) < 1e-12


def test_unported_paths_raise():
    """What the port still refuses: per-element parameter arrays, and mixed precision on an f64 model."""
    _, tm = _pair(res=1)
    with pytest.raises(ValueError, match="float32"):
        tm.solve_mixed(assembled=True)
    mu_el = torch.full((tm.mesh.num_cells,), MU, dtype=torch.float64)
    for banded in (False, True):
        with pytest.raises(NotImplementedError, match="per-element"):
            TorchModel(mesh=tm.mesh, material=TorchNeoHookean(), params=TorchLame(mu_el, LAM),
                       dtype=torch.float64, device="cpu", banded=banded)
