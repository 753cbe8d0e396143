"""Port parity: the matrix-free HyperelasticModel (banded and fused paths) and its solves.

The JAX ``HyperelasticModel(banded=True)`` runs its XLA sweeps on the CPU
(its fused kernels are TPU-only); the port's banded model, with and
without ``fused_kernels`` (whose kernels take their plain versions on the
CPU), runs in f64 on the same mesh and numpy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import LAM, MU, rel_err, rng, to_numpy

from fenris_tpu.elasticity import HyperelasticModel as JaxModel
from fenris_tpu.mesh.procedural import create_unit_box_uniform_hex_mesh_3d as jax_box
from fenris_tpu.solid import LameParameters as JaxLame
from fenris_tpu.solid import NeoHookeanMaterial as JaxNeoHookean
from fenris_tpu_torch.elasticity import HyperelasticModel as TorchModel
from fenris_tpu_torch.interop import hyperelastic_model_from_arrays
from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d as torch_box
from fenris_tpu_torch.ops import em_sweep
from fenris_tpu_torch.optimize import NEWTON_CONVERGED
from fenris_tpu_torch.solid import LameParameters as TorchLame
from fenris_tpu_torch.solid import NeoHookeanMaterial as TorchNeoHookean

BODY = (0.0, 0.0, -4.0)  # tools/solve_assembled.py's load
VARIANTS = {"banded": dict(banded=True), "fused": dict(banded=True, fused_kernels=True)}


def _fixed(points):
    return np.flatnonzero(np.asarray(points)[:, 2] < 1e-12)


def _jax_model(res, **kw):
    mesh = jax_box(res)
    return JaxModel(mesh=mesh, material=JaxNeoHookean(), params=JaxLame(MU, LAM), dirichlet_nodes=_fixed(mesh.points),
                    body_force=lambda x, p: jnp.array(BODY, dtype=x.dtype), **kw)


def _torch_model(res, dtype=torch.float64, **kw):
    mesh = torch_box(res)
    return TorchModel(mesh=mesh, material=TorchNeoHookean(), params=TorchLame(MU, LAM),
                      dirichlet_nodes=_fixed(mesh.points), body_force=np.asarray(BODY), dtype=dtype,
                      device="cpu", **kw)


_JAX = {}


def _jax(res, **kw):
    key = (res, tuple(sorted(kw.items())))
    if key not in _JAX:
        _JAX[key] = _jax_model(res, **kw)
    return _JAX[key]


def _state(n, seed=0):
    g = rng(seed)
    return g.uniform(-0.01, 0.01, n), g.standard_normal(n)


_REF = {}


def _banded_reference(u, v):
    """JAX banded model's f_ext, energy, residual, diagonal and Hessian action at (u, v), computed once."""
    if not _REF:
        jm = _jax(10, banded=True, banded_r_nodes=1024, chunk_size=1)
        uj, vj = jnp.asarray(u), jnp.asarray(v)
        _REF.update(f_ext=np.asarray(jm._f_ext), energy=float(jm.energy(uj)), residual=np.asarray(jm.residual(uj)),
                    diagonal=np.asarray(jm.hessian_diagonal(uj)), hvp=np.asarray(jm.hessian_vector_product(uj, vj)))
    return _REF


# res 10: 1,331 nodes make two owner blocks of 1,024 nodes, so a one-block
# chunk sweeps the padded layout in two chunks
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_banded_operators_match_jax(variant):
    tm = _torch_model(10, banded_r_nodes=1024, chunk_size=1, **VARIANTS[variant])
    assert tm._plan.k_blocks == 2 and tm._band_chunk < tm._plan.padded_elements
    assert (tm._em_tables is not None) == (variant == "fused")
    u, v = _state(tm.space.num_dofs)
    ref = _banded_reference(u, v)
    ut, vt = torch.as_tensor(u), torch.as_tensor(v)
    # f64, another summation order: roundoff only
    assert rel_err(ref["f_ext"], tm._f_ext) < 1e-12
    assert float(tm.energy(ut)) == pytest.approx(ref["energy"], rel=1e-12)
    assert rel_err(ref["residual"], tm.residual(ut)) < 1e-12
    assert rel_err(ref["diagonal"], tm.hessian_diagonal(ut)) < 1e-12
    # forward-mode AD (JAX) vs the closed-form tangent or torch.func.jvp
    assert rel_err(ref["hvp"], tm.hessian_vector_product(ut, vt)) < 1e-10
    assert rel_err(ref["hvp"], tm.hessian_operator(ut)(vt)) < 1e-10


def test_fused_hessian_action_runs_the_banded_tangent_sweep(monkeypatch):
    """The fused model's Hessian action is one banded_tangent_sweep (then the scatter), matching JAX."""
    calls = []
    fused = em_sweep.banded_tangent_sweep

    def spy(*args, **kwargs):
        calls.append(args[0])
        return fused(*args, **kwargs)

    monkeypatch.setattr(em_sweep, "banded_tangent_sweep", spy)
    tm = _torch_model(10, banded_r_nodes=1024, chunk_size=1, banded=True, fused_kernels=True)
    u, v = _state(tm.space.num_dofs)
    ref = _banded_reference(u, v)
    hv = tm.hessian_vector_product(torch.as_tensor(u), torch.as_tensor(v))
    assert len(calls) == 1 and calls[0] is tm._plan
    # forward-mode AD (JAX) vs the closed-form tangent
    assert rel_err(ref["hvp"], hv) < 1e-10


def test_fused_residual_runs_the_banded_vector_sweep(monkeypatch):
    """The fused model's residual is one banded_vector_sweep (then the scatter) and no gather, matching JAX."""
    import fenris_tpu_torch.elasticity as tel

    calls = []
    fused = em_sweep.banded_vector_sweep

    def spy(*args, **kwargs):
        calls.append(args[0])
        return fused(*args, **kwargs)

    def no_gather(*args, **kwargs):
        raise AssertionError("the fused residual gathered")

    monkeypatch.setattr(em_sweep, "banded_vector_sweep", spy)
    monkeypatch.setattr(tel, "gather", no_gather)
    tm = _torch_model(10, banded_r_nodes=1024, chunk_size=1, banded=True, fused_kernels=True)
    u, v = _state(tm.space.num_dofs)
    ref = _banded_reference(u, v)
    r = tm.residual(torch.as_tensor(u))
    assert len(calls) == 1 and calls[0] is tm._plan
    # f64, another summation order: roundoff only
    assert rel_err(ref["residual"], r) < 1e-12


@pytest.mark.parametrize("chunk_size", [None, 7], ids=["unchunked", "chunked"])
def test_plain_hessian_diagonal_matches_jax(chunk_size):
    jm = _jax(3, chunk_size=chunk_size)
    tm = _torch_model(3, chunk_size=chunk_size)
    u, _ = _state(tm.space.num_dofs, seed=1)
    assert rel_err(np.asarray(jm.hessian_diagonal(jnp.asarray(u))), tm.hessian_diagonal(torch.as_tensor(u))) < 1e-12


def _jax_relative_residual(x):
    jm = _jax(3)
    r0 = float(jnp.linalg.norm(jm.residual(jnp.zeros(jm.space.num_dofs))))
    return float(jnp.linalg.norm(jm.residual(jnp.asarray(to_numpy(x), jnp.float64)))) / r0


@pytest.mark.parametrize("variant", ["plain", "banded", "fused"])
def test_matrix_free_solve_converges(variant):
    tm = _torch_model(3, **VARIANTS.get(variant, {}))
    history = []
    res = tm.solve(tolerance=1e-10, callback=lambda k, fn, cg: history.append(cg))
    assert res.status == NEWTON_CONVERGED
    assert history[0] is None and all(cg.num_iterations > 0 for cg in history[1:])
    assert _jax_relative_residual(res.x) <= 1e-9


@pytest.mark.parametrize("variant", ["plain", "fused"])
def test_matrix_free_solve_mixed_converges(variant):
    tm = _torch_model(3, dtype=torch.float32, **VARIANTS.get(variant, {}))
    res = tm.solve_mixed(tolerance=1e-10)
    assert res.status == NEWTON_CONVERGED and res.x.dtype == torch.float64
    assert _jax_relative_residual(res.x) <= 1e-10


def test_model_carried_across_keeps_the_banded_flags():
    jm = _jax(10, banded=True, banded_r_nodes=1024, chunk_size=1)
    tm = hyperelastic_model_from_arrays(
        np.asarray(jm.mesh.points), np.asarray(jm.mesh.cells), jm.params.mu, jm.params.lam, jm.dirichlet_nodes,
        np.asarray(BODY), dtype=torch.float64, device="cpu", chunk_size=1, banded=True, banded_r_nodes=1024,
        fused_kernels=True,
    )
    assert tm._plan is not None and tm.fused_kernels and tm._plan.k_blocks == jm._plan.k_blocks
    np.testing.assert_array_equal(tm._plan.perm, jm._plan.perm)
    u, _ = _state(tm.space.num_dofs, seed=3)
    assert rel_err(np.asarray(jm.residual(jnp.asarray(u))), tm.residual(torch.as_tensor(u))) < 1e-12
