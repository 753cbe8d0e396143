"""Port parity: CG, Newton, the MG V-cycle and the structured solves against JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import both, model_pair, rel_err, rng, to_numpy

import fenris_tpu.multigrid as jmg
import fenris_tpu.optimize as jopt
import fenris_tpu.sparse.cg as jcg
import fenris_tpu_torch.multigrid as tmg
import fenris_tpu_torch.optimize as topt
import fenris_tpu_torch.sparse.cg as tcg


def _spd(n=30, cond=1e3, seed=0):
    q, _ = np.linalg.qr(rng(seed).standard_normal((n, n)))
    return (q * np.geomspace(1.0, cond, n)) @ q.T


def _cg_both(A, b, **kw):
    M = kw.pop("M", None)
    jres = jcg.conjugate_gradient(
        lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
        preconditioner=None if M is None else (lambda v: jnp.asarray(M) @ v), **kw,
    )
    tres = tcg.conjugate_gradient(
        torch.as_tensor(A), torch.as_tensor(b),
        preconditioner=None if M is None else torch.as_tensor(M), **kw,
    )
    return jres, tres


@pytest.mark.parametrize("precondition", [False, True], ids=["cg", "jacobi-pcg"])
def test_cg_matches_jax(precondition):
    A = _spd()
    b = rng(1).standard_normal(A.shape[0])
    M = np.diag(1.0 / np.diag(A)) if precondition else None
    jres, tres = _cg_both(A, b, M=M, rel_tolerance=1e-10)
    assert tres.status == int(jres.status) == tcg.CG_CONVERGED
    # same algorithm; f64 rounding can move the last iteration by one
    assert abs(tres.num_iterations - int(jres.num_iterations)) <= 1
    assert rel_err(np.asarray(jres.x), tres.x) < 1e-8
    assert np.linalg.norm(A @ to_numpy(tres.x) - b) <= 1e-9 * np.linalg.norm(b)


def test_cg_from_x0_matches_jax():
    """CG from a nonzero starting iterate: the same iteration count and solution (f64, 1e-12) as JAX's
    ``x0``.  Condition 1e2 and tolerance 1e-12: at condition 1e3 f64 CG's count moves with the summation
    order of ``A v`` (from one start, numpy, JAX and torch take 55, 56 and 54 iterations)."""
    A = _spd(cond=1e2)
    g = rng(3)
    b, x0 = g.standard_normal(A.shape[0]), g.standard_normal(A.shape[0])
    jres = jcg.conjugate_gradient(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), x0=jnp.asarray(x0),
                                  rel_tolerance=1e-12)
    tres = tcg.conjugate_gradient(torch.as_tensor(A), torch.as_tensor(b), x0=torch.as_tensor(x0),
                                  rel_tolerance=1e-12)
    assert tres.status == int(jres.status) == tcg.CG_CONVERGED
    assert tres.num_iterations == int(jres.num_iterations)
    assert rel_err(np.asarray(jres.x), tres.x) < 1e-12
    # the start is used: one step from x0 differs from one step from zero
    one = [tcg.conjugate_gradient(torch.as_tensor(A), torch.as_tensor(b), x0=start, max_iter=1).x
           for start in (None, torch.as_tensor(x0))]
    assert rel_err(to_numpy(one[0]), one[1]) > 1e-3


def test_cg_max_iter_matches_jax():
    A = _spd()
    b = rng(2).standard_normal(A.shape[0])
    jres, tres = _cg_both(A, b, rel_tolerance=1e-12, max_iter=4)
    assert tres.status == int(jres.status) == tcg.CG_MAX_ITER
    assert tres.num_iterations == int(jres.num_iterations) == 4
    # four f64 iterations from the same start: roundoff only
    assert rel_err(np.asarray(jres.x), tres.x) < 1e-12


@pytest.mark.parametrize(
    "case,status",
    [("operator", tcg.CG_INDEFINITE_OPERATOR), ("preconditioner", tcg.CG_INDEFINITE_PRECONDITIONER)],
)
def test_cg_indefinite_status_matches_jax(case, status):
    A = _spd(n=8)
    M = None
    if case == "operator":
        A = A - 2.0 * np.eye(8) * np.abs(np.linalg.eigvalsh(A)).max()
    else:
        M = -np.eye(8)
        M[0, 0] = 1.0
    b = np.ones(8)
    jres, tres = _cg_both(A, b, M=M, rel_tolerance=1e-10)
    assert tres.status == int(jres.status) == status
    assert tres.num_iterations == int(jres.num_iterations)
    assert rel_err(np.asarray(jres.x), tres.x) < 1e-12


def test_backtracking_alphas_match_jax():
    assert topt.backtracking_alphas() == [float(a) for a in np.asarray(jopt.backtracking_alphas())]


@pytest.mark.parametrize("line_search", [True, False])
def test_newton_matches_jax(line_search):
    """Newton on F(x) = x³ + 3x - b (diagonal Jacobian 3x² + 3)."""
    b = rng(3).uniform(-40.0, 40.0, 12)

    def residual(x, lib):
        return x**3 + 3.0 * x - lib.asarray(b) if lib is jnp else x**3 + 3.0 * x - torch.as_tensor(b)

    jres = jopt.newton_line_search(
        lambda x: residual(x, jnp), lambda x, f: f / (3.0 * x**2 + 3.0), jnp.zeros(12),
        tolerance=1e-12, max_iterations=40, line_search=line_search,
    )
    tres = topt.newton_line_search(
        lambda x: residual(x, torch), lambda x, f: f / (3.0 * x**2 + 3.0), torch.zeros(12, dtype=torch.float64),
        tolerance=1e-12, max_iterations=40, line_search=line_search,
    )
    assert tres.status == int(jres.status) == topt.NEWTON_CONVERGED
    assert tres.iterations == int(jres.iterations)
    # identical iteration in f64: roundoff only
    assert rel_err(np.asarray(jres.x), tres.x) < 1e-13


def test_newton_line_search_failure_matches_jax():
    """An ascent direction fails every trial step: the iterate is kept."""
    b = np.linspace(1.0, 2.0, 5)
    jres = jopt.newton_line_search(
        lambda x: x - jnp.asarray(b), lambda x, f: -f, jnp.zeros(5), tolerance=1e-12
    )
    tres = topt.newton_line_search(
        lambda x: x - torch.as_tensor(b), lambda x, f: -f, torch.zeros(5, dtype=torch.float64), tolerance=1e-12
    )
    assert tres.status == int(jres.status) == topt.NEWTON_LINE_SEARCH_FAILED
    assert tres.iterations == int(jres.iterations) == 1
    assert np.array_equal(to_numpy(tres.x), np.asarray(jres.x))


@pytest.mark.parametrize("transfer", ["restrict", "prolong"])
def test_mg_transfers_match_jax(transfer):
    shape = (3, 9, 5, 7) if transfer == "restrict" else (3, 5, 3, 4)
    v = rng(4).standard_normal(shape)
    fn = "_restrict" if transfer == "restrict" else "_prolong"
    ref, got = both(getattr(jmg, fn), getattr(tmg, fn), v)
    assert rel_err(ref, got) < 1e-15


#: the smallest grid with two multigrid levels (4^3 cells and 2^3 below it)
CELLS = (4, 4, 4)


def test_mg_vcycle_matches_jax():
    jm, tm = model_pair(CELLS, spacing=1.0 / 4)
    jp, tp = jmg.StructuredMGPreconditioner(jm), tmg.StructuredMGPreconditioner(tm)
    assert len(tp.levels) == len(jp.levels) == 2
    r = rng(5).standard_normal(jm.num_dofs) * np.asarray(jm.free_mask)
    ref, got = both(jp, tp, r)
    # ~100 f64 stencil applications, summed in another order: roundoff only
    assert rel_err(ref, got) < 1e-12


@pytest.fixture(scope="module")
def f64_pair():
    """The f64 model pair of the two solve tests, built once."""
    return model_pair(CELLS, spacing=1.0 / 8, body_force=(0.0, 0.0, -9.81))


def test_solve_jacobi_matches_jax(f64_pair):
    jm, tm = f64_pair
    kw = dict(tolerance=1e-10, cg_rel_tolerance=1e-8, preconditioner="jacobi")
    jres = jm.solve(**kw)
    history = []
    tres = tm.solve(**kw, callback=lambda k, fn, cg: history.append((k, fn, cg)))
    assert tres.status == int(jres.status) == topt.NEWTON_CONVERGED
    assert tres.iterations == int(jres.iterations)
    assert tres.residual_norm <= 1e-10 and float(jres.residual_norm) <= 1e-10
    # both solves reach the same solution to the Newton tolerance
    assert rel_err(np.asarray(jres.x), tres.x) < 1e-8
    assert [k for k, _, _ in history] == list(range(tres.iterations + 1))
    assert all(cg.status == tcg.CG_CONVERGED for _, _, cg in history[1:])


def test_solve_mixed_mg_matches_jax(f64_pair):
    jm, tm = model_pair(CELLS, dtype=torch.float32, spacing=1.0 / 8, body_force=(0.0, 0.0, -9.81))
    jres = jm.solve_mixed(tolerance=1e-10, preconditioner="mg")
    tres = tm.solve_mixed(tolerance=1e-10, preconditioner="mg")
    assert tres.status == int(jres.status) == topt.NEWTON_CONVERGED
    assert tres.x.dtype == torch.float64
    # f64 outer residual relative to its start, as solve_mixed defines tolerance
    _, m64 = f64_pair
    r0 = float(torch.linalg.vector_norm(m64.residual(torch.zeros(m64.num_dofs, dtype=torch.float64))))
    rel = float(torch.linalg.vector_norm(m64.residual(tres.x))) / r0
    rel_jax = float(jres.residual_norm) / r0
    assert rel <= 1e-10 and rel_jax <= 1e-10
    # same order of magnitude of the final residual (f32 inner solves differ)
    assert abs(np.log10(rel) - np.log10(rel_jax)) <= 1.0
    assert rel_err(np.asarray(jres.x), tres.x) < 1e-8
