"""Nonlinear solvers: Newton's method with Armijo line search.

Counterpart of ``fenris_tpu/optimize/__init__.py`` (reference:
fenris-optimize newton.rs): ``newton`` (:61), ``newton_line_search`` (:77)
with the backtracking schedule 1, 0.75, 0.5, 0.25, 0.25², … and the
sufficient-decrease test g(x + αp) <= (1 - cα) g(x), g = ||F||²/2,
c = 1e-4 (:172), and ``mixed_precision_newton`` (f64 outer residual,
f32 inner solve).  The loops run eagerly on the host, with the semantics
of the JAX package's host-driven Newton loop.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "NewtonResult",
    "newton",
    "newton_line_search",
    "backtracking_alphas",
    "mixed_precision_newton",
    "approximate_jacobian_fd",
    "approximate_gradient_fd",
    "NEWTON_CONVERGED",
    "NEWTON_MAX_ITER",
    "NEWTON_LINE_SEARCH_FAILED",
]

NEWTON_CONVERGED = 0
NEWTON_MAX_ITER = 1
NEWTON_LINE_SEARCH_FAILED = 2


class NewtonResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    status: int  # one of the NEWTON_* codes
    residual_norm: float


def backtracking_alphas(max_backtracks: int = 14) -> List[float]:
    """The reference's alpha schedule: 1, 0.75, 0.5, 0.25, 0.25², … ."""
    alphas = [1.0, 0.75, 0.5]
    a = 0.25
    while len(alphas) < max_backtracks:
        alphas.append(a)
        a *= 0.25
    return alphas[:max_backtracks]


def _norm(f) -> float:
    return float(torch.linalg.vector_norm(f))


def newton(residual: Callable, solve_jacobian: Callable, x0, tolerance: float,
           max_iterations: int = 50) -> NewtonResult:
    """Newton's method with full steps (newton.rs:61)."""
    return newton_line_search(
        residual, solve_jacobian, x0, tolerance, max_iterations, line_search=False
    )


def newton_line_search(
    residual: Callable,
    solve_jacobian: Callable,
    x0: torch.Tensor,
    tolerance: float,
    max_iterations: int = 50,
    line_search: bool = True,
    c: float = 1e-4,
    alpha_min: float = 1e-6,
    max_backtracks: int = 14,
    callback: Optional[Callable[[int, float], None]] = None,
) -> NewtonResult:
    """Newton with Armijo backtracking (newton.rs:77, :172).

    ``residual(x) -> F(x)``; ``solve_jacobian(x, F) -> d`` solving
    ``J(x) d = F`` (the step is ``-d``).  Stops when ``||F|| <= tolerance``;
    if no trial step decreases g enough, the iterate is kept and the status
    is ``NEWTON_LINE_SEARCH_FAILED``.  ``callback(k, ||F||)`` is called for
    the initial point (k = 0) and after every iteration.  The parameters
    take the JAX package's positional order; ``alpha_min`` is accepted and,
    as there, not read: the ``max_backtracks`` steps of
    :func:`backtracking_alphas` bound the search.
    """
    return _newton_line_search(residual, solve_jacobian, x0, tolerance, max_iterations, line_search, c,
                               max_backtracks, callback, torch.dot, _norm)


def _newton_line_search(residual, solve_jacobian, x0, tolerance, max_iterations, line_search, c, max_backtracks,
                        callback, dot, norm) -> NewtonResult:
    """The loop of :func:`newton_line_search` with its inner product ``dot(a, b)`` and norm ``norm(v) -> float``
    given: the sharded-state classes of :mod:`..parallel` pass ones that reduce over every rank's part."""
    alphas = backtracking_alphas(max_backtracks)
    x = x0
    f = residual(x)
    fn = norm(f)
    status = NEWTON_CONVERGED if fn <= tolerance else -1
    if callback is not None:
        callback(0, fn)
    k = 0
    while status < 0 and k < max_iterations:
        p = -solve_jacobian(x, f)
        found = True
        if line_search:
            g0 = 0.5 * dot(f, f)
            found = False
            for alpha in alphas:
                f_try = residual(x + alpha * p)
                if bool(0.5 * dot(f_try, f_try) <= (1.0 - c * alpha) * g0):
                    found = True
                    x, f = x + alpha * p, f_try
                    break
        else:
            x = x + p
            f = residual(x)
        k += 1
        fn = norm(f)
        if not found:
            status = NEWTON_LINE_SEARCH_FAILED
        elif fn <= tolerance:
            status = NEWTON_CONVERGED
        if callback is not None:
            callback(k, fn)
    if status < 0:
        status = NEWTON_MAX_ITER
    return NewtonResult(x=x, iterations=k, status=status, residual_norm=fn)


def mixed_precision_newton(
    residual64: Callable,
    inner_solve: Callable,
    u0: torch.Tensor,
    tolerance: float,
    max_iterations: int = 30,
    verbose: bool = False,
    callback: Optional[Callable[[int, float], None]] = None,
) -> NewtonResult:
    """Newton with an f64 outer residual and a caller-supplied f32 inner solve.

    Finite-precision CG's attainable accuracy is ~eps * kappa; keeping the
    iterate and the residual in f64 while each inner Krylov solve runs in
    f32 makes Newton an iterative refinement that contracts by ~kappa(H) *
    eps_f32 per iteration.

    Args:
        residual64: ``u64 -> f64 residual``.
        inner_solve: ``(k, u32, f32) -> d`` returning the (approximate)
            Newton direction for iteration ``k``.
        u0: initial iterate (cast to f64).
        tolerance: relative to the initial residual norm.
        callback: ``callback(k, ||F||)`` for k = 0 and after each accepted step.
    """
    u = u0.to(torch.float64)
    f = residual64(u)
    nf0 = nf = _norm(f)
    if callback is not None:
        callback(0, nf)
    if nf0 == 0.0:
        return NewtonResult(x=u, iterations=0, status=NEWTON_CONVERGED, residual_norm=nf)
    alphas = backtracking_alphas()
    status, k = NEWTON_MAX_ITER, 0
    for k in range(1, max_iterations + 1):
        d = inner_solve(k, u.to(torch.float32), f.to(torch.float32)).to(torch.float64)
        accepted = False
        for alpha in alphas:
            u_try = u - alpha * d
            f_try = residual64(u_try)
            nf_try = _norm(f_try)
            if verbose:
                print(f"[mixed_newton it {k}] alpha={alpha:g} |f|={nf_try:.6e} (prev {nf:.6e})", flush=True)
            if nf_try**2 <= (1.0 - 1e-4 * alpha) * nf**2:
                u, f, nf, accepted = u_try, f_try, nf_try, True
                break
        if not accepted:
            status = NEWTON_LINE_SEARCH_FAILED
            break
        if callback is not None:
            callback(k, nf)
        if nf <= tolerance * nf0:
            status = NEWTON_CONVERGED
            break
    return NewtonResult(x=u, iterations=k, status=status, residual_norm=nf)


# -- finite-difference calculus (test utilities; calculus.rs:156-305) --------------------------


def approximate_jacobian_fd(f: Callable, x, h: float = 1e-6) -> np.ndarray:
    """Central-difference Jacobian ``[m, n]`` of ``f: R^n -> R^m`` at ``x`` (calculus.rs:266).

    ``f`` takes and returns float64 CPU tensors; the result is numpy.
    """
    x = torch.as_tensor(np.asarray(x, dtype=np.float64))
    cols = []
    for j in range(x.shape[0]):
        e = torch.zeros_like(x)
        e[j] = h
        cols.append((torch.as_tensor(f(x + e)) - torch.as_tensor(f(x - e))) / (2 * h))
    return torch.stack(cols, dim=1).numpy()


def approximate_gradient_fd(f: Callable, x, h: float = 1e-6) -> np.ndarray:
    """Central-difference gradient ``[n]`` of a scalar ``f`` at ``x`` (calculus.rs:205)."""
    x = torch.as_tensor(np.asarray(x, dtype=np.float64))
    g = np.zeros(x.shape[0])
    for j in range(x.shape[0]):
        e = torch.zeros_like(x)
        e[j] = h
        g[j] = (float(f(x + e)) - float(f(x - e))) / (2 * h)
    return g
