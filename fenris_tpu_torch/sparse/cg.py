"""Preconditioned Conjugate Gradient (eager loop).

Counterpart of ``fenris_tpu/sparse/cg.py`` (reference: fenris-sparse
cg.rs): PCG with the relative-residual stopping criterion
``||r_k|| <= rel_tolerance * ||b||`` on the recursively updated residual
(cg.rs:107-125) and the failure taxonomy of ``SolveErrorKind`` (cg.rs:279)
as ``CG_*`` codes.  The loop runs in Python; each iteration reads back
one scalar (two with ``check_definiteness``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = [
    "conjugate_gradient",
    "CgResult",
    "CG_CONVERGED",
    "CG_MAX_ITER",
    "CG_INDEFINITE_OPERATOR",
    "CG_INDEFINITE_PRECONDITIONER",
]

CG_CONVERGED = 0
CG_MAX_ITER = 1
CG_INDEFINITE_OPERATOR = 2
CG_INDEFINITE_PRECONDITIONER = 3


class CgResult(NamedTuple):
    """Solution plus solve metadata (cf. ``CgOutput``, cg.rs:349)."""

    x: torch.Tensor
    num_iterations: int
    status: int  # one of the CG_* codes
    residual_norm: torch.Tensor  # 0-dim, of the recursive residual


def _as_operator(op) -> Callable:
    if callable(op):
        return op
    if isinstance(op, torch.Tensor) and op.dim() == 2:
        return lambda v: op @ v
    raise TypeError(f"unsupported operator type {type(op)}")


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _norm(v):
    return torch.linalg.vector_norm(v)


def conjugate_gradient(
    operator,
    rhs: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    preconditioner=None,
    rel_tolerance: float = 1e-8,
    max_iter: Optional[int] = None,
    check_definiteness: bool = True,
) -> CgResult:
    """Solve ``A x = b`` for SPD ``A`` with (optionally preconditioned) CG.

    ``operator``/``preconditioner`` are callables ``v -> Av`` or 2-D tensors;
    the iteration starts from ``x0`` (``None``: zero), its residual
    ``b - A x0`` computed once.
    With ``check_definiteness``, a step with ``p·Ap <= 0`` stops with
    ``CG_INDEFINITE_OPERATOR`` (keeping the previous iterate) and
    ``r·z < 0`` stops with ``CG_INDEFINITE_PRECONDITIONER``.
    """
    return _pcg(operator, rhs, preconditioner, rel_tolerance, max_iter, check_definiteness, x0, _dot, _norm)


def _pcg(operator, rhs, preconditioner, rel_tolerance, max_iter, check_definiteness, x0, dot, norm) -> CgResult:
    """The CG loop of :func:`conjugate_gradient` from ``x0`` (None: zero), with its inner products
    ``dot(a, b)`` and norms ``norm(v)`` given: the sharded classes of :mod:`..parallel` pass ones that
    reduce over every rank's part of the vectors."""
    A = _as_operator(operator)
    M = _as_operator(preconditioner) if preconditioner is not None else (lambda r: r)
    b = rhs
    if max_iter is None:
        max_iter = 10 * b.numel()
    tol = rel_tolerance * norm(b)

    if x0 is None:
        x = torch.zeros_like(b)
        r = b  # b - A(0) for a linear operator
    else:
        x = x0
        r = b - A(x0)
    r_norm = norm(r)
    status = CG_CONVERGED if bool(r_norm <= tol) else -1
    if status < 0:
        z = M(r)
        rz = dot(r, z)
        p = z
    k = 0
    while status < 0 and k < max_iter:
        Ap = A(p)
        pAp = dot(p, Ap)
        k += 1
        if check_definiteness and bool(pAp <= 0.0) and bool(norm(p) > 0.0):
            status = CG_INDEFINITE_OPERATOR  # keep the previous iterate
            break
        alpha = rz / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        r_norm = norm(r)
        if bool(r_norm <= tol):
            status = CG_CONVERGED
            break
        z = M(r)
        rz1 = dot(r, z)
        if check_definiteness and bool(rz1 < 0.0):
            status = CG_INDEFINITE_PRECONDITIONER
            break
        p = z + (rz1 / rz) * p
        rz = rz1
    if status < 0:
        status = CG_MAX_ITER
    return CgResult(x=x, num_iterations=k, status=status, residual_norm=r_norm)
