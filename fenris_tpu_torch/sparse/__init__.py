"""Sparse linear algebra (the Krylov solver only, in this slice)."""

from .cg import (
    CG_CONVERGED,
    CG_INDEFINITE_OPERATOR,
    CG_INDEFINITE_PRECONDITIONER,
    CG_MAX_ITER,
    CgResult,
    conjugate_gradient,
)

__all__ = [
    "conjugate_gradient",
    "CgResult",
    "CG_CONVERGED",
    "CG_MAX_ITER",
    "CG_INDEFINITE_OPERATOR",
    "CG_INDEFINITE_PRECONDITIONER",
]
