"""Sparse linear algebra: the Krylov solver and the block-DIA/ELL operators."""

from .block_dia import (
    BlockDiaMatrix,
    assemble_block_dia,
    band_expand_plan,
    block_dia_assembly_plan,
    block_dia_matvec,
    block_dia_matvec_cm,
)
from .block_ell import BlockEllMatrix, block_ell_matvec, block_ell_matvec_cm
from .cg import (
    CG_CONVERGED,
    CG_INDEFINITE_OPERATOR,
    CG_INDEFINITE_PRECONDITIONER,
    CG_MAX_ITER,
    CgResult,
    conjugate_gradient,
)
from .dia_kernel import block_dia_operator

__all__ = [
    "conjugate_gradient",
    "CgResult",
    "CG_CONVERGED",
    "CG_MAX_ITER",
    "CG_INDEFINITE_OPERATOR",
    "CG_INDEFINITE_PRECONDITIONER",
    "BlockDiaMatrix",
    "BlockEllMatrix",
    "assemble_block_dia",
    "band_expand_plan",
    "block_dia_assembly_plan",
    "block_dia_matvec",
    "block_dia_matvec_cm",
    "block_dia_operator",
    "block_ell_matvec",
    "block_ell_matvec_cm",
]
