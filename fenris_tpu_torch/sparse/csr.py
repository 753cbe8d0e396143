"""CSR matrices: the product, the diagonal and a dense copy.

Counterpart of ``CsrMatrix``, ``from_pattern``, ``spmv`` and ``to_dense``
of ``fenris_tpu/sparse/__init__.py`` (:32-116).  The JAX package forms the
product outside any Pallas kernel (a gather and a ``segment_sum``); here
it is ``torch.sparse_csr_tensor``'s product, built once a matrix (cuSPARSE
on the card, 32-bit indices below 2^31 entries).  The JAX package's size
guard for the TPU's scalar CSR product is a TPU workaround and is not
carried over.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import torch

__all__ = ["CsrMatrix", "from_pattern", "spmv", "to_dense"]


@dataclass(frozen=True, eq=False)
class CsrMatrix:
    """A CSR matrix: ``row_ptr [nrows + 1]``, ``col_indices [nnz]`` (sorted within rows), ``values [nnz]``."""

    row_ptr: torch.Tensor
    col_indices: torch.Tensor
    values: torch.Tensor
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.col_indices.numel()

    def __matmul__(self, v: torch.Tensor) -> torch.Tensor:
        return spmv(self, v)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return spmv(self, v)

    @cached_property
    def rows(self) -> torch.Tensor:
        """Row of every stored entry, int64."""
        counts = self.row_ptr[1:] - self.row_ptr[:-1]
        return torch.repeat_interleave(torch.arange(self.shape[0], device=counts.device), counts)

    @cached_property
    def sparse(self) -> torch.Tensor:
        """The matrix as a ``torch.sparse_csr_tensor`` (built on first use)."""
        index = torch.int32 if max(self.nnz, self.shape[1]) < 2**31 else torch.int64
        return torch.sparse_csr_tensor(self.row_ptr.to(index), self.col_indices.to(index), self.values,
                                       size=self.shape, check_invariants=False)

    def diagonal(self) -> torch.Tensor:
        """Structural diagonal values (0 where absent)."""
        on_diag = self.col_indices.long() == self.rows
        out = self.values.new_zeros(self.shape[0])
        return out.index_add_(0, self.rows[on_diag], self.values[on_diag])


def from_pattern(pattern, values: torch.Tensor) -> CsrMatrix:
    """A :class:`CsrMatrix` from an assembly :class:`~..assembly.global_.CsrPattern` and its values."""
    return CsrMatrix(row_ptr=pattern.row_ptr, col_indices=pattern.col_indices, values=values,
                     shape=(pattern.num_rows, pattern.num_cols))


def spmv(m: CsrMatrix, v: torch.Tensor) -> torch.Tensor:
    """``m @ v`` for a vector ``v [ncols]`` (or a block ``[ncols, k]``)."""
    return m.sparse @ v


def to_dense(m: CsrMatrix) -> torch.Tensor:
    out = m.values.new_zeros(m.shape)
    return out.index_put_((m.rows, m.col_indices.long()), m.values, accumulate=True)
