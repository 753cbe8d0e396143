"""Aggregate (multi-block, mixed-element) assembly into one shared CSR pattern.

Counterpart of ``fenris_tpu/assembly/aggregate.py`` (local.rs:152
``AggregateElementAssembler``, :302 ``MapElementNodes``).  A mixed mesh is
a list of homogeneous cell blocks over one shared node space.  The
symbolic phase is one sorted ``torch.unique`` over the concatenated dof
pair keys of all blocks on the device it is asked for (the card by
default), as :func:`.global_.csr_pattern` does, giving the JAX package's
pattern and per-block scatter maps exactly.  Numeric assembly scatters
each block in its collision-free layers (:func:`.global_.scatter_add_rows`,
no two float atomics meet) and adds the block sums in block order, so two
assemblies are bitwise equal.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Sequence, Tuple

import numpy as np
import torch

from ..config import resolve_device
from .global_ import CsrPattern, ScatterPlan, scatter_add_rows, scatter_plan

__all__ = ["AggregatePattern", "aggregate_csr_pattern", "assemble_aggregate_csr", "assemble_aggregate_vector"]


@dataclass(frozen=True, eq=False)
class AggregatePattern:
    """The shared CSR pattern and each block's scatter map ``[E_b, nd_b, nd_b]`` int32 into its values."""

    pattern: CsrPattern
    block_scatter: Tuple[torch.Tensor, ...]

    @cached_property
    def block_plans(self) -> Tuple[ScatterPlan, ...]:
        """The collision-free layers of each block's scatter, built on first use."""
        return tuple(scatter_plan(b.reshape(-1)) for b in self.block_scatter)


def _cells(cells, device) -> torch.Tensor:
    if isinstance(cells, torch.Tensor):
        return cells.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(cells), dtype=torch.int64, device=device)


def aggregate_csr_pattern(cell_blocks: Sequence, num_nodes: int, solution_dim: int = 1,
                          device="cuda") -> AggregatePattern:
    """Symbolic assembly over several homogeneous blocks ``[E_b, n_b]`` indexing one node space, on ``device``.

    Dofs are node-major (dof = s * node + component); the pair keys
    ``row * N + col`` of each block run over its elements, then rows,
    then columns, as in the JAX package.
    """
    dev = resolve_device(device)
    s = int(solution_dim)
    N = int(num_nodes) * s
    comp = torch.arange(s, device=dev)
    keys, sizes = [], []
    for cells in cell_blocks:
        c = _cells(cells, dev)
        E, n = c.shape
        dofs = (c[:, :, None] * s + comp).reshape(E, n * s)
        keys.append((dofs[:, :, None] * N + dofs[:, None, :]).reshape(-1))
        sizes.append((E, n * s))
    uniq, inverse = torch.unique(torch.cat(keys), sorted=True, return_inverse=True)
    del keys
    rows = uniq // N
    diag_keys = torch.arange(N, device=dev) * (N + 1)
    dpos = torch.searchsorted(uniq, diag_keys)
    hit = (dpos < uniq.numel()) & (uniq[dpos.clamp(max=max(uniq.numel() - 1, 0))] == diag_keys)
    scatters, off = [], 0
    inverse = inverse.to(torch.int32)
    for E, nd in sizes:
        scatters.append(inverse[off : off + E * nd * nd].reshape(E, nd, nd))
        off += E * nd * nd
    pattern = CsrPattern(
        num_rows=N,
        num_cols=N,
        row_ptr=torch.searchsorted(rows, torch.arange(N + 1, device=dev)),
        col_indices=(uniq % N).to(torch.int32),
        scatter_indices=scatters[0] if scatters else torch.zeros((0, 0, 0), dtype=torch.int32, device=dev),
        rows_of_nnz=rows.to(torch.int32),
        diag_positions=torch.where(hit, dpos, -1),
        solution_dim=s,
    )
    return AggregatePattern(pattern=pattern, block_scatter=tuple(scatters))


def assemble_aggregate_csr(element_matrix_blocks, agg: AggregatePattern) -> torch.Tensor:
    """CSR values ``[nnz]``: each block's element matrices summed in element order, the block sums added in
    block order (the JAX package's per-block ``segment_sum``)."""
    nnz = agg.pattern.nnz
    values = element_matrix_blocks[0].new_zeros(nnz)
    for mats, plan in zip(element_matrix_blocks, agg.block_plans):
        values = values + scatter_add_rows(mats.new_zeros(nnz), plan, mats.reshape(-1), inplace=True)
    return values


def assemble_aggregate_vector(element_vector_blocks, dof_blocks, num_dofs: int) -> torch.Tensor:
    """A global vector from several blocks' element vectors ``[E_b, nd_b]`` and dof maps, block sums in order."""
    out = element_vector_blocks[0].new_zeros(num_dofs)
    for vecs, dofs in zip(element_vector_blocks, dof_blocks):
        plan = scatter_plan(_cells(dofs, vecs.device).reshape(-1))
        out = out + scatter_add_rows(vecs.new_zeros(num_dofs), plan, vecs.reshape(-1), inplace=True)
    return out
