"""Global assembly: dof maps and a deterministic scatter-add.

Counterpart of ``element_dof_indices`` (global.rs, ``global_.py:149``) and
``assemble_vector`` (``global_.py:250``) of ``fenris_tpu/assembly``.  The
CSR pattern and CSR numeric assembly are not ported yet.

The JAX package scatters with ``jax.ops.segment_sum``, which is
deterministic.  PyTorch's ``index_add_`` on a CUDA tensor adds with
atomics, so sums into one target would come out in another order from
run to run, and CG would follow.  :func:`scatter_add_rows` therefore
splits the rows into *layers* whose targets are pairwise distinct (layer
r holds, for every target, its r-th row in row order) and adds the layers
one after another: within a layer no two atomic adds meet, so every sum
is taken in the fixed row order, bitwise the same on every run.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "element_dof_indices",
    "ScatterPlan",
    "scatter_plan",
    "scatter_add_rows",
    "assemble_vector",
]


def element_dof_indices(cells: np.ndarray, solution_dim: int) -> np.ndarray:
    """Dof indices per element, node-major: dof = s * node + component; ``[E, n*s]``."""
    s = int(solution_dim)
    cells = np.asarray(cells)
    E, n = cells.shape
    dofs = cells[:, :, None].astype(np.int64) * s + np.arange(s)[None, None, :]
    return dofs.reshape(E, n * s)


class ScatterPlan(NamedTuple):
    """Targets of a row scatter and their collision-free layers."""

    ids: torch.Tensor  # [M] int64 target row per source row
    layers: Optional[List[torch.Tensor]]  # None when ids are pairwise distinct


def scatter_plan(ids: torch.Tensor) -> ScatterPlan:
    """Split source rows into layers with pairwise distinct targets.

    Row k goes to layer ``rank(k)``, the number of earlier rows with the
    same target; layers list their rows in increasing order.  Built with a
    stable sort on the ids' device.
    """
    ids = ids.reshape(-1).long()
    M = ids.numel()
    if M == 0:
        return ScatterPlan(ids, None)
    sorted_ids, order = torch.sort(ids, stable=True)
    first = torch.searchsorted(sorted_ids, sorted_ids)
    rank = torch.empty_like(ids)
    rank[order] = torch.arange(M, device=ids.device) - first
    top = int(rank.max())
    if top == 0:
        return ScatterPlan(ids, None)
    return ScatterPlan(ids, [torch.nonzero(rank == r).reshape(-1) for r in range(top + 1)])


def scatter_add_rows(out: torch.Tensor, plan: ScatterPlan, rows: torch.Tensor, inplace: bool = False):
    """``out[plan.ids[k]] += rows[k]`` for every k, in row order per target.

    Out of place by default, so ``torch.func`` transforms pass through it;
    ``inplace=True`` updates ``out`` (for large accumulators).
    """
    add = out.index_add_ if inplace else out.index_add
    if plan.layers is None:
        return add(0, plan.ids, rows)
    for sel in plan.layers:
        out = (out.index_add_ if inplace else out.index_add)(0, plan.ids[sel], rows[sel])
    return out


def assemble_vector(element_vectors: torch.Tensor, dofs, num_dofs: int, plan: Optional[ScatterPlan] = None):
    """Global vector from element vectors ``[E, nd]`` and the dof map ``[E, nd]``.

    Parity: VectorAssembler::assemble_vector (global.rs:569/:619);
    deterministic on every device (see the module notes).
    """
    if plan is None:
        plan = scatter_plan(torch.as_tensor(np.asarray(dofs) if not isinstance(dofs, torch.Tensor) else dofs,
                                            device=element_vectors.device))
    out = element_vectors.new_zeros(num_dofs)
    return scatter_add_rows(out, plan, element_vectors.reshape(-1))
