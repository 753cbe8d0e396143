"""Global assembly: dof maps, a deterministic scatter-add and CSR assembly.

Counterpart of ``fenris_tpu/assembly/global_.py``: ``element_dof_indices``
(:149), ``assemble_vector`` (:250), the symbolic CSR assembly
(``CsrPattern`` :48, ``csr_pattern`` :161 with the s x s block expansion
``_expand_pattern`` :77), the numeric one (``assemble_csr`` :239,
``assemble_scalar`` :260) and the homogeneous Dirichlet elimination
(:270-331).  The pattern is built with ``torch.unique`` on the device it
is asked for (the card by default) and holds the JAX package's arrays
exactly: one sort over the element blocks' (row, col) keys gives the
sorted pattern and every local entry's position in it.

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

from dataclasses import dataclass
from functools import cached_property
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..config import resolve_device

__all__ = [
    "element_dof_indices",
    "ScatterPlan",
    "scatter_plan",
    "scatter_add_rows",
    "assemble_vector",
    "CsrPattern",
    "csr_pattern",
    "assemble_csr",
    "assemble_scalar",
    "apply_homogeneous_dirichlet_bc_csr",
    "apply_homogeneous_dirichlet_bc_rhs",
    "apply_homogeneous_dirichlet_bc_matrix",
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


# ---------------------------------------------------------------------------
# CSR: symbolic and numeric assembly
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class CsrPattern:
    """Symbolic CSR structure plus the element scatter map, as tensors on one device.

    Attributes:
        num_rows/num_cols: dof-level dimensions (num_nodes * solution_dim).
        row_ptr: ``[num_rows + 1]`` int64.
        col_indices: ``[nnz]`` int32, sorted within rows.
        scatter_indices: ``[E, ndof_local, ndof_local]`` int32: position in
            the values array of each local element matrix entry.
        rows_of_nnz: ``[nnz]`` int32 row of every stored entry.
        diag_positions: ``[num_rows]`` int64 position of each diagonal entry
            (-1 if structurally absent).
        solution_dim: block size s.
    """

    num_rows: int
    num_cols: int
    row_ptr: torch.Tensor
    col_indices: torch.Tensor
    scatter_indices: torch.Tensor
    rows_of_nnz: torch.Tensor
    diag_positions: torch.Tensor
    solution_dim: int

    @property
    def nnz(self) -> int:
        return self.col_indices.numel()

    @cached_property
    def scatter(self) -> ScatterPlan:
        """The collision-free layers of the element scatter, built on first use."""
        return scatter_plan(self.scatter_indices.reshape(-1))


def csr_pattern(cells, num_nodes: int, solution_dim: int = 1, device="cuda") -> CsrPattern:
    """Symbolic assembly: the CSR pattern and per-element scatter indices, on ``device``.

    One sorted ``torch.unique`` over the E n^2 node keys ``row * N + col``;
    for ``solution_dim > 1`` the node pattern is expanded into s x s blocks
    (:func:`_expand_pattern`), which gives the dof-level pattern exactly.
    """
    dev = resolve_device(device)
    s = int(solution_dim)
    cells_t = torch.as_tensor(np.asarray(cells), dtype=torch.int64, device=dev)
    if s > 1:
        return _expand_pattern(csr_pattern(cells, num_nodes, 1, dev), cells_t, s)
    E, n = cells_t.shape
    N = int(num_nodes)
    keys = (cells_t[:, :, None] * N + cells_t[:, None, :]).reshape(-1)
    uniq, inverse = torch.unique(keys, sorted=True, return_inverse=True)
    del keys
    rows = uniq // N
    diag_keys = torch.arange(N, device=dev) * (N + 1)
    dpos = torch.searchsorted(uniq, diag_keys)
    hit = (dpos < uniq.numel()) & (uniq[dpos.clamp(max=max(uniq.numel() - 1, 0))] == diag_keys)
    return CsrPattern(
        num_rows=N,
        num_cols=N,
        row_ptr=torch.searchsorted(rows, torch.arange(N + 1, device=dev)),
        col_indices=(uniq % N).to(torch.int32),
        scatter_indices=inverse.to(torch.int32).reshape(E, n, n),
        rows_of_nnz=rows.to(torch.int32),
        diag_positions=torch.where(hit, dpos, -1),
        solution_dim=1,
    )


def _expand_pattern(pn: CsrPattern, cells: torch.Tensor, s: int) -> CsrPattern:
    """Expand a node-level CSR pattern into the s x s block dof pattern (dof = s * node + component).

    Dof row (i, c) holds node row i's columns, each expanded into its s
    components; node entry p of row i expands to position
    ``s^2 rpn[i] + c s cn[i] + (p - rpn[i]) s + cc``.  The scatter indices
    are written in element chunks of ~2^24 entries.
    """
    dev = cells.device
    rpn = pn.row_ptr
    cn = rpn[1:] - rpn[:-1]
    N = pn.num_rows
    c_idx = torch.arange(s, device=dev)
    lens = torch.repeat_interleave(cn * s, s)  # entries a dof row
    row_ptr = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
    cb = (pn.col_indices.long()[:, None] * s + c_idx).reshape(-1)
    pos = torch.arange(int(row_ptr[-1]), device=dev)
    pos += torch.repeat_interleave(torch.repeat_interleave(rpn[:-1] * s, s) - row_ptr[:-1], lens)
    col_indices = cb[pos].to(torch.int32)
    del cb, pos
    rows_of_nnz = torch.repeat_interleave(torch.arange(N * s, dtype=torch.int32, device=dev), lens)

    E, n = cells.shape
    scatter = torch.empty((E, n, s, n, s), dtype=torch.int32, device=dev)
    chunk = max(1, (1 << 24) // max(n * n * s * s, 1))
    for e0 in range(0, E, chunk):
        c = cells[e0 : e0 + chunk]
        core = s * pn.scatter_indices[e0 : e0 + chunk].long() + (s * (s - 1)) * rpn[c][:, :, None]
        scatter[e0 : e0 + chunk] = (
            core[:, :, None, :, None]
            + (s * cn[c])[:, :, None, None, None] * c_idx[None, None, :, None, None]
            + c_idx
        ).to(torch.int32)

    off_n = pn.diag_positions - rpn[:N]
    diag = (s * s) * rpn[:N, None] + (s * cn[:, None]) * c_idx + off_n[:, None] * s + c_idx
    diag = torch.where((pn.diag_positions >= 0)[:, None], diag, -1).reshape(-1)
    return CsrPattern(
        num_rows=N * s,
        num_cols=N * s,
        row_ptr=row_ptr,
        col_indices=col_indices,
        scatter_indices=scatter.reshape(E, n * s, n * s),
        rows_of_nnz=rows_of_nnz,
        diag_positions=diag,
        solution_dim=s,
    )


def assemble_csr(element_matrices: torch.Tensor, pattern: CsrPattern) -> torch.Tensor:
    """Numeric CSR assembly: values ``[nnz]`` from element matrices ``[E, nd, nd]``.

    Each stored entry sums its element contributions in element order, in
    the pattern's collision-free layers (:func:`scatter_add_rows`): the
    same sums as JAX's ``segment_sum``, bitwise the same on every run.
    """
    out = element_matrices.new_zeros(pattern.nnz)
    return scatter_add_rows(out, pattern.scatter, element_matrices.reshape(-1), inplace=True)


def assemble_scalar(element_scalars: torch.Tensor) -> torch.Tensor:
    """Global scalar = sum of element scalars (global.rs:697/:724)."""
    return torch.sum(element_scalars)


# ---------------------------------------------------------------------------
# Dirichlet boundary conditions
# ---------------------------------------------------------------------------


def _dirichlet_dofs(nodes, s: int, device) -> torch.Tensor:
    nodes = torch.as_tensor(np.asarray(nodes, dtype=np.int64), device=device)
    return (nodes[:, None] * s + torch.arange(s, device=device)).reshape(-1)


def _dirichlet_scale(values: torch.Tensor, pattern: CsrPattern) -> torch.Tensor:
    """First nonzero |diagonal| entry, else 1 (global.rs:390-398)."""
    dpos = pattern.diag_positions
    diag = torch.where(dpos >= 0, values[dpos.clamp(min=0)], 0.0)
    nonzero = diag != 0.0
    scale = diag[torch.argmax(nonzero.to(torch.int32))].abs()  # the first maximum: the first nonzero
    return torch.where(nonzero.any(), scale, torch.ones_like(scale))


def apply_homogeneous_dirichlet_bc_csr(values: torch.Tensor, pattern: CsrPattern, nodes,
                                       solution_dim: Optional[int] = None) -> torch.Tensor:
    """Zero the Dirichlet rows and columns; set their diagonals to a scale (global.rs:379-451).

    Symmetric row and column elimination with the first nonzero |diagonal|
    as the scale, by masks over the stored entries.  ``nodes`` are node
    indices; all ``solution_dim`` dofs of each are constrained.  Returns the
    new values.
    """
    s = solution_dim if solution_dim is not None else pattern.solution_dim
    dev = values.device
    is_dirichlet = torch.zeros(pattern.num_rows, dtype=torch.bool, device=dev)
    is_dirichlet[_dirichlet_dofs(nodes, s, dev)] = True
    rows, cols = pattern.rows_of_nnz.long(), pattern.col_indices.long()
    row_d = is_dirichlet[rows]
    out = torch.where(row_d | is_dirichlet[cols], 0.0, values)
    return torch.where((rows == cols) & row_d, _dirichlet_scale(values, pattern), out)


def apply_homogeneous_dirichlet_bc_rhs(rhs: torch.Tensor, nodes, solution_dim: int = 1) -> torch.Tensor:
    """Zero the Dirichlet entries of a right-hand side (global.rs:479)."""
    out = rhs.clone()
    out[_dirichlet_dofs(nodes, solution_dim, rhs.device)] = 0.0
    return out


def apply_homogeneous_dirichlet_bc_matrix(matrix: torch.Tensor, nodes, solution_dim: int = 1) -> torch.Tensor:
    """Dense variant with the mean |diagonal| as the scale (global.rs:453-477)."""
    idx = _dirichlet_dofs(nodes, solution_dim, matrix.device)
    scale = torch.diagonal(matrix).abs().mean()
    out = matrix.clone()
    out[idx, :] = 0.0
    out[:, idx] = 0.0
    out[idx, idx] = scale
    return out
