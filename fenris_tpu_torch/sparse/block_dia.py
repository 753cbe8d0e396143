"""Block-DIA sparse matrices: plans, deterministic assembly and plain matvecs.

Counterpart of ``fenris_tpu/sparse/block_dia.py``.  A FEM operator on a
mesh with a locality-preserving node order concentrates its node blocks
on a few *block diagonals* (27 on a uniform hex box).  In the node-minor
layout

* ``offsets [D]`` — node-index deltas (sorted Python ints);
* ``bands [D*s*s, N]`` — row ``(d*s + i)*s + j`` holds
  ``A[s*n + i, s*(n + offsets[d]) + j]`` at lane ``n``;

the product is a sweep over the bands (:mod:`..ops.dia_sweep`), and
deltas outside the selected set spill into a block-ELL remainder.

The assembly plan maps element-matrix entries straight to band slots, with
no CSR pattern.  The JAX package builds it with numpy on the host; at 3.3M
hex8 elements that sorts 212M keys, so the port builds it with the same
operations in PyTorch on the model's device, and keeps on the host only
the small per-diagonal and per-class selections (with the JAX package's
numpy calls, ties included).  Every scatter into bands goes through
:func:`~..assembly.global_.scatter_add_rows`, so assembly is bitwise
reproducible on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..assembly.global_ import scatter_add_rows, scatter_plan
from ..ops.dia_sweep import dia_sweep_plain
from .block_ell import BlockEllMatrix, block_ell_matvec, block_ell_matvec_cm

__all__ = [
    "BlockDiaMatrix",
    "BlockDiaAssemblyPlan",
    "BandExpandPlan",
    "block_dia_assembly_plan",
    "band_expand_plan",
    "expand_rows_pairs_masked",
    "assemble_block_dia",
    "block_dia_matvec",
    "block_dia_matvec_cm",
]


class BlockDiaMatrix(NamedTuple):
    offsets: Tuple[int, ...]  # D node-index deltas (sorted)
    bands: torch.Tensor  # [D*s*s, N], row (d, i, j) = (d*s + i)*s + j
    num_nodes: int
    solution_dim: int
    remainder: Optional[BlockEllMatrix]  # entries off the selected diagonals

    @property
    def shape(self):
        n = self.num_nodes * self.solution_dim
        return (n, n)

    @property
    def num_diagonals(self) -> int:
        return len(self.offsets)

    def __matmul__(self, v):
        return block_dia_matvec(self, v)


class BlockDiaAssemblyPlan(NamedTuple):
    """Map from element-matrix entries to block-DIA slots.

    Entry ``(e, a, i, b, j)`` of an element matrix lands at flat slot
    ``base[e, a, b] + (i*s + j)*N`` of the ``[(D + Kr)*s*s, N]`` stack
    (bands first, then the block-ELL remainder).
    """

    offsets: Tuple[int, ...]
    num_nodes: int
    solution_dim: int
    base: torch.Tensor  # [E, n, n] int32 (int64 beyond 2**31 slots)
    rem_neighbors: Optional[torch.Tensor]  # [Kr, N] int32, padded with N
    rem_k: int  # remainder ELL width (0 = exact DIA)
    fill: float  # fraction of band slots structurally populated

    @property
    def num_diagonals(self) -> int:
        return len(self.offsets)


def _cells_tensor(cells, device) -> torch.Tensor:
    if isinstance(cells, torch.Tensor):
        return cells.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(cells), dtype=torch.int64, device=device)


def block_dia_assembly_plan(
    cells,
    num_nodes: int,
    solution_dim: int,
    *,
    max_diagonals: Optional[int] = None,
    min_fill: float = 0.0,
    device=None,
) -> BlockDiaAssemblyPlan:
    """Element→block-DIA assembly plan from the mesh cells (``block_dia.py:203``).

    Every node delta between element node pairs becomes a band, except
    deltas whose population (distinct row nodes with that delta) is below
    ``min_fill * N``; ``max_diagonals`` caps the count (most populated
    first).  The zero offset is always kept.  Spilled deltas form the
    block-ELL remainder.  Runs on ``device`` (default: the cells' device
    for a tensor, the card for a numpy array).
    """
    device = device if device is not None else (cells.device if isinstance(cells, torch.Tensor) else "cuda")
    cells = _cells_tensor(cells, device)
    E, n = cells.shape
    s, N = int(solution_dim), int(num_nodes)
    na_flat = cells[:, :, None].expand(E, n, n).reshape(-1)  # row node cells[e, a]
    delta = cells[:, None, :].expand(E, n, n).reshape(-1) - na_flat
    K2 = 2 * N + 1
    # population = distinct row nodes per delta; key injective since |delta| < N
    pair_key = delta * K2 + na_flat
    uniq_pairs = torch.unique(pair_key)  # sorted by (delta, row node)
    u_delta = torch.div(uniq_pairs, K2, rounding_mode="floor")
    del uniq_pairs
    offs_t, pop_t = torch.unique_consecutive(u_delta, return_counts=True)
    offs, pop = offs_t.cpu().numpy(), pop_t.cpu().numpy()
    keep = (pop >= min_fill * N) | (offs == 0)
    if max_diagonals is not None and keep.sum() > max_diagonals:
        # the zero offset always takes one of the max_diagonals slots
        order = np.argsort(pop)[::-1]
        order = order[offs[order] != 0]
        kept = np.zeros(len(offs), bool)
        kept[order[: max(max_diagonals - 1, 0)]] = True
        kept[offs == 0] = True
        keep &= kept
    offsets = offs[keep]
    D = len(offsets)
    offsets_t = torch.as_tensor(offsets, dtype=torch.int64, device=device)
    fill = float(torch.isin(u_delta, offsets_t).sum()) / max(D * N, 1)
    del u_delta
    slot = torch.searchsorted(offsets_t, delta)
    on_dia = (slot < D) & (offsets_t[slot.clamp(max=D - 1)] == delta)
    del delta
    sssN = s * s * N
    base = torch.where(on_dia, slot * sssN, 0) + na_flat
    del slot

    rem_neighbors = None
    kr = 0
    off = ~on_dia
    if bool(off.any()):
        uk, inv = torch.unique(pair_key[off], return_inverse=True)
        u_na = uk % K2
        u_nb = torch.div(uk - u_na, K2, rounding_mode="floor") + u_na  # delta + row node
        # k = rank of the pair within its row node's group
        order = torch.sort(u_na, stable=True).indices
        srt = u_na[order]
        k_of_u = torch.empty_like(u_na)
        k_of_u[order] = torch.arange(len(uk), device=device) - torch.searchsorted(srt, srt)
        kr = int(k_of_u.max()) + 1
        rem_neighbors = torch.full((kr, N), N, dtype=torch.int32, device=device)
        rem_neighbors[k_of_u, u_na] = u_nb.to(torch.int32)
        base[off] = (D + k_of_u[inv]) * sssN + na_flat[off]

    total = (D + kr) * sssN
    idt = torch.int32 if total + 1 < 2**31 else torch.int64
    return BlockDiaAssemblyPlan(
        offsets=tuple(int(o) for o in offsets),
        num_nodes=N,
        solution_dim=s,
        base=base.reshape(E, n, n).to(idt),
        rem_neighbors=rem_neighbors,
        rem_k=kr,
        fill=fill,
    )


class BandExpandPlan(NamedTuple):
    """Class-static expansion plan for band assembly (``block_dia.py:300``).

    Elements whose node deltas map to identical band slots for every local
    pair (a, b) form a *slot-signature class* (a uniform hex box has one).
    Within a class, row-node a's ``s*s*n`` values (payload order (i, j, b))
    land at fixed band rows: ``src[c, a, r]`` names the payload entry for
    band row r, or ``s*s*n`` (a zero) where row r takes nothing.  That
    gather is the index form of the JAX package's 0/1 expansion operators
    ``M`` (exact either way; see :meth:`dense_operators`).
    """

    src: torch.Tensor  # [C, n, D*s*s] int64 payload index per band row
    class_mask: torch.Tensor  # [C, E] f32 membership of fast-path elements
    cols: torch.Tensor  # [E, n] int32 target nodes (the cells)
    slow_idx: Optional[torch.Tensor]  # [Ef] int64 elements for the flat scatter
    coverage: float
    num_classes: int

    def dense_operators(self, solution_dim: int) -> torch.Tensor:
        """The JAX plan's 0/1 expansion operators ``M [C, n, n*s*s, D*s*s]``."""
        C, n, R = self.src.shape
        P = n * solution_dim**2
        out = torch.zeros((C, n, P + 1, R), dtype=torch.float32, device=self.src.device)
        out.scatter_(2, self.src[:, :, None, :], 1.0)
        return out[:, :, :P]


def band_expand_plan(cells, plan: BlockDiaAssemblyPlan, *, max_classes: int = 4,
                     min_coverage: float = 0.5, device=None) -> Optional[BandExpandPlan]:
    """Class-static expansion plan for ``cells`` against ``plan``, or None.

    None when fewer than ``min_coverage`` of the elements fall into the
    ``max_classes`` most common slot signatures, or when the band count
    makes block-DIA the wrong layout.  Classes are ranked by element count
    (``np.argsort`` of the counts, as in the JAX package; signatures with
    equal counts may be ranked differently, since the unique signatures
    are listed in another order).  Runs on ``device`` (default: the plan's).
    """
    device = device if device is not None else plan.base.device
    cells = _cells_tensor(cells, device)
    E, n = cells.shape
    s, D = plan.solution_dim, plan.num_diagonals
    if D * s * s > 1024:
        return None
    offsets = torch.as_tensor(plan.offsets, dtype=torch.int64, device=device)
    delta = cells[:, None, :] - cells[:, :, None]  # [E, a, b] = col - row node
    slot = torch.searchsorted(offsets, delta)
    on = (slot < D) & (offsets[slot.clamp(max=D - 1)] == delta)
    del delta
    slot_m = torch.where(on, slot, D).reshape(E, n * n).to(torch.int32)
    ok = on.reshape(E, n * n).all(1)
    del slot, on
    if not bool(ok.any()):
        return None
    uniq, inv, counts = torch.unique(slot_m[ok], dim=0, return_inverse=True, return_counts=True)
    counts_np = counts.cpu().numpy()
    order = np.argsort(counts_np)[::-1][:max_classes]
    coverage = counts_np[order].sum() / E
    if coverage < min_coverage:
        return None
    C = len(order)
    order_t = torch.as_tensor(order.copy(), device=device)
    rank_of = torch.full((len(uniq),), -1, dtype=torch.int64, device=device)
    rank_of[order_t] = torch.arange(C, device=device)
    cls = torch.full((E,), -1, dtype=torch.int64, device=device)
    cls[ok] = rank_of[inv]

    R = D * s * s
    ii, bb, jj = np.meshgrid(np.arange(s), np.arange(n), np.arange(s), indexing="ij")
    comp = ((ii * s + jj) * n + bb).ravel()  # payload order (i, j, b)
    src = np.full((C, n, R), n * s * s, np.int64)
    sig = uniq[order_t].cpu().numpy()
    for ci in range(C):
        sl = sig[ci].reshape(n, n)
        for a in range(n):
            r = ((sl[a][bb] * s + ii) * s + jj).ravel()  # band row (d*s + i)*s + j
            src[ci, a, r] = comp
    slow = torch.nonzero(cls < 0).reshape(-1)
    return BandExpandPlan(
        src=torch.as_tensor(src, device=device),
        class_mask=(cls[None, :] == torch.arange(C, device=device)[:, None]).to(torch.float32),
        cols=cells.to(torch.int32),
        slow_idx=slow if len(slow) else None,
        coverage=float(coverage),
        num_classes=C,
    )


def expand_rows_pairs_masked(vals, cb, mb, src):
    """Class-masked band-row expansion (``block_dia.py:398``).

    ``vals [s*s, n*n, e]``: element matrices in the pairs layout;
    ``cb [e, n]``: row node per (element, a); ``mb [C, e]``: class
    membership (vals' dtype); ``src``: :attr:`BandExpandPlan.src`.
    Returns ``(rows [n*e, R], ids [n*e])``, a-major.  Exact: each band row
    takes one payload value (or zero) per class, and classes are disjoint.
    """
    ss, nn, e = vals.shape
    C, n, R = src.shape
    payload = vals.reshape(ss, n, n, e).permute(1, 3, 0, 2).reshape(n, e, ss * n)  # [a, e, (p, b)]
    payload = F.pad(payload, (0, 1))  # the zero a band row takes when no payload maps to it
    rows = vals.new_empty((n, e, R))
    for a in range(n):
        torch.index_select(payload[a], 1, src[0, a], out=rows[a])
        rows[a].mul_(mb[0][:, None])
        for c in range(1, C):
            rows[a].addcmul_(payload[a].index_select(1, src[c, a]), mb[c][:, None])
    return rows.reshape(n * e, R), cb.T.reshape(-1).long()


def _expand_scatter(A_el, expand: BandExpandPlan, s: int, N: int, num_chunks: int):
    """Band region ``[N, D*s*s]`` (node-major) by class expansion + row scatter."""
    E, nd = A_el.shape[0], A_el.shape[1]
    n = nd // s
    R = expand.src.shape[-1]
    acc = A_el.new_zeros((N, R))
    chunk = max(1, -(-E // max(num_chunks, 1)))
    mask = expand.class_mask.to(A_el.dtype)
    for e0 in range(0, E, chunk):
        Ab = A_el[e0 : e0 + chunk]
        vals = Ab.reshape(-1, n, s, n, s).permute(2, 4, 1, 3, 0).reshape(s * s, n * n, -1)
        rows, ids = expand_rows_pairs_masked(vals, expand.cols[e0 : e0 + chunk], mask[:, e0 : e0 + chunk], expand.src)
        scatter_add_rows(acc, scatter_plan(ids), rows, inplace=True)
    return acc


def _scatter_dia(A_el, base, out, s: int, N: int, num_chunks: int = 1):
    """Flat per-entry scatter of element matrices into ``out [total]`` (in place)."""
    E, nd = A_el.shape[0], A_el.shape[1]
    n = nd // s
    ij = (torch.arange(s * s, device=A_el.device) * N)[:, None]
    chunk = max(1, -(-E // max(num_chunks, 1)))
    for e0 in range(0, E, chunk):
        Ab, bb = A_el[e0 : e0 + chunk], base[e0 : e0 + chunk]
        v = Ab.reshape(-1, n, s, n, s).permute(2, 4, 0, 1, 3).reshape(-1)  # (i, j, e, a, b)
        idx = (ij + bb.reshape(1, -1).long()).reshape(-1)
        scatter_add_rows(out, scatter_plan(idx), v, inplace=True)
    return out


def assemble_block_dia(plan: BlockDiaAssemblyPlan, element_matrices, num_chunks: int = 1,
                       expand: Optional[BandExpandPlan] = None) -> BlockDiaMatrix:
    """Numeric assembly: element matrices ``[E, n*s, n*s]`` → :class:`BlockDiaMatrix`.

    Without ``expand``: every entry scattered to its flat slot.  With it:
    in-class elements by class expansion + one row scatter, the rest by
    the flat scatter.  ``num_chunks`` bounds the transients.
    """
    s, N, D, kr = plan.solution_dim, plan.num_nodes, plan.num_diagonals, plan.rem_k
    total = (D + kr) * s * s * N
    A = element_matrices
    if expand is not None:
        bands = _expand_scatter(A, expand, s, N, int(num_chunks)).T.contiguous()
        rem_blocks = A.new_zeros((kr * s * s, N)) if kr else None
        if expand.slow_idx is not None:
            flat = _scatter_dia(A[expand.slow_idx], plan.base[expand.slow_idx], A.new_zeros(total), s, N)
            bands = bands + flat[: D * s * s * N].reshape(D * s * s, N)
            if kr:
                rem_blocks = flat[D * s * s * N :].reshape(kr * s * s, N)
    else:
        flat = _scatter_dia(A, plan.base, A.new_zeros(total), s, N, int(num_chunks))
        bands = flat[: D * s * s * N].reshape(D * s * s, N)
        rem_blocks = flat[D * s * s * N :].reshape(kr * s * s, N) if kr else None
    remainder = None
    if kr:
        remainder = BlockEllMatrix(neighbors=plan.rem_neighbors, blocks=rem_blocks, num_nodes=N, solution_dim=s)
    return BlockDiaMatrix(offsets=plan.offsets, bands=bands, num_nodes=N, solution_dim=s, remainder=remainder)


def block_dia_matvec_cm(m: BlockDiaMatrix, x2: torch.Tensor) -> torch.Tensor:
    """Component-major ``y2 [s, N] = A x2 [s, N]`` (plain band sweep + remainder)."""
    out = dia_sweep_plain(m.bands, m.offsets, x2)
    if m.remainder is not None:
        out = out + block_ell_matvec_cm(m.remainder, x2)
    return out


def block_dia_matvec(m: BlockDiaMatrix, v: torch.Tensor) -> torch.Tensor:
    """Node-major ``y = A v`` on flat ``[N*s]`` vectors (the same sums)."""
    s, N = m.solution_dim, m.num_nodes
    out = dia_sweep_plain(m.bands, m.offsets, v.reshape(N, s).T).T.reshape(-1)
    if m.remainder is not None:
        out = out + block_ell_matvec(m.remainder, v)
    return out
