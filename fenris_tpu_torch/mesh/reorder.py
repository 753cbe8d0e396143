"""Bandwidth-reducing mesh reordering ((reverse) Cuthill–McKee).

Counterpart of ``fenris_tpu/mesh/reorder.py`` (reorder.rs:171, :236,
:54).  The banded matrix-free path needs a bandwidth-reduced node
numbering on unstructured meshes (:func:`~..ops.banded.make_banded_plan`
refuses wide windows).

:func:`cuthill_mckee` returns the permutation of the JAX package's
sequential loop (its numpy reference, pinned identical to its native C++
implementation), computed one breadth-first level at a time with tensor
operations on ``device``: the card by default, as every entry point of the
port; CPU callers pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from . import Mesh

__all__ = ["cuthill_mckee", "reverse_cuthill_mckee", "reorder_mesh"]


def _vertex_adjacency(mesh: Mesh, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """CSR adjacency ``(offsets [N + 1], neighbors)`` of the vertex graph, neighbors ascending, int64.

    Vertices are adjacent iff they share a cell.  Each cell's vertex pairs
    a < b are deduplicated as one int64 key ``min * N + max``; both
    directions of the unique edges, sorted by ``row * N + col``, are the
    rows of the JAX package's row-wise ``np.unique(axis=0)``.
    """
    nv = mesh.num_vertices
    cells = torch.as_tensor(mesh.cells, dtype=torch.int64, device=device)
    n = cells.shape[1]
    a, b = np.triu_indices(n, 1)
    lo = torch.minimum(cells[:, a], cells[:, b]).reshape(-1)
    hi = torch.maximum(cells[:, a], cells[:, b]).reshape(-1)
    keep = lo != hi
    edges = torch.unique(lo[keep] * nv + hi[keep])
    del lo, hi, keep
    lo, hi = torch.div(edges, nv, rounding_mode="floor"), edges % nv
    del edges
    directed = torch.sort(torch.cat([lo * nv + hi, hi * nv + lo])).values
    del lo, hi
    rows = torch.div(directed, nv, rounding_mode="floor")
    offsets = torch.zeros(nv + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(torch.bincount(rows, minlength=nv), 0)
    return offsets, directed - rows * nv


def cuthill_mckee(mesh: Mesh, device="cuda") -> np.ndarray:
    """Cuthill–McKee permutation: ``perm[new_index] = old_index``.

    Each connected component is seeded from its lowest-degree unvisited
    vertex (stable in index); a vertex joins the queue behind the first
    queued vertex that reaches it, and each vertex's new neighbours join in
    ascending (degree, index) order.  One breadth-first level a step: every
    (frontier position, unvisited neighbour) pair is sorted by (position,
    degree, index) and each neighbour keeps its first occurrence, which is
    the order of the sequential loop.
    """
    dev = resolve_device(device)
    nv = mesh.num_vertices
    if nv == 0:
        return np.zeros(0, dtype=np.int64)
    offsets, neighbors = _vertex_adjacency(mesh, dev)
    degree = offsets[1:] - offsets[:-1]
    order_by_degree = torch.sort(degree, stable=True).indices.cpu().numpy()
    visited = torch.zeros(nv, dtype=torch.bool, device=dev)
    first_pos = torch.zeros(nv, dtype=torch.int64, device=dev)  # read only where just written
    key_scale = int(degree.max()) + 1
    parts = []
    # isolated vertices are components of their own and come first in the seed order
    isolated = int((degree == 0).sum())
    if isolated:
        parts.append(torch.as_tensor(order_by_degree[:isolated], device=dev))
        visited[parts[0]] = True
    pos, seed_ptr = isolated, isolated
    while pos < nv:
        visited_host = visited.cpu().numpy()
        while visited_host[order_by_degree[seed_ptr]]:  # the next unvisited vertex in the seed order
            seed_ptr += 1
        frontier = torch.as_tensor(order_by_degree[seed_ptr : seed_ptr + 1], device=dev)
        visited[frontier] = True
        parts.append(frontier)
        pos += 1
        while frontier.numel():
            start, stop = offsets[frontier], offsets[frontier + 1]
            counts = stop - start
            src = torch.repeat_interleave(torch.arange(frontier.numel(), device=dev), counts)
            idx = torch.arange(src.numel(), device=dev) - torch.repeat_interleave(
                torch.cumsum(counts, 0) - counts, counts) + start[src]
            nbr = neighbors[idx]
            new = ~visited[nbr]
            src, nbr = src[new], nbr[new]
            if not nbr.numel():
                break
            # (position, degree) sorted stably keeps the ascending index within ties
            srt = torch.sort(src * key_scale + degree[nbr], stable=True).indices
            src, nbr = src[srt], nbr[srt]
            slot = torch.arange(nbr.numel(), device=dev)
            first_pos.scatter_reduce_(0, nbr, slot, reduce="amin", include_self=False)
            frontier = nbr[first_pos[nbr] == slot]
            visited[frontier] = True
            parts.append(frontier)
            pos += frontier.numel()
    return torch.cat(parts).cpu().numpy()


def reverse_cuthill_mckee(mesh: Mesh, device="cuda") -> np.ndarray:
    """Reverse Cuthill–McKee permutation (reorder.rs:236)."""
    return cuthill_mckee(mesh, device)[::-1].copy()


def reorder_mesh(mesh: Mesh, perm: Optional[np.ndarray] = None, device="cuda") -> Tuple[Mesh, np.ndarray]:
    """Apply a vertex permutation (default: RCM, computed on ``device``) to a mesh.

    Returns the permuted mesh and the permutation used (``perm[new] =
    old``).  Cells keep their order; their node indices are relabeled.  A
    given ``perm`` is applied on the host and ``device`` is not used.
    """
    if perm is None:
        perm = reverse_cuthill_mckee(mesh, device)
    perm = np.asarray(perm, dtype=np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return Mesh(mesh.points[perm], inv[mesh.cells.astype(np.int64)], mesh.element), perm
