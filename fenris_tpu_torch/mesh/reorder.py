"""Bandwidth-reducing mesh reordering ((reverse) Cuthill–McKee).

Counterpart of ``fenris_tpu/mesh/reorder.py`` (reorder.rs:171, :236,
:54): the numpy Cuthill–McKee of the JAX package (its semantic
reference, pinned identical to its native C++ implementation), run on
the host.  The banded matrix-free path needs a bandwidth-reduced node
numbering on unstructured meshes
(:func:`~..ops.banded.make_banded_plan` refuses wide windows).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from . import Mesh

__all__ = ["cuthill_mckee", "reverse_cuthill_mckee", "reorder_mesh"]


def _vertex_adjacency(mesh: Mesh) -> Tuple[np.ndarray, np.ndarray]:
    """CSR adjacency ``(offsets, neighbors)`` of the vertex graph, neighbors ascending.

    Vertices are adjacent iff they share a cell.  The (row, col) pairs are
    deduplicated as one int64 key each, which sorts them like the JAX
    package's row-wise ``np.unique(axis=0)``.
    """
    cells = mesh.cells.astype(np.int64)
    n = cells.shape[1]
    nv = mesh.num_vertices
    rows = np.repeat(cells, n, axis=1).reshape(-1)
    cols = np.tile(cells, (1, n)).reshape(-1)
    mask = rows != cols
    keys = np.unique(rows[mask] * nv + cols[mask])
    offsets = np.searchsorted(keys // nv, np.arange(nv + 1))
    return offsets, keys % nv


def cuthill_mckee(mesh: Mesh) -> np.ndarray:
    """Cuthill–McKee permutation: ``perm[new_index] = old_index``.

    Each connected component is seeded from its lowest-degree unvisited
    vertex; new neighbors are appended in ascending (degree, index) order.
    """
    offsets, neighbors = _vertex_adjacency(mesh)
    nv = mesh.num_vertices
    degree = np.diff(offsets)
    visited = np.zeros(nv, dtype=bool)
    perm = np.empty(nv, dtype=np.int64)
    pos = 0
    order_by_degree = np.argsort(degree, kind="stable")
    seed_ptr = 0
    while pos < nv:
        while seed_ptr < nv and visited[order_by_degree[seed_ptr]]:
            seed_ptr += 1
        seed = order_by_degree[seed_ptr]
        visited[seed] = True
        perm[pos] = seed
        head = pos
        pos += 1
        while head < pos:
            u = perm[head]
            head += 1
            nbrs = neighbors[offsets[u] : offsets[u + 1]]
            new = nbrs[~visited[nbrs]]
            if len(new):
                # neighbors are unique and ascending already
                new = new[np.argsort(degree[new], kind="stable")]
                visited[new] = True
                perm[pos : pos + len(new)] = new
                pos += len(new)
    return perm


def reverse_cuthill_mckee(mesh: Mesh) -> np.ndarray:
    """Reverse Cuthill–McKee permutation (reorder.rs:236)."""
    return cuthill_mckee(mesh)[::-1].copy()


def reorder_mesh(mesh: Mesh, perm: Optional[np.ndarray] = None) -> Tuple[Mesh, np.ndarray]:
    """Apply a vertex permutation (default: RCM) to a mesh.

    Returns the permuted mesh and the permutation used (``perm[new] =
    old``).  Cells keep their order; their node indices are relabeled.
    """
    if perm is None:
        perm = reverse_cuthill_mckee(mesh)
    perm = np.asarray(perm, dtype=np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return Mesh(mesh.points[perm], inv[mesh.cells.astype(np.int64)], mesh.element), perm
