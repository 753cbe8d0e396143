"""Uniform (red) refinement of hex8 meshes and its prolongation.

Counterpart of the hex8 part of ``fenris_tpu/mesh/refinement.py``
(refinement.rs:116, :128): every cell splits into eight, new vertices are
numbered exactly as in the JAX package — the coarse vertices, then one
midpoint per unique edge, one centre per unique face, one centre per cell,
each group in the lexicographic order of its sorted corner tuples (the
order of ``np.unique(axis=0)``).  The port finds that order with integer
keys and ``np.lexsort`` rather than ``np.unique(axis=0)``, which compares
rows as byte strings and is slow at millions of rows.

The JAX package also refines tri3, quad4 and tet4; their refinement is
not ported yet, so every element but hex8 raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..reference_elements import HEX8
from . import Mesh

__all__ = ["refine_uniformly", "refine_uniformly_repeat", "prolongation_for_refinement"]


def _check_hex8(mesh: Mesh) -> None:
    if mesh.element.name != "hex8":
        raise NotImplementedError(
            f"uniform refinement of {mesh.element.name} meshes is not ported yet (the port refines hex8 only)"
        )


def _unique_rows(rows: np.ndarray, num_vertices: int, return_inverse: bool = False):
    """``np.unique(rows, axis=0)`` for sorted vertex tuples ``rows [M, k]`` (k = 2 or 4).

    Pairs of vertices become one int64 key ``a * N + b``, which orders like
    the pair; rows are then sorted lexicographically by their keys.
    """
    rows = np.asarray(rows, dtype=np.int64)
    M, k = rows.shape
    n = np.int64(num_vertices)
    keys = [rows[:, i] * n + rows[:, i + 1] for i in range(0, k, 2)]
    order = np.lexsort(keys[::-1]) if len(keys) > 1 else np.argsort(keys[0], kind="stable")
    sk = [key[order] for key in keys]
    new = np.ones(M, dtype=bool)
    if M:
        new[1:] = np.logical_or.reduce([s[1:] != s[:-1] for s in sk])
    uniq = rows[order[new]]
    if not return_inverse:
        return uniq
    inverse = np.empty(M, dtype=np.int64)
    inverse[order] = np.cumsum(new) - 1
    return uniq, inverse


def _edge_keys(cells: np.ndarray) -> np.ndarray:
    """Sorted vertex pairs of every cell's edges, ``[E * 12, 2]`` (cell-major, edge order of HEX8)."""
    pairs = np.stack([np.stack([cells[:, a], cells[:, b]], axis=-1) for a, b in HEX8.edges], axis=1)
    return np.sort(pairs, axis=-1).reshape(-1, 2)


def _face_keys(cells: np.ndarray) -> np.ndarray:
    """Sorted corner tuples of every cell's faces, ``[E * 6, 4]``."""
    return np.sort(np.stack([cells[:, list(f)] for f in HEX8.faces], axis=1), axis=-1).reshape(-1, 4)


def refine_uniformly(mesh: Mesh) -> Mesh:
    """One level of red refinement: eight hex8 children a cell."""
    _check_hex8(mesh)
    cells = mesh.cells.astype(np.int64)
    E, N = mesh.num_cells, mesh.num_vertices
    edges = HEX8.edges
    uniq, inverse = _unique_rows(_edge_keys(cells), N, return_inverse=True)
    mids = (mesh.points[uniq[:, 0]] + mesh.points[uniq[:, 1]]) / 2.0
    eidx = (N + inverse).reshape(E, len(edges))
    edge_pos = {e: i for i, e in enumerate(edges)}

    def emid(i, j):
        return eidx[:, edge_pos[(i, j)] if (i, j) in edge_pos else edge_pos[(j, i)]]

    faces = HEX8.faces
    funiq, finv = _unique_rows(_face_keys(cells), N, return_inverse=True)
    fpts = mesh.points[funiq].mean(axis=1)
    foffset = N + len(mids)
    fidx = (foffset + finv).reshape(E, len(faces))
    fpos = {tuple(sorted(f)): i for i, f in enumerate(faces)}

    def fmid(*vs):
        return fidx[:, fpos[tuple(sorted(vs))]]

    centers = mesh.cell_points().mean(axis=1)
    cc = foffset + len(fpts) + np.arange(E)
    v = [cells[:, i] for i in range(8)]
    # the child at corner i spans the corner, its three edge midpoints, its
    # three face centres and the cell centre (the JAX package's table)
    corner_children = [
        (0, (0, 1), (0, 3), (0, 4), (0, 1, 2, 3), (0, 1, 5, 4), (0, 3, 7, 4)),
        (1, (1, 2), (0, 1), (1, 5), (0, 1, 2, 3), (1, 2, 6, 5), (0, 1, 5, 4)),
        (2, (2, 3), (1, 2), (2, 6), (0, 1, 2, 3), (2, 3, 7, 6), (1, 2, 6, 5)),
        (3, (0, 3), (2, 3), (3, 7), (0, 1, 2, 3), (0, 3, 7, 4), (2, 3, 7, 6)),
        (4, (4, 5), (4, 7), (0, 4), (4, 5, 6, 7), (0, 1, 5, 4), (0, 3, 7, 4)),
        (5, (5, 6), (4, 5), (1, 5), (4, 5, 6, 7), (1, 2, 6, 5), (0, 1, 5, 4)),
        (6, (6, 7), (5, 6), (2, 6), (4, 5, 6, 7), (2, 3, 7, 6), (1, 2, 6, 5)),
        (7, (4, 7), (6, 7), (3, 7), (4, 5, 6, 7), (0, 3, 7, 4), (2, 3, 7, 6)),
    ]
    children = []
    for corner, ea, eb, ec, fa, fb, fc in corner_children:
        outer = [v[corner], emid(*ea), fmid(*fa), emid(*eb)]
        inner = [emid(*ec), fmid(*fb), cc, fmid(*fc)]
        children.append(np.stack(outer + inner if corner < 4 else inner + outer, -1))
    children = np.stack(children, axis=1).reshape(-1, 8)
    return Mesh(np.concatenate([mesh.points, mids, fpts, centers]), children, mesh.element)


def refine_uniformly_repeat(mesh: Mesh, times: int) -> Mesh:
    for _ in range(times):
        mesh = refine_uniformly(mesh)
    return mesh


def prolongation_for_refinement(mesh: Mesh) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse prolongation from ``mesh`` to ``refine_uniformly(mesh)``.

    Returns ``(parents [N_fine, 8] int32, weights [N_fine, 8] float64)``:
    fine nodal values of a Q1 field are ``sum_k weights[n, k] *
    u_coarse[parents[n, k]]`` (restriction is the transpose).  Rows follow
    :func:`refine_uniformly`'s vertex order: coarse vertices (weight 1),
    edge midpoints (1/2 each end), face centres (1/4 each corner), cell
    centres (1/8 each node); unused slots hold parent 0 with weight 0.
    """
    _check_hex8(mesh)
    cells = mesh.cells.astype(np.int64)
    N = mesh.num_vertices
    blocks = [
        (np.arange(N, dtype=np.int64)[:, None], 1.0),
        (_unique_rows(_edge_keys(cells), N), 0.5),
        (_unique_rows(_face_keys(cells), N), 0.25),
        (cells, 1.0 / cells.shape[1]),
    ]
    kmax = max(b[0].shape[1] for b in blocks)
    parents, weights = [], []
    for par, w in blocks:
        n, k = par.shape
        p = np.zeros((n, kmax), dtype=np.int32)
        p[:, :k] = par
        wts = np.zeros((n, kmax))
        wts[:, :k] = w
        parents.append(p)
        weights.append(wts)
    return np.concatenate(parents), np.concatenate(weights)
