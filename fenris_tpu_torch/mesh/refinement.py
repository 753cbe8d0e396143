"""Uniform (red) refinement of tri3, quad4, tet4 and hex8 meshes and its prolongation.

Counterpart of ``fenris_tpu/mesh/refinement.py`` (refinement.rs:116,
:128): every cell splits into four (2D) or eight (3D), and new vertices
are numbered exactly as in the JAX package: the coarse vertices, then one
midpoint per unique edge, one centre per unique face (hex8), one centre
per cell (quad4, hex8), each group in the lexicographic order of its
sorted corner tuples (the order of ``np.unique(axis=0)``).  The port finds
that order with integer keys and ``np.lexsort``
(:func:`~fenris_tpu_torch.mesh.unique_rows`).  Other elements raise the JAX
package's ``ValueError``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..reference_elements import HEX8
from . import Mesh, unique_rows

__all__ = ["refine_uniformly", "refine_uniformly_repeat", "prolongation_for_refinement"]

#: the edges whose midpoints refinement adds, in the JAX package's order (it numbers the midpoints by them)
_EDGES = {
    "tri3": ((0, 1), (1, 2), (2, 0)),
    "quad4": ((0, 1), (1, 2), (2, 3), (3, 0)),
    "tet4": ((0, 1), (1, 2), (0, 2), (0, 3), (2, 3), (1, 3)),
    "hex8": HEX8.edges,
}


def _edges_of(mesh: Mesh):
    name = mesh.element.name
    if name not in _EDGES:
        raise ValueError(f"uniform refinement not supported for {name}")
    return _EDGES[name]


def _edge_keys(cells: np.ndarray, edges) -> np.ndarray:
    """Sorted vertex pairs of every cell's edges, ``[E * len(edges), 2]``, cell-major."""
    pairs = np.stack([np.stack([cells[:, a], cells[:, b]], axis=-1) for a, b in edges], axis=1)
    return np.sort(pairs, axis=-1).reshape(-1, 2)


def _face_keys(cells: np.ndarray) -> np.ndarray:
    """Sorted corner tuples of every hex8 cell's faces, ``[E * 6, 4]``."""
    return np.sort(np.stack([cells[:, list(f)] for f in HEX8.faces], axis=1), axis=-1).reshape(-1, 4)


def _children(corners, count):
    """``[E * len(corners), count]`` cells from per-child lists of ``[E]`` vertex columns."""
    return np.stack([np.stack(c, -1) for c in corners], axis=1).reshape(-1, count)


def refine_uniformly(mesh: Mesh) -> Mesh:
    """One level of red refinement: four children a cell in 2D, eight in 3D."""
    edges, name = _edges_of(mesh), mesh.element.name
    cells = mesh.cells.astype(np.int64)
    E, N = mesh.num_cells, mesh.num_vertices
    uniq, inverse = unique_rows(_edge_keys(cells, edges), N, return_inverse=True)
    mids = (mesh.points[uniq[:, 0]] + mesh.points[uniq[:, 1]]) / 2.0
    eidx = (N + inverse).reshape(E, len(edges))
    v = [cells[:, i] for i in range(cells.shape[1])]
    m = [eidx[:, i] for i in range(len(edges))]
    if name == "tri3":  # (a, d, f), (d, b, e), (f, e, c), (d, e, f): detail.rs:122-127
        children = _children([[v[0], m[0], m[2]], [m[0], v[1], m[1]], [m[2], m[1], v[2]], [m[0], m[1], m[2]]], 3)
        return Mesh(np.concatenate([mesh.points, mids]), children, mesh.element)
    if name == "quad4":
        centers = mesh.cell_points().mean(axis=1)
        c = N + len(mids) + np.arange(E)
        children = _children([[v[0], m[0], c, m[3]], [m[0], v[1], m[1], c], [c, m[1], v[2], m[2]],
                              [m[3], c, m[2], v[3]]], 4)
        return Mesh(np.concatenate([mesh.points, mids, centers]), children, mesh.element)
    if name == "tet4":
        m01, m12, m02, m03, m23, m13 = m
        # four corner tets, then the central octahedron split along its (m02, m13) diagonal into four, each
        # (m02, m13, next, current) around the equator m01 -> m03 -> m23 -> m12: orientation kept
        eq = [m01, m03, m23, m12]
        children = _children([[v[0], m01, m02, m03], [m01, v[1], m12, m13], [m02, m12, v[2], m23],
                              [m03, m13, m23, v[3]]] + [[m02, m13, eq[(i + 1) % 4], eq[i]] for i in range(4)], 4)
        return Mesh(np.concatenate([mesh.points, mids]), children, mesh.element)
    edge_pos = {e: i for i, e in enumerate(edges)}

    def emid(i, j):
        return eidx[:, edge_pos[(i, j)] if (i, j) in edge_pos else edge_pos[(j, i)]]

    faces = HEX8.faces
    funiq, finv = unique_rows(_face_keys(cells), N, return_inverse=True)
    fpts = mesh.points[funiq].mean(axis=1)
    foffset = N + len(mids)
    fidx = (foffset + finv).reshape(E, len(faces))
    fpos = {tuple(sorted(f)): i for i, f in enumerate(faces)}

    def fmid(*vs):
        return fidx[:, fpos[tuple(sorted(vs))]]

    centers = mesh.cell_points().mean(axis=1)
    cc = foffset + len(fpts) + np.arange(E)
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

    Returns ``(parents [N_fine, k] int32, weights [N_fine, k] float64)``
    (k = 2 for tri3 and tet4, 4 for quad4, 8 for hex8): fine nodal values
    of a P1/Q1 field are ``sum_k weights[n, k] * u_coarse[parents[n, k]]``
    (restriction is the transpose).  Rows follow :func:`refine_uniformly`'s
    vertex order: coarse vertices (weight 1), edge midpoints (1/2 each
    end), hex8 face centres (1/4 each corner), quad4 and hex8 cell centres
    (1/n each node); unused slots hold parent 0 with weight 0.
    """
    edges, name = _edges_of(mesh), mesh.element.name
    cells = mesh.cells.astype(np.int64)
    N = mesh.num_vertices
    blocks = [(np.arange(N, dtype=np.int64)[:, None], 1.0), (unique_rows(_edge_keys(cells, edges), N), 0.5)]
    if name == "hex8":
        blocks.append((unique_rows(_face_keys(cells), N), 0.25))
    if name in ("quad4", "hex8"):
        blocks.append((cells, 1.0 / cells.shape[1]))
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
