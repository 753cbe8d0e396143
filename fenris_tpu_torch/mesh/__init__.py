"""Meshes as struct-of-arrays (host numpy).

Counterpart of ``fenris_tpu/mesh/__init__.py`` (``Mesh<T, D, Connectivity>``,
src/mesh.rs:23): a mesh is ``(points [N, d] float64, cells [E, n] int32)``
plus its reference element, with boundary faces, cells and vertices
(:154, :167, :208), ``boundary_mesh``, ``keep_cells`` (:305),
``extract_surface_mesh`` (:505), ``split_into_triangles`` (:276) and the
vertex transforms.  Every array equals the JAX package's.  Topology work
stays on the host; :class:`~..fem.FemSpace` moves the arrays to the device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Tuple

import numpy as np

from ..reference_elements import TRI3, ReferenceElement, element

__all__ = ["Mesh", "unique_rows", "procedural", "convert", "refinement", "reorder"]


def unique_rows(rows: np.ndarray, num_vertices: int, return_inverse: bool = False, return_counts: bool = False):
    """``np.unique(rows, axis=0)`` for vertex tuples ``rows [M, k]`` with entries below ``num_vertices``.

    Two columns at a time become one int64 key ``a * N + b``, which orders
    like the pair; the rows are sorted lexicographically by their keys
    with ``np.lexsort``, which is much faster than ``np.unique(axis=0)``
    (that compares rows as byte strings) at millions of rows.  Returns
    the unique rows, then the inverse and the counts if asked for.
    """
    rows = np.asarray(rows, dtype=np.int64)
    M, k = rows.shape
    n = np.int64(num_vertices)
    keys = [rows[:, i] * n + rows[:, i + 1] for i in range(0, k - 1, 2)] + ([rows[:, k - 1]] if k % 2 else [])
    order = np.lexsort(keys[::-1]) if len(keys) > 1 else np.argsort(keys[0], kind="stable")
    new = np.ones(M, dtype=bool)
    if M:
        new[1:] = np.logical_or.reduce([key[order][1:] != key[order][:-1] for key in keys])
    out = [rows[order[new]]]
    if return_inverse:
        inverse = np.empty(M, dtype=np.int64)
        inverse[order] = np.cumsum(new) - 1
        out.append(inverse)
    if return_counts:
        out.append(np.diff(np.append(np.flatnonzero(new), M)))
    return out[0] if len(out) == 1 else tuple(out)


def _relabel(num_vertices: int, cells: np.ndarray):
    """The vertices ``cells`` use (sorted) and the cells in their new labels."""
    used = np.unique(cells)
    remap = np.full(num_vertices, -1, dtype=np.int32)
    remap[used] = np.arange(len(used), dtype=np.int32)
    return used, remap[cells]


@dataclass(frozen=True)
class Mesh:
    """A homogeneous finite element mesh.

    Attributes:
        points: ``[num_vertices, dim]`` float64 vertex coordinates.
        cells: ``[num_cells, nodes_per_cell]`` int32 node indices in the
            element's reference node order.
        element: the reference element of every cell.
    """

    points: np.ndarray
    cells: np.ndarray
    element: ReferenceElement

    def __post_init__(self):
        object.__setattr__(self, "points", np.ascontiguousarray(self.points, dtype=np.float64))
        cells = np.ascontiguousarray(self.cells, dtype=np.int32)
        if cells.ndim == 1:
            cells = cells.reshape(0, self.element.num_nodes)
        if cells.shape[0] and cells.shape[1] != self.element.num_nodes:
            raise ValueError(
                f"cells have {cells.shape[1]} nodes but element {self.element.name} "
                f"has {self.element.num_nodes}"
            )
        object.__setattr__(self, "cells", cells)

    @property
    def dim(self) -> int:
        return self.points.shape[1]

    @property
    def num_vertices(self) -> int:
        return self.points.shape[0]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    def cell_points(self) -> np.ndarray:
        """Gathered node coordinates per cell: ``[E, n, dim]``."""
        return self.points[self.cells]

    def diameters(self) -> np.ndarray:
        """Per-cell diameter: the largest distance between two of its corner vertices.

        Higher-order elements measure their corner (geometry) element, as
        ``FiniteElement::diameter`` does: the first ``num_vertices`` nodes.
        """
        X = self.points[self.cells[:, : self.element.num_vertices]]  # [E, v, d]
        diff = X[:, :, None, :] - X[:, None, :, :]
        return np.sqrt((diff**2).sum(-1)).max(axis=(1, 2))

    # -- topology ----------------------------------------------------------------------------

    def _face_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """Every face of every cell: ``(faces [E * f, fn], corner_key [E * f, fv])``.

        ``faces`` holds the face connectivity (global nodes in the face
        element's order), cell by cell; ``corner_key`` its sorted corner
        vertices, which match between the two cells sharing a face.
        """
        fnodes = self.element.face_nodes()
        fel = self.element.face_element()
        nfv = fel.num_vertices if fel is not None else len(fnodes[0])
        faces = np.stack([self.cells[:, list(fn)] for fn in fnodes], axis=1)  # [E, f, fn]
        faces = faces.reshape(-1, faces.shape[-1])
        return faces, np.sort(faces[:, :nfv], axis=1)

    def _boundary_face_mask(self) -> Tuple[np.ndarray, np.ndarray]:
        faces, key = self._face_arrays()
        _, inverse, counts = unique_rows(key, self.num_vertices, return_inverse=True, return_counts=True)
        return faces, counts[inverse] == 1

    def find_boundary_faces(self) -> np.ndarray:
        """Connectivities ``[B, fn]`` of the faces that belong to one cell only, in cell order (src/mesh.rs:167)."""
        faces, mask = self._boundary_face_mask()
        return faces[mask]

    def find_boundary_cells(self) -> np.ndarray:
        """Indices of the cells with at least one boundary face (src/mesh.rs:154)."""
        _, mask = self._boundary_face_mask()
        return np.flatnonzero(mask.reshape(self.num_cells, len(self.element.face_nodes())).any(axis=1))

    def find_boundary_vertices(self) -> np.ndarray:
        """Sorted indices of the vertices on the boundary (src/mesh.rs:208)."""
        return np.unique(self.find_boundary_faces())

    def boundary_mesh(self) -> "Mesh":
        """The boundary faces as a mesh of the face element on the same vertex array."""
        fel = self.element.face_element()
        if fel is None:
            raise ValueError(f"{self.element.name} has no face element type")
        return Mesh(self.points, self.find_boundary_faces(), fel)

    def extract_surface_mesh(self) -> "Mesh":
        """:meth:`boundary_mesh` with the vertices it does not use dropped (src/mesh.rs:505)."""
        bm = self.boundary_mesh()
        used, cells = _relabel(self.num_vertices, bm.cells)
        return Mesh(self.points[used], cells, bm.element)

    # -- editing -------------------------------------------------------------------------------

    def keep_cells(self, cell_indices) -> "Mesh":
        """The given cells only, their vertices relabelled in increasing order (src/mesh.rs:305)."""
        used, cells = _relabel(self.num_vertices, self.cells[np.asarray(cell_indices, dtype=np.int64)])
        return Mesh(self.points[used], cells, self.element)

    def transform_points(self, f: Callable[[np.ndarray], np.ndarray]) -> "Mesh":
        """The mesh with ``points = f(points)`` (``f`` maps the whole ``[N, d]`` array)."""
        return replace(self, points=np.asarray(f(self.points), dtype=np.float64))

    def translate(self, offset) -> "Mesh":
        return replace(self, points=self.points + np.asarray(offset)[None, :])

    def scale(self, factor) -> "Mesh":
        return replace(self, points=self.points * factor)

    def with_element(self, el) -> "Mesh":
        """The same arrays read as another element (a name or a :class:`ReferenceElement`)."""
        return replace(self, element=element(el) if isinstance(el, str) else el)

    def __repr__(self):
        return f"Mesh({self.element.name}, {self.num_vertices} vertices, {self.num_cells} cells, dim={self.dim})"

    def split_into_triangles(self) -> "Mesh":
        """Split a quad4 mesh into tri3 cells, two a quad, in cell order (src/mesh.rs:276).

        A convex quad splits along its (0, 2) diagonal into (0, 1, 2) and
        (0, 2, 3); a quad with a concave corner c (the first corner whose
        2D cross product of its outgoing and incoming edges is negative)
        into (c+2, c+3, c) and (c+2, c, c+1), as
        ``Quad2d::split_into_triangle_connectivities`` does.
        """
        if self.element.name != "quad4":
            raise ValueError("split_into_triangles requires a quad4 mesh")
        X = self.cell_points()  # [E, 4, 2]
        nxt = X[:, [1, 2, 3, 0], :] - X
        prv = X[:, [3, 0, 1, 2], :] - X
        concave = nxt[..., 0] * prv[..., 1] - nxt[..., 1] * prv[..., 0] < 0.0  # [E, 4]
        has_concave = concave.any(axis=1)[:, None]
        c = np.where(has_concave[:, 0], concave.argmax(axis=1), 0)[:, None]
        first = np.where(has_concave, np.concatenate([c + 2, c + 3, c], 1) % 4, [0, 1, 2])
        second = np.where(has_concave, np.concatenate([c + 2, c, c + 1], 1) % 4, [0, 2, 3])
        tris = np.stack([np.take_along_axis(self.cells, first, 1), np.take_along_axis(self.cells, second, 1)], 1)
        return Mesh(self.points, tris.reshape(-1, 3), TRI3)


from . import convert, procedural, refinement, reorder  # noqa: E402  (they import Mesh)
