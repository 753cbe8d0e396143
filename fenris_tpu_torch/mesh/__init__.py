"""Meshes as struct-of-arrays (host numpy).

Counterpart of the core of ``fenris_tpu/mesh/__init__.py``: a mesh
is ``(points [N, d] float64, cells [E, n] int32)`` plus its reference
element, with ``diameters`` and ``split_into_triangles``.  Topology work
stays on the host; :class:`~..fem.FemSpace` moves the arrays to the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..reference_elements import TRI3, ReferenceElement

__all__ = ["Mesh"]


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
