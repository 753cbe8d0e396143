"""Meshes as struct-of-arrays (host numpy).

Counterpart of the hex8 part of ``fenris_tpu/mesh/__init__.py``: a mesh
is ``(points [N, d] float64, cells [E, n] int32)`` plus its reference
element.  Topology work stays on the host; :class:`~..fem.FemSpace` moves
the arrays to the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..reference_elements import ReferenceElement

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
