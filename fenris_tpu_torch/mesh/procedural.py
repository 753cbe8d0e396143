"""Procedural hex8 meshes.

Counterpart of ``create_rectangular_uniform_hex_mesh`` and
``create_unit_box_uniform_hex_mesh_3d`` in
``fenris_tpu/mesh/procedural.py`` (procedural.rs:216, :30), with the same
vertex and cell numbering, so vectors compare one to one.
"""

from __future__ import annotations

import numpy as np

from ..reference_elements import HEX8
from . import Mesh

__all__ = ["create_rectangular_uniform_hex_mesh", "create_unit_box_uniform_hex_mesh_3d"]


def create_rectangular_uniform_hex_mesh(
    unit_length: float, units_x: int, units_y: int, units_z: int, cells_per_unit: int
) -> Mesh:
    """Uniform hex mesh of ``[0, u*ux] x [0, u*uy] x [0, u*uz]``.

    Vertices are numbered x fastest, then y, then z; cells likewise, with
    the hex8 corner order (counter-clockwise on the bottom face, then on
    the top face).
    """
    if cells_per_unit == 0 or units_x == 0 or units_y == 0:
        return Mesh(np.zeros((0, 3)), np.zeros((0, 8), np.int32), HEX8)
    cell = float(unit_length) / cells_per_unit
    ncx, ncy, ncz = (u * cells_per_unit for u in (units_x, units_y, units_z))
    nvx, nvy = ncx + 1, ncy + 1
    k, j, i = np.meshgrid(np.arange(ncz + 1), np.arange(ncy + 1), np.arange(ncx + 1), indexing="ij")
    pts = np.stack([i.reshape(-1), j.reshape(-1), k.reshape(-1)], axis=-1) * cell

    def vid(ii, jj, kk):
        return (nvx * nvy) * kk + nvx * jj + ii

    ck, cj, ci = np.meshgrid(np.arange(ncz), np.arange(ncy), np.arange(ncx), indexing="ij")
    ci, cj, ck = ci.reshape(-1), cj.reshape(-1), ck.reshape(-1)
    cells = np.stack(
        [
            vid(ci, cj, ck),
            vid(ci + 1, cj, ck),
            vid(ci + 1, cj + 1, ck),
            vid(ci, cj + 1, ck),
            vid(ci, cj, ck + 1),
            vid(ci + 1, cj, ck + 1),
            vid(ci + 1, cj + 1, ck + 1),
            vid(ci, cj + 1, ck + 1),
        ],
        axis=-1,
    )
    return Mesh(pts, cells, HEX8)


def create_unit_box_uniform_hex_mesh_3d(cells_per_dim: int) -> Mesh:
    """Uniform hex mesh of the unit box with ``cells_per_dim`` cells per axis."""
    return create_rectangular_uniform_hex_mesh(1.0, 1, 1, 1, cells_per_dim)
