"""Procedural quad4, tri3, hex8 and tet4 meshes, and meshes of 2D signed distance functions.

Counterpart of ``create_rectangular_uniform_quad_mesh_2d``,
``create_unit_square_uniform_quad_mesh_2d``,
``create_unit_square_uniform_tri_mesh_2d``,
``create_rectangular_uniform_hex_mesh``,
``create_unit_box_uniform_hex_mesh_3d``, ``create_rectangular_uniform_tet_mesh``,
``create_unit_box_uniform_tet_mesh_3d``, ``voxelize_bounding_box_2d``,
``voxelize_sdf_2d``, ``approximate_quad_mesh_for_sdf_2d`` and
``approximate_triangle_mesh_for_sdf_2d`` and ``create_simple_stupid_sphere``
in ``fenris_tpu/mesh/procedural.py`` (procedural.rs:46, :15, :22, :216, :30,
:286, :37, :96, :140, :156, :178, :405),
with the same vertex and cell numbering, so vectors compare one to one.
"""

from __future__ import annotations

import numpy as np

from ..reference_elements import HEX8, QUAD4, TET4
from . import Mesh

__all__ = [
    "create_rectangular_uniform_quad_mesh_2d",
    "create_unit_square_uniform_quad_mesh_2d",
    "create_unit_square_uniform_tri_mesh_2d",
    "create_rectangular_uniform_hex_mesh",
    "create_unit_box_uniform_hex_mesh_3d",
    "create_rectangular_uniform_tet_mesh",
    "create_unit_box_uniform_tet_mesh_3d",
    "voxelize_bounding_box_2d",
    "voxelize_sdf_2d",
    "approximate_quad_mesh_for_sdf_2d",
    "approximate_triangle_mesh_for_sdf_2d",
    "create_simple_stupid_sphere",
]


def create_rectangular_uniform_quad_mesh_2d(
    unit_length: float, units_x: int, units_y: int, cells_per_unit: int, top_left=(0.0, 1.0)
) -> Mesh:
    """Uniform quad mesh of ``units_x x units_y`` squares of side ``unit_length`` below and right of
    ``top_left``.

    Vertices are numbered row by row from the top left (x fastest, rows
    going down in y); cells likewise, each as (bottom left, bottom right,
    top right, top left).
    """
    if cells_per_unit == 0 or units_x == 0 or units_y == 0:
        return Mesh(np.zeros((0, 2)), np.zeros((0, 4), np.int32), QUAD4)
    cell = float(unit_length) / cells_per_unit
    ncx, ncy = units_x * cells_per_unit, units_y * cells_per_unit
    j, i = np.meshgrid(np.arange(ncy + 1), np.arange(ncx + 1), indexing="ij")
    pts = np.stack([top_left[0] + i.reshape(-1) * cell, top_left[1] - j.reshape(-1) * cell], axis=-1)

    def vid(ii, jj):
        return (ncx + 1) * jj + ii

    cj, ci = np.meshgrid(np.arange(ncy), np.arange(ncx), indexing="ij")
    ci, cj = ci.reshape(-1), cj.reshape(-1)
    cells = np.stack([vid(ci, cj + 1), vid(ci + 1, cj + 1), vid(ci + 1, cj), vid(ci, cj)], axis=-1)
    return Mesh(pts, cells, QUAD4)


def create_unit_square_uniform_quad_mesh_2d(cells_per_dim: int) -> Mesh:
    """Uniform quad mesh of the unit square with ``cells_per_dim`` cells per axis."""
    return create_rectangular_uniform_quad_mesh_2d(1.0, 1, 1, cells_per_dim, (0.0, 1.0))


def create_unit_square_uniform_tri_mesh_2d(cells_per_dim: int) -> Mesh:
    """The unit square's quad mesh with every quad split into two triangles (``Mesh.split_into_triangles``)."""
    return create_unit_square_uniform_quad_mesh_2d(cells_per_dim).split_into_triangles()


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


# positive-direction shared-face vertex offsets per axis (procedural.rs:333)
_FACE_DELTAS = np.array(
    [
        [[1, 0, 1], [1, 1, 1], [1, 1, 0], [1, 0, 0]],
        [[0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1]],
        [[0, 1, 1], [1, 1, 1], [1, 0, 1], [0, 0, 1]],
    ]
)


def create_rectangular_uniform_tet_mesh(
    unit_length: float, units_x: int, units_y: int, units_z: int, cells_per_unit: int
) -> Mesh:
    """BCC-lattice tet mesh of ``[0, u*ux] x [0, u*uy] x [0, u*uz]``.

    The hex grid's vertices (x fastest), then its cell centres; the
    octahedron around each pair of adjacent centres splits into four tets,
    each boundary face's pyramid into two with alternating diagonals.
    Tets are grouped by axis, then interior octahedra, negative-side and
    positive-side pyramids, as in the JAX package.
    """
    if units_x == 0 or units_y == 0 or units_z == 0 or cells_per_unit == 0:
        return Mesh(np.zeros((0, 3)), np.zeros((0, 4), np.int32), TET4)
    cell = float(unit_length) / cells_per_unit
    cx, cy, cz = (u * cells_per_unit for u in (units_x, units_y, units_z))
    vx, vy = cx + 1, cy + 1
    k, j, i = np.meshgrid(np.arange(cz + 1), np.arange(cy + 1), np.arange(cx + 1), indexing="ij")
    grid_pts = np.stack([i.reshape(-1), j.reshape(-1), k.reshape(-1)], axis=-1) * cell
    k, j, i = np.meshgrid(np.arange(cz), np.arange(cy), np.arange(cx), indexing="ij")
    cells_ijk = np.stack([i.reshape(-1), j.reshape(-1), k.reshape(-1)], axis=-1)
    pts = np.concatenate([grid_pts, (cells_ijk + 0.5) * cell], axis=0)
    center_offset = grid_pts.shape[0]

    def vid(c):
        return (vx * vy) * c[..., 2] + vx * c[..., 1] + c[..., 0]

    def cid(c):
        return (cx * cy) * c[..., 2] + cx * c[..., 1] + c[..., 0] + center_offset

    conn = []
    num_cells = np.array([cx, cy, cz])
    for axis in range(3):
        delta = np.zeros(3, dtype=np.int64)
        delta[axis] = 1
        # interior octahedra: four tets around each centre-centre edge
        cc = cells_ijk[cells_ijk[:, axis] + 1 < num_cells[axis]]
        if len(cc):
            shared = vid(cc[:, None, :] + _FACE_DELTAS[axis][None, :, :])  # [m, 4]
            c1, c2 = cid(cc), cid(cc + delta[None, :])
            for t in range(4):
                conn.append(np.stack([c1, c2, shared[:, (t + 1) % 4], shared[:, t]], axis=-1))
        # boundary pyramids, negative side then positive side
        for positive in (False, True):
            on = cells_ijk[:, axis] + 1 == num_cells[axis] if positive else cells_ijk[:, axis] == 0
            cc = cells_ijk[on]
            if not len(cc):
                continue
            fverts = cc[:, None, :] + _FACE_DELTAS[axis][None, :, :]
            if not positive:
                fverts = fverts[:, ::-1, :].copy()
                fverts[..., axis] -= 1
            a, b, c, d = (vid(fverts[:, t, :]) for t in range(4))
            center = cid(cc)
            even = (cc.sum(axis=1) % 2 == 0)[:, None]
            conn.append(np.where(even, np.stack([a, b, c, center], -1), np.stack([a, b, d, center], -1)))
            conn.append(np.where(even, np.stack([a, c, d, center], -1), np.stack([b, c, d, center], -1)))
    return Mesh(pts, np.concatenate(conn, axis=0), TET4)


def create_unit_box_uniform_tet_mesh_3d(cells_per_dim: int) -> Mesh:
    """BCC tet mesh of the unit box with ``cells_per_dim`` hex cells per axis."""
    return create_rectangular_uniform_tet_mesh(1.0, 1, 1, 1, cells_per_dim)


# -- SDF voxelization ------------------------------------------------------------------------


def voxelize_bounding_box_2d(min_corner, max_corner, max_cell_size: float) -> Mesh:
    """Uniform quad mesh covering the box enlarged by 1% a side, cells no larger than ``max_cell_size``
    (procedural.rs:96)."""
    lo = np.asarray(min_corner, dtype=np.float64)
    hi = np.asarray(max_corner, dtype=np.float64)
    if max_cell_size <= 0:
        raise ValueError("max cell size must be positive")
    ext = hi - lo
    ext2 = (hi + ext * 0.01) - (lo - ext * 0.01)
    cell = float(np.min(ext2 / np.ceil(ext2 / max_cell_size)))
    n = np.ceil(ext2 / cell).astype(int)
    final_ext = n * cell
    center = (lo + hi) / 2.0
    top_left = (center[0] - final_ext[0] / 2.0, center[1] + final_ext[1] / 2.0)
    return create_rectangular_uniform_quad_mesh_2d(cell, int(n[0]), int(n[1]), 1, top_left)


def _inside_cells(mesh: Mesh, sdf) -> np.ndarray:
    """Cells with at least one vertex where the SDF is <= 0."""
    phi = np.asarray(sdf.eval(mesh.points))
    return np.flatnonzero((phi[mesh.cells] <= 0.0).any(axis=1))


def voxelize_sdf_2d(sdf, max_cell_size: float) -> Mesh:
    """The quads of the voxelized bounding box with a vertex inside the SDF (procedural.rs:140).

    ``sdf`` has ``bounding_box() -> (min, max)`` and a vectorised
    ``eval(points [N, 2]) -> [N]``.
    """
    lo, hi = sdf.bounding_box()
    mesh = voxelize_bounding_box_2d(lo, hi, max_cell_size)
    return mesh.keep_cells(_inside_cells(mesh, sdf))


def _project_outside_vertices(mesh: Mesh, sdf) -> Mesh:
    """Vertices outside the SDF moved along its ``gradient(points [N, 2]) -> [N, 2]`` onto the zero level."""
    phi = np.asarray(sdf.eval(mesh.points))
    grad = np.asarray(sdf.gradient(mesh.points))
    pts = mesh.points - np.where((phi > 0.0)[:, None], phi[:, None] * grad, 0.0)
    return Mesh(pts, mesh.cells, mesh.element)


def approximate_quad_mesh_for_sdf_2d(sdf, max_cell_size: float) -> Mesh:
    """Voxelize, then snap the outside vertices onto the zero level set (procedural.rs:156)."""
    return _project_outside_vertices(voxelize_sdf_2d(sdf, max_cell_size), sdf)


def approximate_triangle_mesh_for_sdf_2d(sdf, max_cell_size: float) -> Mesh:
    """The triangle variant of :func:`approximate_quad_mesh_for_sdf_2d` (procedural.rs:178)."""
    mesh = voxelize_sdf_2d(sdf, max_cell_size).split_into_triangles()
    return _project_outside_vertices(mesh.keep_cells(_inside_cells(mesh, sdf)), sdf)


def create_simple_stupid_sphere(center, radius: float, num_sweeps: int):
    """A sphere-approximating :class:`~..geometry.PolyMesh`: a cube of side ``2 radius`` clipped by
    ``num_sweeps`` x ``num_sweeps`` latitudinal and longitudinal tangent half-spaces (procedural.rs:405)."""
    from ..geometry import HalfSpace, PolyMesh

    if num_sweeps <= 0:
        raise ValueError("num_sweeps must be positive")
    mesh = create_rectangular_uniform_hex_mesh(2.0 * radius, 1, 1, 1, 1)
    pm = PolyMesh.from_hex_mesh(mesh).translate([-radius, -radius, -radius])
    for i in range(num_sweeps):
        for j in range(num_sweeps):
            theta = np.pi * i / num_sweeps
            phi = 2.0 * np.pi * j / num_sweeps
            x = radius * np.array([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)])
            # the tangent plane at x with outward normal x: keep the inside
            pm = pm.intersect_half_space(HalfSpace.from_point_and_normal(x, x))
    return pm.translate(np.asarray(center, dtype=np.float64))
