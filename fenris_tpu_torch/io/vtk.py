"""VTK XML (``.vtu``) export of finite element meshes and attributes.

Counterpart of ``fenris_tpu/io/vtk.py``: the same text, byte for byte,
for the same mesh and data (``.17g`` floats).  Attribute values may be
numpy arrays or tensors (taken through ``.detach().cpu().numpy()``).
Parity: src/io/vtk.rs — ``VtkCellConnectivity`` cell-type mapping with
quadratic node reordering (:26-162; like the reference, Tet20 is exported
as linear tetrahedra and Hex27 as 20-node quadratic hexahedra, vtk.rs:117,
:155-162) and ``FiniteElementMeshDataSetBuilder`` (:311) with point/cell
scalar and vector attributes (:365-442) and ``try_export`` (:529).

Hand-rolled ASCII XML writer — no external VTK dependency.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..mesh import Mesh

__all__ = ["write_vtu", "write_vtu_polygons", "FiniteElementMeshDataSetBuilder", "vtk_cell_type_and_permutation"]

# ours -> VTK node permutation (list gives, for each VTK slot, our node idx)
_HEX20_PERM = list(range(8)) + [8, 11, 13, 9, 16, 18, 19, 17, 10, 12, 14, 15]

_VTK_MAP: Dict[str, Tuple[int, Optional[List[int]]]] = {
    "seg2": (3, None),
    "seg3": (21, [0, 1, 2]),
    "tri3": (5, None),
    "tri6": (22, None),  # corners + edges 01,12,20 — identical ordering
    "quad4": (9, None),
    "quad8": (23, None),
    "quad9": (28, None),
    "tet4": (10, None),
    "tet10": (24, [0, 1, 2, 3, 4, 5, 6, 7, 9, 8]),  # vtk edges 01,12,20,03,13,23
    "tet20": (10, [0, 1, 2, 3]),  # downgraded to linear (vtk.rs:117)
    "hex8": (12, None),
    "hex20": (25, _HEX20_PERM),
    "hex27": (25, _HEX20_PERM),  # downgraded to quadratic hex (vtk.rs:155)
}


def vtk_cell_type_and_permutation(element_name: str) -> Tuple[int, Optional[List[int]]]:
    try:
        return _VTK_MAP[element_name]
    except KeyError:
        raise ValueError(f"no VTK export mapping for element {element_name!r}")


def to_numpy(a) -> np.ndarray:
    """A tensor through ``.detach().cpu().numpy()``, anything else through ``np.asarray``."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _fmt_array(a: np.ndarray) -> str:
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return "\n".join(" ".join(f"{v:.17g}" for v in row) for row in np.atleast_2d(a))
    return "\n".join(" ".join(str(int(v)) for v in row) for row in np.atleast_2d(a))


def _data_arrays(data: Optional[Dict[str, np.ndarray]], n_expected: int) -> str:
    """The ``<DataArray>`` elements of point or cell attributes, one row an entity."""
    out = []
    for name, arr in (data or {}).items():
        arr = to_numpy(arr)
        if arr.ndim == 1:
            arr = arr[:, None]
        if arr.shape[0] != n_expected:
            raise ValueError(f"attribute {name!r} has {arr.shape[0]} rows, expected {n_expected}")
        out.append(
            f'<DataArray type="Float64" Name="{name}" '
            f'NumberOfComponents="{arr.shape[1]}" format="ascii">\n'
            f"{_fmt_array(arr)}\n</DataArray>"
        )
    return "\n".join(out)


def _write(path, xml: str) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(xml)


def write_vtu(
    path,
    mesh: Mesh,
    point_data: Optional[Dict[str, np.ndarray]] = None,
    cell_data: Optional[Dict[str, np.ndarray]] = None,
    title: Optional[str] = None,
) -> None:
    """Write a mesh (+ attributes) as an XML VTK UnstructuredGrid file.

    VTK XML has no title: ``title`` is accepted and not written, as in the
    JAX package.
    """
    vtk_type, perm = vtk_cell_type_and_permutation(mesh.element.name)
    cells = mesh.cells[:, perm] if perm is not None else mesh.cells
    n_per = cells.shape[1]
    pts3 = np.zeros((mesh.num_vertices, 3))
    pts3[:, : mesh.dim] = mesh.points

    offsets = np.arange(1, mesh.num_cells + 1) * n_per
    types = np.full(mesh.num_cells, vtk_type)

    xml = f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">
<UnstructuredGrid>
<Piece NumberOfPoints="{mesh.num_vertices}" NumberOfCells="{mesh.num_cells}">
<Points>
<DataArray type="Float64" NumberOfComponents="3" format="ascii">
{_fmt_array(pts3)}
</DataArray>
</Points>
<Cells>
<DataArray type="Int64" Name="connectivity" format="ascii">
{_fmt_array(cells.astype(np.int64))}
</DataArray>
<DataArray type="Int64" Name="offsets" format="ascii">
{_fmt_array(offsets[:, None])}
</DataArray>
<DataArray type="UInt8" Name="types" format="ascii">
{_fmt_array(types[:, None])}
</DataArray>
</Cells>
<PointData>
{_data_arrays(point_data, mesh.num_vertices)}
</PointData>
<CellData>
{_data_arrays(cell_data, mesh.num_cells)}
</CellData>
</Piece>
</UnstructuredGrid>
</VTKFile>
"""
    _write(path, xml)


def write_vtu_polygons(
    path,
    vertices: np.ndarray,
    faces,
    cell_data: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """Write variable-arity polygonal faces as true VTK_POLYGON cells.

    Parity: the reference's PolyMesh -> VTK export keeps faces as
    polygons rather than triangulating (fenris-geometry/src/vtkio.rs:
    139-158, the ``N, i_1..i_N`` polygon topology).  XML VTU expresses
    the same via per-cell offsets with cell type 7 (VTK_POLYGON).
    """
    vertices = to_numpy(vertices).astype(np.float64)
    pts3 = np.zeros((len(vertices), 3))
    pts3[:, : vertices.shape[1]] = vertices
    conn = np.concatenate([np.asarray(f, dtype=np.int64) for f in faces]) if faces else np.zeros(0, np.int64)
    offsets = np.cumsum([len(f) for f in faces]).astype(np.int64)
    types = np.full(len(faces), 7, dtype=np.uint8)

    xml = f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">
<UnstructuredGrid>
<Piece NumberOfPoints="{len(vertices)}" NumberOfCells="{len(faces)}">
<Points>
<DataArray type="Float64" NumberOfComponents="3" format="ascii">
{_fmt_array(pts3)}
</DataArray>
</Points>
<Cells>
<DataArray type="Int64" Name="connectivity" format="ascii">
{_fmt_array(conn[:, None]) if conn.size else ""}
</DataArray>
<DataArray type="Int64" Name="offsets" format="ascii">
{_fmt_array(offsets[:, None]) if offsets.size else ""}
</DataArray>
<DataArray type="UInt8" Name="types" format="ascii">
{_fmt_array(types[:, None]) if types.size else ""}
</DataArray>
</Cells>
<PointData>
</PointData>
<CellData>
{_data_arrays(cell_data, len(faces))}
</CellData>
</Piece>
</UnstructuredGrid>
</VTKFile>
"""
    _write(path, xml)


@dataclass
class FiniteElementMeshDataSetBuilder:
    """Builder-style VTU exporter (vtk.rs:311).

    Example::

        (FiniteElementMeshDataSetBuilder.from_mesh(mesh)
            .with_title("Poisson")
            .with_point_scalar_attributes("u_h", u)
            .try_export("out.vtu"))
    """

    mesh: Mesh
    title: Optional[str] = None
    point_data: Dict[str, np.ndarray] = field(default_factory=dict)
    cell_data: Dict[str, np.ndarray] = field(default_factory=dict)

    @staticmethod
    def from_mesh(mesh: Mesh) -> "FiniteElementMeshDataSetBuilder":
        return FiniteElementMeshDataSetBuilder(mesh=mesh)

    def with_title(self, title: str) -> "FiniteElementMeshDataSetBuilder":
        return replace(self, title=title)

    def with_point_scalar_attributes(self, name, values):
        new = dict(self.point_data)
        new[name] = to_numpy(values).reshape(self.mesh.num_vertices, -1)
        return replace(self, point_data=new)

    def with_point_vector_attributes(self, name, values):
        return self.with_point_scalar_attributes(name, values)

    def with_cell_scalar_attributes(self, name, values):
        new = dict(self.cell_data)
        new[name] = to_numpy(values).reshape(self.mesh.num_cells, -1)
        return replace(self, cell_data=new)

    def with_cell_vector_attributes(self, name, values):
        return self.with_cell_scalar_attributes(name, values)

    def try_export(self, path) -> None:
        write_vtu(
            path,
            self.mesh,
            point_data=self.point_data,
            cell_data=self.cell_data,
            title=self.title,
        )
