"""Mesh and solution I/O: Gmsh ``.msh`` import, VTU export and checkpoints (numpy and the standard library)."""

from .checkpoint import load_checkpoint, load_mesh, save_checkpoint, save_mesh
from .msh import load_msh, load_msh_from_bytes
from .vtk import FiniteElementMeshDataSetBuilder, write_vtu, write_vtu_polygons

__all__ = [
    "load_msh",
    "load_msh_from_bytes",
    "write_vtu",
    "write_vtu_polygons",
    "FiniteElementMeshDataSetBuilder",
    "save_checkpoint",
    "load_checkpoint",
    "save_mesh",
    "load_mesh",
]
