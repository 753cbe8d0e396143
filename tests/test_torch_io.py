"""Port parity: Gmsh import, VTU export, checkpoints, ``NestedArray`` and the examples' VTU files.

Every fixture of ``tests/assets/meshes`` loads to the JAX package's
points and cells (bitwise) from its ASCII file and from binary MSH 4.1
rewrites of it in both byte orders; ``write_vtu`` writes JAX's bytes;
checkpoints written by either package load in the other; a solve
resumed from a checkpoint converges at iteration 0; both examples write
their VTU files, byte-identical to JAX's writer on the same data.
"""

import sys
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np
import pytest
import torch

import fenris_tpu.containers as JC
import fenris_tpu.io.checkpoint as jax_ckpt
import fenris_tpu.io.vtk as jax_vtk
from fenris_tpu.io.msh import load_msh_from_bytes as jax_load_msh_from_bytes
from fenris_tpu.mesh import Mesh as JaxMesh
from fenris_tpu.reference_elements import ELEMENTS as JAX_ELEMENTS
import fenris_tpu_torch.containers as TC
from fenris_tpu_torch.io import (FiniteElementMeshDataSetBuilder, load_checkpoint, load_msh, load_msh_from_bytes,
                                 save_checkpoint, write_vtu, write_vtu_polygons)
from fenris_tpu_torch.mesh import Mesh
from fenris_tpu_torch.mesh import procedural as TP
from fenris_tpu_torch.mesh.convert import convert_mesh
from fenris_tpu_torch.optimize import NEWTON_CONVERGED
from fenris_tpu_torch.reference_elements import ELEMENTS
from msh_fixtures import FIXTURES, MESH_DIR, msh_to_binary

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("encoding", ["ascii", "binary_le", "binary_be"])
@pytest.mark.parametrize("fname,eltype,ncells", FIXTURES)
def test_load_msh_equals_jax(fname, eltype, ncells, encoding):
    data = (MESH_DIR / fname).read_bytes()
    if encoding != "ascii":
        data = msh_to_binary(data.decode(), "<" if encoding == "binary_le" else ">")
    ref = jax_load_msh_from_bytes(data)
    got = load_msh_from_bytes(data) if encoding != "ascii" else load_msh(MESH_DIR / fname)
    assert got.element.name == eltype == ref.element.name and got.num_cells == ncells
    for key in ("points", "cells"):
        a, b = getattr(got, key), getattr(ref, key)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), key


def _jax_mesh(mesh: Mesh) -> JaxMesh:
    return JaxMesh(mesh.points, mesh.cells, JAX_ELEMENTS[mesh.element.name])


@pytest.mark.parametrize("name", ["tri3", "tri6", "quad4", "quad8", "quad9", "tet4", "tet10", "tet20", "hex8",
                                  "hex20", "hex27"])
def test_write_vtu_bytes_equal_jax(name, tmp_path, rng):
    """Every element with a VTK mapping (the higher orders reordered or downgraded), with point and cell data
    (given as tensors to the port and as numpy to JAX)."""
    base = {"tri": TP.create_unit_square_uniform_tri_mesh_2d(2), "qua": TP.create_unit_square_uniform_quad_mesh_2d(2),
            "tet": TP.create_unit_box_uniform_tet_mesh_3d(1), "hex": TP.create_unit_box_uniform_hex_mesh_3d(1)}[name[:3]]
    mesh = base if base.element.name == name else convert_mesh(base, name)
    u = rng.standard_normal((mesh.num_vertices, mesh.dim))
    c = rng.standard_normal(mesh.num_cells)
    write_vtu(tmp_path / "port.vtu", mesh, point_data={"u": torch.as_tensor(u)}, cell_data={"c": torch.as_tensor(c)})
    jax_vtk.write_vtu(tmp_path / "jax.vtu", _jax_mesh(mesh), point_data={"u": u}, cell_data={"c": c})
    assert (tmp_path / "port.vtu").read_bytes() == (tmp_path / "jax.vtu").read_bytes()


def test_vtu_builder_and_polygons_bytes_equal_jax(tmp_path, rng):
    mesh = TP.create_unit_square_uniform_quad_mesh_2d(3)
    u = rng.standard_normal(mesh.num_vertices)
    (FiniteElementMeshDataSetBuilder.from_mesh(mesh).with_title("t").with_point_scalar_attributes("u_h", torch.as_tensor(u))
     .with_cell_scalar_attributes("id", np.arange(mesh.num_cells)).try_export(tmp_path / "a.vtu"))
    (jax_vtk.FiniteElementMeshDataSetBuilder.from_mesh(_jax_mesh(mesh)).with_title("t").with_point_scalar_attributes("u_h", u)
     .with_cell_scalar_attributes("id", np.arange(mesh.num_cells)).try_export(tmp_path / "b.vtu"))
    assert (tmp_path / "a.vtu").read_bytes() == (tmp_path / "b.vtu").read_bytes()
    verts = rng.standard_normal((7, 3))
    faces = [[0, 1, 2], [2, 3, 4, 5], [5, 6, 0]]
    write_vtu_polygons(tmp_path / "p.vtu", torch.as_tensor(verts), faces, cell_data={"f": np.arange(3.0)})
    jax_vtk.write_vtu_polygons(tmp_path / "q.vtu", verts, faces, cell_data={"f": np.arange(3.0)})
    assert (tmp_path / "p.vtu").read_bytes() == (tmp_path / "q.vtu").read_bytes()
    assert write_vtu.__module__ != jax_vtk.write_vtu.__module__


def test_checkpoints_cross_between_packages(tmp_path, rng):
    """A checkpoint written by the port (tensor state) loads in JAX, and one written by JAX loads in the port,
    every array equal."""
    mesh = convert_mesh(TP.create_unit_box_uniform_tet_mesh_3d(2), "tet10")
    u = rng.standard_normal(mesh.num_vertices * 3)
    save_checkpoint(tmp_path / "port.npz", mesh=mesh, u=torch.as_tensor(u), newton_iter=np.asarray(7))
    jmesh, jstate = jax_ckpt.load_checkpoint(tmp_path / "port.npz")
    assert jmesh.element.name == "tet10" and np.array_equal(jmesh.cells, mesh.cells)
    assert np.array_equal(jmesh.points, mesh.points) and np.array_equal(jstate["u"], u) and int(jstate["newton_iter"]) == 7
    jax_ckpt.save_checkpoint(tmp_path / "jax.npz", mesh=_jax_mesh(mesh), u=u)
    pmesh, pstate = load_checkpoint(tmp_path / "jax.npz")
    assert isinstance(pmesh, Mesh) and pmesh.element is ELEMENTS["tet10"]
    assert np.array_equal(pmesh.points, mesh.points) and np.array_equal(pmesh.cells, mesh.cells)
    assert np.array_equal(pstate["u"], u)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(set(b.files) | {"state/newton_iter"})


def test_resume_solve_from_checkpoint(tmp_path):
    """tests/test_checkpoint.py:22 on the port: a solve warm-started from a checkpointed solution converges at
    iteration 0."""
    from fenris_tpu_torch.elasticity import HyperelasticModel
    from fenris_tpu_torch.solid import LameParameters, NeoHookeanMaterial

    mesh = TP.create_unit_box_uniform_hex_mesh_3d(2)
    model = HyperelasticModel(
        mesh=mesh, material=NeoHookeanMaterial(), params=LameParameters(mu=100.0, lam=200.0),
        dirichlet_nodes=np.flatnonzero(np.abs(mesh.points[:, 2]) < 1e-12),
        body_force=lambda x, p: torch.tensor([0.0, 0.0, -5.0], dtype=x.dtype), dtype=torch.float64, device="cpu",
    )
    res = model.solve(tolerance=1e-9)
    save_checkpoint(tmp_path / "solve.npz", mesh=mesh, u=res.x)
    _, state = load_checkpoint(tmp_path / "solve.npz")
    assert np.array_equal(state["u"], res.x.numpy())
    res2 = model.solve(u0=torch.as_tensor(state["u"]), tolerance=1e-9)
    assert int(res2.status) == NEWTON_CONVERGED and int(res2.iterations) == 0


def test_nested_array_matches_jax():
    lists = [[1, 2, 3], [], [4], [5, 6]]
    got, ref = TC.NestedArray.from_lists(lists), JC.NestedArray.from_lists(lists)
    for a, b in ((got.data, ref.data), (got.offsets, ref.offsets), (got.lengths(), ref.lengths()),
                 (got.to_padded(), ref.to_padded()), (got.to_padded(fill=0), ref.to_padded(fill=0))):
        np.testing.assert_array_equal(a, b)
    assert len(got) == 4 and [list(r) for r in got] == lists and list(got[3]) == [5, 6]
    more = got.append([7, 8, 9])
    np.testing.assert_array_equal(more.to_padded(), ref.append([7, 8, 9]).to_padded())
    empty = TC.NestedArray.empty()
    assert len(empty) == 0 and empty.to_padded().shape == (0, 0) and len(empty.append([1])) == 1
    assert TC.NestedArray.from_lists([], dtype=np.int32).data.dtype == np.int32


def _example(name):
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(ROOT / "examples"))


def test_examples_write_vtu(tmp_path):
    """Both examples at a tiny size write their VTU like the JAX examples: the deformed beam with its
    displacement, the Poisson mesh with ``u_h`` and ``u_exact``; the bytes are JAX's writer's on the same
    mesh and data."""
    cant = _example("hyperelastic_cantilever_torch")
    res, u, tip = cant.main(1, device="cpu", dtype=torch.float64, out_dir=tmp_path)
    beam = TP.create_rectangular_uniform_hex_mesh(1.0, 2, 1, 1, 1)
    deformed = beam.transform_points(lambda p: p + u)
    jax_vtk.FiniteElementMeshDataSetBuilder.from_mesh(_jax_mesh(deformed)).with_title("Neo-Hookean cantilever") \
        .with_point_vector_attributes("displacement", u).try_export(tmp_path / "jax_cantilever.vtu")
    assert (tmp_path / "cantilever.vtu").read_bytes() == (tmp_path / "jax_cantilever.vtu").read_bytes()
    piece = ET.parse(tmp_path / "cantilever.vtu").getroot().find(".//Piece")
    assert int(piece.get("NumberOfCells")) == beam.num_cells
    disp = piece.find(".//PointData/DataArray[@Name='displacement']").text.split()
    np.testing.assert_array_equal(np.array(disp, dtype=np.float64).reshape(-1, 3), u)

    poisson = _example("poisson2d_torch")
    result = poisson.main(4, device="cpu", dtype=torch.float64, out_dir=tmp_path)
    mesh = TP.create_unit_square_uniform_quad_mesh_2d(4)
    exact = np.sin(np.pi * mesh.points[:, 0]) * np.sin(np.pi * mesh.points[:, 1])
    jax_vtk.FiniteElementMeshDataSetBuilder.from_mesh(_jax_mesh(mesh)).with_title("Poisson 2D FEM") \
        .with_point_scalar_attributes("u_h", result.u.numpy()).with_point_scalar_attributes("u_exact", exact) \
        .try_export(tmp_path / "jax_poisson2d.vtu")
    assert (tmp_path / "poisson2d.vtu").read_bytes() == (tmp_path / "jax_poisson2d.vtu").read_bytes()
