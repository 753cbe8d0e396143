"""Gmsh ``.msh`` (MSH 4.1, ASCII and binary) import.

Counterpart of ``fenris_tpu/io/msh.py``: the same parser, producing the
port's :class:`~..mesh.Mesh` with the JAX package's points and cells.
Parity: src/io/msh.rs, ``load_msh_from_file``/``from_bytes`` (:32, :44)
with the ``MshConnectivity`` element-type mapping (:235-285).  ASCII and
binary payloads (little- and big-endian) are accepted, as the
reference's ``mshio`` backend accepts them.  Node orders are taken
verbatim from the file: the reference node orders coincide with Gmsh's
for every supported cell type.

The loader extracts all elements of the mesh's highest topological
dimension (or a requested element type) as one homogeneous block.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..mesh import Mesh
from ..reference_elements import ELEMENTS

__all__ = ["load_msh", "load_msh_from_bytes", "MSH_ELEMENT_TYPES"]

# Gmsh element type id -> (element name, reference dim)
MSH_ELEMENT_TYPES = {
    1: ("seg2", 1),
    2: ("tri3", 2),
    3: ("quad4", 2),
    4: ("tet4", 3),
    5: ("hex8", 3),
    8: ("seg3", 1),
    9: ("tri6", 2),
    10: ("quad9", 2),
    11: ("tet10", 3),
    12: ("hex27", 3),
    15: ("point", 0),
    16: ("quad8", 2),
    17: ("hex20", 3),
}


# nodes per Gmsh element type (for skipping unkept blocks in binary files)
_MSH_NODE_COUNTS = {
    1: 2, 2: 3, 3: 4, 4: 4, 5: 8, 6: 6, 7: 5, 8: 3, 9: 6, 10: 9,
    11: 10, 12: 27, 13: 18, 14: 14, 15: 1, 16: 8, 17: 20, 18: 15, 19: 13,
}


def load_msh(path, element_type: Optional[str] = None, dim: Optional[int] = None) -> Mesh:
    """Load a Gmsh MSH 4.1 file (ASCII or binary) as a homogeneous mesh."""
    with open(path, "rb") as f:
        return load_msh_from_bytes(f.read(), element_type=element_type, dim=dim)


def load_msh_from_bytes(
    data: bytes, element_type: Optional[str] = None, dim: Optional[int] = None
) -> Mesh:
    if b"$MeshFormat" not in data[:256]:
        raise ValueError("not a Gmsh msh file (missing $MeshFormat)")
    header = data.split(b"\n", 2)[1].split()
    version = header[0].decode()
    if not version.startswith("4"):
        raise ValueError(f"unsupported MSH version {version} (MSH 4.x required)")
    if header[1] != b"0":
        node_tags, node_coords, blocks = _parse_binary(data, int(header[2]))
    else:
        sections = _split_sections(data.decode("utf-8", errors="replace"))
        node_tags, node_coords = _parse_nodes(sections["Nodes"])
        blocks = _parse_elements(sections["Elements"])

    # Choose the element block(s) to extract
    if element_type is not None:
        wanted = {k for k, (name, _) in MSH_ELEMENT_TYPES.items() if name == element_type}
        chosen = [b for b in blocks if b[0] in wanted]
        if not chosen:
            raise ValueError(f"no elements of type {element_type!r} in file")
    else:
        maxdim = max(MSH_ELEMENT_TYPES.get(b[0], ("?", -1))[1] for b in blocks)
        chosen = [
            b
            for b in blocks
            if MSH_ELEMENT_TYPES.get(b[0], ("?", -1))[1] == maxdim
        ]
        types = {b[0] for b in chosen}
        if len(types) > 1:
            raise ValueError(
                f"heterogeneous top-dimensional elements {types}; pass element_type"
            )
    etype = chosen[0][0]
    name, edim = MSH_ELEMENT_TYPES[etype]
    el = ELEMENTS[name]
    cells_raw = np.concatenate([b[1] for b in chosen], axis=0)

    # Remap (possibly sparse) node tags to dense indices
    tag_to_idx = np.full(int(node_tags.max()) + 1, -1, dtype=np.int64)
    tag_to_idx[node_tags] = np.arange(len(node_tags))
    cells = tag_to_idx[cells_raw]
    if (cells < 0).any():
        raise ValueError("element references unknown node tag")

    # Geometric dimension: drop trailing zero coordinate columns for 2D/1D
    points = node_coords
    target_dim = dim if dim is not None else edim
    if target_dim < 3:
        tail = points[:, target_dim:]
        if np.abs(tail).max(initial=0.0) > 1e-12:
            target_dim = 3  # embedded surface/curve mesh
        points = node_coords[:, :target_dim]
    return Mesh(points, cells.astype(np.int32), el)


def _split_sections(text: str) -> Dict[str, List[str]]:
    sections: Dict[str, List[str]] = {}
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("$") and not line.startswith("$End"):
            name = line[1:]
            body = []
            i += 1
            while i < len(lines) and lines[i].strip() != f"$End{name}":
                body.append(lines[i])
                i += 1
            sections[name] = body
        i += 1
    return sections


def _parse_nodes(body: List[str]) -> Tuple[np.ndarray, np.ndarray]:
    header = body[0].split()
    num_blocks, total = int(header[0]), int(header[1])
    tags = np.empty(total, dtype=np.int64)
    coords = np.empty((total, 3), dtype=np.float64)
    i, out = 1, 0
    for _ in range(num_blocks):
        _, _, _, n = (int(v) for v in body[i].split())
        i += 1
        for k in range(n):
            tags[out + k] = int(body[i + k])
        for k in range(n):
            coords[out + k] = [float(v) for v in body[i + n + k].split()[:3]]
        i += 2 * n
        out += n
    return tags[:out], coords[:out]


def _parse_binary(data: bytes, size_t: int):
    """Parse the Nodes/Elements sections of a binary MSH 4.1 payload.

    Binary layout (Gmsh reference manual §9.1): the ``$MeshFormat`` body
    carries an int ``1`` whose byte order fixes the file's endianness; the
    Nodes/Elements section bodies are raw struct blocks.
    """
    if size_t not in (4, 8):
        raise ValueError(f"unsupported MSH size_t width {size_t}")
    # endianness probe: the int 1 following the "4.1 1 <size_t>" line
    fmt_start = data.index(b"$MeshFormat")
    probe_at = data.index(b"\n", data.index(b"\n", fmt_start) + 1) + 1
    (probe,) = np.frombuffer(data[probe_at : probe_at + 4], "<i4")
    bo = "<" if probe == 1 else ">"
    i4, szt, f8 = np.dtype(bo + "i4"), np.dtype(f"{bo}u{size_t}"), np.dtype(bo + "f8")

    def section(name: str):
        start = data.index(b"$" + name.encode()) + len(name) + 2
        end = data.index(b"$End" + name.encode())
        return data[start:end], 0

    def read(buf, pos, dtype, n):
        nb = dtype.itemsize * n
        return np.frombuffer(buf[pos : pos + nb], dtype, count=n), pos + nb

    # -- Nodes
    buf, pos = section("Nodes")
    (hdr, pos) = read(buf, pos, szt, 4)
    num_blocks, total = int(hdr[0]), int(hdr[1])
    tags = np.empty(total, np.int64)
    coords = np.empty((total, 3), np.float64)
    out = 0
    for _ in range(num_blocks):
        meta_i, pos = read(buf, pos, i4, 3)  # entityDim, entityTag, parametric
        (n_arr, pos) = read(buf, pos, szt, 1)
        n = int(n_arr[0])
        if meta_i[2] != 0:
            raise ValueError("parametric node blocks are not supported")
        t, pos = read(buf, pos, szt, n)
        c, pos = read(buf, pos, f8, 3 * n)
        tags[out : out + n] = t
        coords[out : out + n] = c.reshape(n, 3)
        out += n
    node_tags, node_coords = tags[:out], coords[:out]

    # -- Elements
    buf, pos = section("Elements")
    (hdr, pos) = read(buf, pos, szt, 4)
    num_blocks = int(hdr[0])
    blocks = []
    for _ in range(num_blocks):
        meta_i, pos = read(buf, pos, i4, 3)  # entityDim, entityTag, elementType
        (n_arr, pos) = read(buf, pos, szt, 1)
        etype, n = int(meta_i[2]), int(n_arr[0])
        if etype not in _MSH_NODE_COUNTS:
            raise ValueError(f"unknown msh element type {etype} in binary block")
        width = 1 + _MSH_NODE_COUNTS[etype]
        rows, pos = read(buf, pos, szt, n * width)
        if n:
            blocks.append((etype, rows.reshape(n, width)[:, 1:].astype(np.int64)))
    return node_tags, node_coords, blocks


def _parse_elements(body: List[str]):
    header = body[0].split()
    num_blocks = int(header[0])
    blocks = []
    i = 1
    for _ in range(num_blocks):
        _, _, etype, n = (int(v) for v in body[i].split())
        i += 1
        if n == 0:
            continue
        rows = np.array(
            [[int(v) for v in body[i + k].split()] for k in range(n)], dtype=np.int64
        )
        i += n
        blocks.append((etype, rows[:, 1:]))  # drop element tag column
    return blocks
