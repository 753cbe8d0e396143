"""The Gmsh fixtures of ``tests/assets/meshes`` and a binary MSH 4.1 writer for them (not collected by pytest).

JAX-free (numpy only): ``tests/test_torch_io.py`` and ``chip_smoke.py``
load every fixture from its ASCII file and from binary rewrites in both
byte orders.
"""

from pathlib import Path

import numpy as np

MESH_DIR = Path(__file__).parent / "assets" / "meshes"
FIXTURES = [  # tests/test_io.py:17-29
    ("square_tri3_4.msh", "tri3", 4),
    ("square_tri6_4.msh", "tri6", 4),
    ("square_quad4_4.msh", "quad4", 4),
    ("square_quad4_79.msh", "quad4", 79),
    ("square_quad9_4.msh", "quad9", 4),
    ("rectangle_tri3_110.msh", "tri3", 110),
    ("cube_tet4_24.msh", "tet4", 24),
    ("cube_tet10_24.msh", "tet10", 24),
    ("cube_hex8_8.msh", "hex8", 8),
    ("cube_hex27_8.msh", "hex27", 8),
    ("sphere_tet4_593.msh", "tet4", 593),
]


def msh_to_binary(text: str, byte_order: str = "<") -> bytes:
    """An ASCII MSH 4.1 file's Nodes and Elements as a binary MSH 4.1 payload (8-byte size_t) in ``byte_order``
    (Gmsh reference manual §9.1): the format line, the int 1 that fixes the byte order, then the sections'
    raw blocks."""
    lines = text.splitlines()
    sec = {}
    i = 0
    while i < len(lines):
        if lines[i].startswith("$") and not lines[i].startswith("$End"):
            name, j = lines[i][1:].strip(), i + 1
            while lines[j].strip() != f"$End{name}":
                j += 1
            sec[name] = lines[i + 1 : j]
            i = j
        i += 1
    i4, szt, f8 = np.dtype(byte_order + "i4"), np.dtype(byte_order + "u8"), np.dtype(byte_order + "f8")
    nodes, body = sec["Nodes"], [np.array([int(v) for v in sec["Nodes"][0].split()], szt).tobytes()]
    k = 1
    while k < len(nodes):
        dim, tag, param, n = (int(v) for v in nodes[k].split())
        body += [np.array([dim, tag, param], i4).tobytes(), np.array([n], szt).tobytes(),
                 np.array([int(nodes[k + 1 + a]) for a in range(n)], szt).tobytes(),
                 np.array([[float(v) for v in nodes[k + 1 + n + a].split()[:3]] for a in range(n)], f8).tobytes()]
        k += 1 + 2 * n
    out = [b"$MeshFormat\n4.1 1 8\n", np.array([1], i4).tobytes(), b"\n$EndMeshFormat\n$Nodes\n", *body,
           b"\n$EndNodes\n$Elements\n"]
    els = sec["Elements"]
    out.append(np.array([int(v) for v in els[0].split()], szt).tobytes())
    k = 1
    while k < len(els):
        dim, tag, etype, n = (int(v) for v in els[k].split())
        rows = np.array([[int(v) for v in els[k + 1 + a].split()] for a in range(n)], szt).reshape(n, -1)
        out += [np.array([dim, tag, etype], i4).tobytes(), np.array([n], szt).tobytes(), rows.tobytes()]
        k += 1 + n
    out.append(b"\n$EndElements\n")
    return b"".join(out)
