"""General polytopal meshes with topological half-space clipping.

Counterpart of ``fenris_tpu/geometry/polymesh.py``: a host-numpy copy that gives
the same results.

Parity: fenris-geometry/src/polymesh.rs — ``PolyMesh3d`` (:66),
``intersect_half_space`` (:576, the topological clip), ``intersect_convex_
polyhedron`` (:564), ``compute_volume`` (:555), ``triangulate`` (:337),
boundary-face extraction.

The clip follows the reference's *edge-representation* construction: every
vertex of the clipped mesh is labeled by an undirected vertex pair
``(a, b)`` of the input mesh — ``(a, a)`` for an original kept vertex,
``(a, b), a != b`` for the intersection of edge a–b with the clip plane.
Faces are clipped by walking their vertex loops; cut cells are closed by
chaining their faces' intersection edges into new polygonal faces.  Because
labels are global, faces shared between cells are clipped exactly once and
cell/face adjacency is preserved — unlike vertex-soup clipping, this works
for arbitrary convex cells in any orientation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["PolyMesh"]


@dataclass
class PolyMesh:
    """Vertices + polygonal faces + polyhedral cells (polymesh.rs:66).

    ``faces``: vertex-index loops; ``cells``: face-index lists.  Cells are
    assumed convex (clipping and volume rely on it, as in the reference's
    usage).
    """

    vertices: np.ndarray  # [N, 3]
    faces: List[List[int]]
    cells: List[List[int]]

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_hex_mesh(mesh) -> "PolyMesh":
        """Convert a hex8 Mesh into a PolyMesh (one cell per hex)."""
        return PolyMesh.from_cell_mesh(mesh)

    @staticmethod
    def from_cell_mesh(mesh) -> "PolyMesh":
        """Convert a linear-cell Mesh (tet4/hex8) using its face topology
        (polymesh.rs From<&Mesh> impls)."""
        faces: List[List[int]] = []
        cells: List[List[int]] = []
        face_map: Dict[Tuple[int, ...], int] = {}
        local_faces = mesh.element.faces
        for cell in mesh.cells:
            cfaces = []
            for local in local_faces:
                fv = tuple(int(cell[i]) for i in local)
                key = tuple(sorted(fv))
                if key not in face_map:
                    face_map[key] = len(faces)
                    faces.append(list(fv))
                cfaces.append(face_map[key])
            cells.append(cfaces)
        return PolyMesh(np.asarray(mesh.points, dtype=np.float64), faces, cells)

    # -- basic ops ----------------------------------------------------------

    def translate(self, offset) -> "PolyMesh":
        return PolyMesh(self.vertices + np.asarray(offset), self.faces, self.cells)

    @property
    def num_faces(self) -> int:
        return len(self.faces)

    @property
    def num_cells(self) -> int:
        return len(self.cells)

    def cell_vertex_sets(self) -> List[np.ndarray]:
        out = []
        for cfaces in self.cells:
            idx = sorted({v for f in cfaces for v in self.faces[f]})
            out.append(np.asarray(idx))
        return out

    def find_boundary_faces(self) -> np.ndarray:
        """Faces referenced by exactly one cell (polymesh.rs boundary)."""
        counts = np.zeros(len(self.faces), dtype=np.int64)
        for cfaces in self.cells:
            for f in cfaces:
                counts[f] += 1
        return np.flatnonzero(counts == 1)

    def volume(self) -> float:
        """Total volume: per-(convex)-cell centroid tet fans
        (polymesh.rs:555 computes the same measure from boundary faces)."""
        total = 0.0
        for cfaces in self.cells:
            vs = sorted({v for f in cfaces for v in self.faces[f]})
            if not vs:
                continue
            c = self.vertices[vs].mean(axis=0)
            for f in cfaces:
                poly = self.vertices[self.faces[f]]
                for k in range(1, len(poly) - 1):
                    d = np.stack([poly[k] - poly[0], poly[k + 1] - poly[0], c - poly[0]])
                    total += abs(np.linalg.det(d)) / 6.0
        return total

    def surface_area(self) -> float:
        """Area of the boundary faces."""
        area = 0.0
        for f in self.find_boundary_faces():
            poly = self.vertices[self.faces[f]]
            for k in range(1, len(poly) - 1):
                area += 0.5 * np.linalg.norm(
                    np.cross(poly[k] - poly[0], poly[k + 1] - poly[0])
                )
        return float(area)

    def triangulate(self):
        """Tetrahedralize each (convex) cell by fanning from its centroid
        (polymesh.rs:337).  Returns a tet4 :class:`~fenris_tpu_torch.mesh.Mesh`."""
        from ..mesh import Mesh
        from ..reference_elements import TET4

        verts: List[np.ndarray] = [v for v in self.vertices]
        tets: List[List[int]] = []
        for cfaces in self.cells:
            vs = sorted({v for f in cfaces for v in self.faces[f]})
            centroid = self.vertices[vs].mean(axis=0)
            ci = len(verts)
            verts.append(centroid)
            for f in cfaces:
                face = self.faces[f]
                fc = self.vertices[face].mean(axis=0)
                fi = len(verts)
                verts.append(fc)
                n = len(face)
                for k in range(n):
                    a, b = face[k], face[(k + 1) % n]
                    tet = [a, b, fi, ci]
                    v0, v1, v2, v3 = (np.asarray(verts[i]) for i in tet)
                    if np.linalg.det(np.stack([v1 - v0, v2 - v0, v3 - v0])) < 0:
                        tet = [b, a, fi, ci]
                    tets.append(tet)
        return Mesh(np.asarray(verts), np.asarray(tets, dtype=np.int32), TET4)

    def export_vtu(self, path, *, polygonal: bool = True) -> None:
        """Export the mesh's faces as true VTK_POLYGON cells
        (fenris-geometry/src/vtkio.rs:139-158 polygon topology);
        ``polygonal=False`` writes the tetrahedralized volume instead."""
        if polygonal:
            from ..io.vtk import write_vtu_polygons

            write_vtu_polygons(path, self.vertices, self.faces)
        else:
            from ..io.vtk import write_vtu

            write_vtu(path, self.triangulate())

    # -- clipping -----------------------------------------------------------

    def intersect_half_space(self, half) -> "PolyMesh":
        """Topological clip against {x : n·(x-p) <= 0} (polymesh.rs:576).

        Preserves face/cell structure: each face is clipped once (shared
        faces stay shared), each cut cell gains a closing face built by
        chaining the intersection edges of its cut faces.
        """
        sd = half.signed_distance(self.vertices)
        inside = sd <= 0.0

        # Phase 1: clip faces in edge representation.
        INSIDE, CUT, OUTSIDE = 0, 1, 2
        face_reps: List[List[Tuple[int, int]]] = []
        face_class: List[int] = []
        for face in self.faces:
            rep: List[Tuple[int, int]] = []
            cls = INSIDE
            n = len(face)
            for k in range(n):
                a, b = face[k], face[(k + 1) % n]
                if inside[a]:
                    rep.append((a, a))
                if inside[a] != inside[b]:
                    rep.append((a, b) if a <= b else (b, a))
                    cls = CUT
            if not rep:
                cls = OUTSIDE
            face_reps.append(rep)
            face_class.append(cls)

        # Phase 2: rebuild cells; close cut cells by chaining intersection
        # edges (pairs of consecutive intersection vertices on cut faces).
        new_face_reps = list(face_reps)
        new_cells: List[List[int]] = []
        for cfaces in self.cells:
            cell_faces: List[int] = []
            inter_edges: List[Tuple[Tuple[int, int], Tuple[int, int]]] = []
            for f in cfaces:
                cls = face_class[f]
                if cls == OUTSIDE:
                    continue
                cell_faces.append(f)
                if cls == CUT:
                    rep = face_reps[f]
                    nn = len(rep)
                    for k in range(nn):
                        a, b = rep[k], rep[(k + 1) % nn]
                        if a[0] != a[1] and b[0] != b[1]:
                            inter_edges.append((a, b))
            # string the intersection edges into loops; in non-degenerate
            # cases one closing face per cell results (polymesh.rs:666-694)
            while inter_edges:
                start_a, start_b = inter_edges.pop()
                loop = [start_a]
                nxt = start_b
                while True:
                    pos = next(
                        (
                            i
                            for i, e in enumerate(inter_edges)
                            if e[0] == nxt or e[1] == nxt
                        ),
                        None,
                    )
                    if pos is None:
                        break
                    ea, eb = inter_edges.pop(pos)
                    if ea == nxt:
                        loop.append(ea)
                        nxt = eb
                    else:
                        loop.append(eb)
                        nxt = ea
                new_face_reps.append(loop)
                cell_faces.append(len(new_face_reps) - 1)
            if cell_faces:
                new_cells.append(cell_faces)

        # Phase 3: label edge-representation vertices (first-seen order),
        # compute coordinates, drop empty faces, remap cells.
        label_map: Dict[Tuple[int, int], int] = {}
        for rep in new_face_reps:
            for key in rep:
                if key not in label_map:
                    label_map[key] = len(label_map)
        final_vertices = np.zeros((len(label_map), self.vertices.shape[1]))
        for (a, b), idx in label_map.items():
            if a == b:
                final_vertices[idx] = self.vertices[a]
            else:
                t = sd[a] / (sd[a] - sd[b])
                final_vertices[idx] = self.vertices[a] + t * (
                    self.vertices[b] - self.vertices[a]
                )
        final_faces: List[List[int]] = []
        face_label_map: Dict[int, int] = {}
        for i, rep in enumerate(new_face_reps):
            if rep:
                face_label_map[i] = len(final_faces)
                final_faces.append([label_map[key] for key in rep])
        final_cells = [
            [face_label_map[f] for f in cfaces] for cfaces in new_cells
        ]
        return PolyMesh(final_vertices, final_faces, final_cells)

    def intersect_convex_polyhedron(self, polyhedron) -> "PolyMesh":
        """Clip against a convex region (polymesh.rs:564: iterated
        half-space clips).  Accepts a
        :class:`~fenris_tpu_torch.geometry.polyhedron.ConvexPolyhedron` (e.g. a
        ``Hexahedron``) or a raw iterable of outward half-spaces."""
        half_spaces = getattr(polyhedron, "half_spaces", None)
        if callable(half_spaces):
            half_spaces = half_spaces()
        else:
            half_spaces = polyhedron
        mesh = self
        for hs in half_spaces:
            mesh = mesh.intersect_half_space(hs)
        return mesh
