"""Convex 3D polygons and polyhedra: Quad3d/Quad2d, Hexahedron, traits.

Counterpart of ``fenris_tpu/geometry/polyhedron.py``: a host-numpy copy that gives
the same results.

Parity: the reference's ``ConvexPolygon3d`` / ``ConvexPolyhedron`` trait
surface (fenris-geometry/src/lib.rs:393-648) and the primitives built on
it — ``Quad3d``/``Quad2d`` (primitives/quad.rs:1-123) and ``Hexahedron``
(primitives/hexahedron.rs:1-100).  The reference expresses these as Rust
traits with default methods; here the shared behavior lives on
:class:`Polygon3d` / :class:`ConvexPolyhedron` base classes operating on
numpy vertex arrays (geometry setup is host-side, not a device hot path).

Orientation conventions match the reference:

* polygon vertices are wound counter-clockwise, so the area vector /
  normal follows the right-hand rule (lib.rs:415-457);
* a polyhedron's faces are oriented with normals pointing **into** the
  solid (hexahedron.rs:89 "must choose faces carefully so that they
  point towards the interior"), so :meth:`ConvexPolyhedron.half_spaces`
  (outward ``-n``; lib.rs:406-413) bound the solid and feed directly
  into :meth:`fenris_tpu_torch.geometry.PolyMesh.intersect_convex_polyhedron`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np


__all__ = [
    "PolygonClosestPoint",
    "SignedDistanceResult",
    "Polygon3d",
    "Quad3d",
    "Quad2d",
    "ConvexPolyhedron",
    "Hexahedron",
    "compute_polyhedron_volume_from_faces",
]


class PolygonClosestPoint(NamedTuple):
    """Result of :meth:`Polygon3d.closest_point` (lib.rs:374-388)."""

    closest_point: np.ndarray
    distance: float


class SignedDistanceResult(NamedTuple):
    """Signed-distance query result (sdf.rs / lib.rs:540-578)."""

    feature_id: int
    point: np.ndarray
    signed_distance: float


@dataclass(frozen=True)
class Polygon3d:
    """A planar convex polygon in 3D, vertices wound counter-clockwise.

    Implements the reference's ``ConvexPolygon3d`` default methods
    (lib.rs:393-531).
    """

    vertices: np.ndarray  # [n, 3]

    @staticmethod
    def from_vertices(vertices) -> "Polygon3d":
        return Polygon3d(np.asarray(vertices, dtype=np.float64))

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    def compute_area_vector(self) -> np.ndarray:
        """Triangle-fan sum of 0.5 * AB x AC (lib.rs:420-439): outward
        w.r.t. counter-clockwise winding, magnitude = area."""
        v = np.asarray(self.vertices, dtype=np.float64)
        if len(v) < 3:
            raise ValueError("Polygons must have at least 3 vertices.")
        ab = v[1:-1] - v[0]
        ac = v[2:] - v[0]
        return 0.5 * np.cross(ab, ac).sum(axis=0)

    def compute_normal(self) -> np.ndarray:
        """Normalized area vector — robust to leading collinear segments
        (lib.rs:441-457)."""
        a = self.compute_area_vector()
        return a / np.linalg.norm(a)

    def area(self) -> float:
        return float(np.linalg.norm(self.compute_area_vector()))

    def compute_plane(self):
        from . import Plane

        return Plane(self.vertices[0].astype(np.float64), self.compute_normal())

    def compute_half_space(self):
        """Half-space bounded by the polygon plane with outward normal
        ``-n`` (lib.rs:406-413): for interior-facing polyhedron faces the
        returned half-space contains the solid."""
        from . import HalfSpace

        return HalfSpace.from_point_and_normal(
            self.vertices[0].astype(np.float64), -self.compute_normal()
        )

    def closest_point(self, point) -> PolygonClosestPoint:
        """Closest point on the polygon (lib.rs:459-530): plane projection
        if the point lies in the extruded prism, else the nearest edge."""
        p = np.asarray(point, dtype=np.float64)
        v = np.asarray(self.vertices, dtype=np.float64)
        n = self.compute_normal()
        nv = len(v)
        v2 = np.roll(v, -1, axis=0)
        e = v2 - v  # [n, 3] edge vectors
        # Prism half-space normals e x n (lib.rs:483: the reference's
        # clockwise-convention quirk — for CCW winding with right-hand
        # normal, e x n points *outward* from the polygon, so the point
        # is inside the prism iff (p - v_i) . (e_i x n) <= 0 for all i).
        hn = np.cross(e, n)
        inside = bool(np.all(((p - v) * hn).sum(axis=1) <= 0.0))
        if inside:
            d = float(n @ (p - v[0]))
            return PolygonClosestPoint(p - d * n, abs(d))
        ee = (e * e).sum(axis=1)
        t = np.clip(((p - v) * e).sum(axis=1) / np.where(ee == 0.0, 1.0, ee), 0.0, 1.0)
        proj = v + t[:, None] * e
        d2 = ((proj - p) ** 2).sum(axis=1)
        k = int(np.argmin(d2))
        return PolygonClosestPoint(proj[k], float(np.sqrt(d2[k])))

    def distance(self, point) -> float:
        return self.closest_point(point).distance


@dataclass(frozen=True)
class Quad3d(Polygon3d):
    """A quadrilateral in 3D (primitives/quad.rs:8-30): a 4-vertex
    :class:`Polygon3d`."""

    def __post_init__(self):
        if len(self.vertices) != 4:
            raise ValueError("Quad3d requires exactly 4 vertices")

    @staticmethod
    def from_vertices(vertices) -> "Quad3d":
        return Quad3d(np.asarray(vertices, dtype=np.float64))


@dataclass(frozen=True)
class Quad2d:
    """A 2D quadrilateral, counter-clockwise winding (quad.rs:43-123)."""

    vertices: np.ndarray  # [4, 2]

    @staticmethod
    def from_vertices(vertices) -> "Quad2d":
        v = np.asarray(vertices, dtype=np.float64)
        if v.shape != (4, 2):
            raise ValueError("Quad2d requires exactly 4 2D vertices")
        return Quad2d(v)

    def concave_corner(self) -> Optional[int]:
        """Index of a concave corner, if any (quad.rs:53-69): corner i+1
        is concave when perp(x_{i+2} - x_{i+1}, x_i - x_{i+1}) < 0."""
        v = self.vertices
        for i in range(4):
            x_prev = v[i]
            x_curr = v[(i + 1) % 4]
            x_next = v[(i + 2) % 4]
            a = x_next - x_curr
            b = x_prev - x_curr
            if a[0] * b[1] - a[1] * b[0] < 0.0:
                return (i + 1) % 4
        return None

    def split_into_triangle_connectivities(self) -> Tuple[Tuple[int, int, int], Tuple[int, int, int]]:
        """Two triangles of local indices covering the quad (quad.rs:76-88);
        a concave corner, when present, picks the valid diagonal."""
        c = self.concave_corner()
        if c is not None:
            return (
                ((c + 2) % 4, (c + 3) % 4, c % 4),
                ((c + 2) % 4, c % 4, (c + 1) % 4),
            )
        return ((0, 1, 2), (0, 2, 3))

    def split_into_triangles(self):
        from . import Triangle

        c1, c2 = self.split_into_triangle_connectivities()
        v = self.vertices
        return Triangle(v[list(c1)]), Triangle(v[list(c2)])

    def area(self) -> float:
        t1, t2 = self.split_into_triangles()
        return t1.area() + t2.area()

    def distance(self, point) -> float:
        from .polygon import SimplePolygon2d

        return abs(SimplePolygon2d.from_vertices(self.vertices).distance(point))


class ConvexPolyhedron:
    """A convex polyhedron given by interior-facing convex faces.

    Implements the reference's ``ConvexPolyhedron`` default methods
    (lib.rs:533-615).  Subclasses (or the generic constructor
    :meth:`from_faces`) provide :meth:`faces`.
    """

    def __init__(self, faces: Sequence[Polygon3d]):
        self._faces = list(faces)

    @staticmethod
    def from_vertices_and_faces(vertices, face_indices) -> "ConvexPolyhedron":
        """Build from a vertex array and per-face index lists (each face
        wound so its normal points into the solid)."""
        v = np.asarray(vertices, dtype=np.float64)
        return ConvexPolyhedron([Polygon3d(v[list(f)]) for f in face_indices])

    @property
    def num_faces(self) -> int:
        return len(self.faces())

    def faces(self) -> List[Polygon3d]:
        return self._faces

    def half_spaces(self):
        """The outward half-spaces bounding the solid — the direct input
        to :meth:`PolyMesh.intersect_convex_polyhedron`."""
        return [f.compute_half_space() for f in self.faces()]

    def contains_point(self, point) -> bool:
        """True iff every face half-space contains the point (lib.rs:594-614)."""
        p = np.asarray(point, dtype=np.float64)
        return all(bool(hs.contains(p)) for hs in self.half_spaces())

    def compute_signed_distance(self, point) -> SignedDistanceResult:
        """Signed distance via per-face closest points (lib.rs:540-578):
        negative inside, positive outside, with the closest face id."""
        p = np.asarray(point, dtype=np.float64)
        faces = self.faces()
        if len(faces) < 4:
            raise ValueError("Polyhedron must have at least 4 faces.")
        inside = True
        best = None
        best_i = 0
        for i, face in enumerate(faces):
            r = face.closest_point(p)
            if best is None or r.distance < best.distance:
                best, best_i = r, i
            n = face.compute_normal()
            # outside any outward half-space anchored at the face's
            # closest point => outside the polyhedron (lib.rs:560-567)
            if float(-n @ (p - r.closest_point)) > 0.0:
                inside = False
        sign = -1.0 if inside else 1.0
        return SignedDistanceResult(best_i, best.closest_point, sign * best.distance)

    def query_signed_distance(self, point) -> SignedDistanceResult:
        return self.compute_signed_distance(point)

    def distance(self, point) -> float:
        return max(self.compute_signed_distance(point).signed_distance, 0.0)

    def compute_volume(self) -> float:
        return compute_polyhedron_volume_from_faces(self.faces())

    def bounding_box(self):
        from . import Aabb

        return Aabb.from_points(np.concatenate([f.vertices for f in self.faces()]))


def compute_polyhedron_volume_from_faces(faces: Sequence[Polygon3d]) -> float:
    """Divergence-theorem volume |sum_f (n_f . x_f0) * area_f| / 3 over
    consistently oriented boundary faces (lib.rs:617-648)."""
    volume = 0.0
    for face in faces:
        if face.num_vertices > 2:
            av = face.compute_area_vector()
            area = float(np.linalg.norm(av))
            if area > 0.0:
                volume += float((av / area) @ face.vertices[0]) * area
    return abs(volume) / 3.0


# Hex8-convention face table with interior-pointing winding
# (hexahedron.rs:86-99).
_HEX_FACES = (
    (0, 1, 2, 3),
    (4, 5, 1, 0),
    (5, 6, 2, 1),
    (6, 7, 3, 2),
    (0, 3, 7, 4),
    (4, 7, 6, 5),
)


class Hexahedron(ConvexPolyhedron):
    """A hexahedron with Hex8-convention vertex ordering
    (primitives/hexahedron.rs:8-100)."""

    def __init__(self, vertices):
        v = np.asarray(vertices, dtype=np.float64)
        if v.shape != (8, 3):
            raise ValueError("Hexahedron requires exactly 8 3D vertices")
        self.vertices = v
        super().__init__([Quad3d(v[list(f)]) for f in _HEX_FACES])

    @staticmethod
    def from_vertices(vertices) -> "Hexahedron":
        return Hexahedron(vertices)

    @staticmethod
    def reference() -> "Hexahedron":
        """The [-1, 1]^3 reference hexahedron (hexahedron.rs:41-54)."""
        return Hexahedron(
            np.array(
                [
                    [-1.0, -1.0, -1.0],
                    [1.0, -1.0, -1.0],
                    [1.0, 1.0, -1.0],
                    [-1.0, 1.0, -1.0],
                    [-1.0, -1.0, 1.0],
                    [1.0, -1.0, 1.0],
                    [1.0, 1.0, 1.0],
                    [-1.0, 1.0, 1.0],
                ]
            )
        )
