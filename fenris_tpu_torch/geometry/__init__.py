"""Geometry toolkit: AABBs, primitives, signed distance functions, polymesh.

Parity: fenris-geometry — ``AxisAlignedBoundingBox`` with distance/closest
point queries (lib.rs:87,:264-330), orientation tests (:355), primitive
shapes (src/primitives/ — extended queries in :mod:`.primitives`), polygons
(:mod:`.polygon` — polygon.rs + polytope.rs), the SDF trait + ``BoundedSdf``
(sdf.rs), and a general polytopal ``PolyMesh`` with topological half-space
intersection (:mod:`.polymesh` — polymesh.rs:66,:564-576) powering the
procedural sphere generator.

Counterpart of ``fenris_tpu/geometry/``, kept as its own copy in host
numpy: geometry setup is not a device hot path, so every result equals the
JAX package's.  ``Ball``, ``BoxSdf`` and ``SdfUnion`` are the SDFs the
meshers of :mod:`..mesh.procedural` take.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .polymesh import PolyMesh
from .polygon import ClosestEdge, ConvexPolygon, SimplePolygon2d, SimplePolygon3d
from .polyhedron import (
    ConvexPolyhedron,
    Hexahedron,
    Polygon3d,
    PolygonClosestPoint,
    Quad2d,
    Quad3d,
    SignedDistanceResult,
    compute_polyhedron_volume_from_faces,
)
from .primitives import (
    Disk,
    HalfPlane,
    Line,
    compute_winding_number_for_triangles_3d,
    segment_segment_closest,
    tetrahedron_closest_point,
    triangle_closest_point,
)

__all__ = [
    "Aabb",
    "HalfSpace",
    "Ball",
    "BoxSdf",
    "SdfUnion",
    "Triangle",
    "Tetrahedron",
    "LineSegment",
    "Plane",
    "orient2d",
    "orient3d",
    "PolyMesh",
    "convex_polygon_clip_halfplane",
    # primitives (fenris-geometry/src/primitives/)
    "Line",
    "HalfPlane",
    "Disk",
    "segment_segment_closest",
    "triangle_closest_point",
    "tetrahedron_closest_point",
    "compute_winding_number_for_triangles_3d",
    # polygons (polygon.rs, polytope.rs)
    "ClosestEdge",
    "SimplePolygon2d",
    "SimplePolygon3d",
    "ConvexPolygon",
    # convex polyhedra (lib.rs:393-648, primitives/quad.rs, hexahedron.rs)
    "Polygon3d",
    "PolygonClosestPoint",
    "Quad2d",
    "Quad3d",
    "ConvexPolyhedron",
    "Hexahedron",
    "SignedDistanceResult",
    "compute_polyhedron_volume_from_faces",
    # util (util.rs)
    "compute_orthonormal_vectors_3d",
    "slices_are_equal_shift_invariant",
]


# ---------------------------------------------------------------------------
# util (fenris-geometry/src/util.rs)
# ---------------------------------------------------------------------------


def compute_orthonormal_vectors_3d(normal) -> Tuple[np.ndarray, np.ndarray]:
    """Two unit vectors completing ``normal`` to an orthonormal frame
    (util.rs:5-20; the branchless Pixar "Building an Orthonormal Basis,
    Revisited" construction).  Vectorized: ``normal`` may be [..., 3]."""
    v = np.asarray(normal, dtype=np.float64)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    sign = np.copysign(1.0, z)
    a = -1.0 / (sign + z)
    b = x * y * a
    t1 = np.stack([1.0 + sign * x * x * a, sign * b, -sign * x], axis=-1)
    t2 = np.stack([b, sign + y * y * a, -y], axis=-1)
    return t1, t2


def slices_are_equal_shift_invariant(x, y, comparator=None) -> bool:
    """True if some cyclic shift of ``x`` matches ``y`` elementwise
    (util.rs:26-46)."""
    if comparator is None:
        comparator = lambda a, b: bool(np.all(a == b))
    n = len(x)
    if len(y) != n:
        return False
    if n == 0:
        return True
    for start in range(n):
        if all(comparator(x[(j + start) % n], y[j]) for j in range(n)):
            return True
    return False


# ---------------------------------------------------------------------------
# AABB
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Aabb:
    """Axis-aligned bounding box (fenris-geometry lib.rs:87)."""

    min: np.ndarray
    max: np.ndarray

    @staticmethod
    def from_points(points) -> "Aabb":
        p = np.asarray(points, dtype=np.float64)
        return Aabb(p.min(axis=0), p.max(axis=0))

    @property
    def center(self) -> np.ndarray:
        return (self.min + self.max) / 2.0

    @property
    def extents(self) -> np.ndarray:
        return self.max - self.min

    def contains(self, points) -> np.ndarray:
        p = np.asarray(points)
        return ((p >= self.min) & (p <= self.max)).all(axis=-1)

    def closest_point(self, points) -> np.ndarray:
        """Closest point inside the box per query (lib.rs:318)."""
        return np.clip(np.asarray(points), self.min, self.max)

    def dist2(self, points) -> np.ndarray:
        """Squared distance to the box (0 inside; lib.rs:264)."""
        p = np.asarray(points)
        d = np.maximum(self.min - p, 0.0) + np.maximum(p - self.max, 0.0)
        return np.sum(d * d, axis=-1)

    def max_dist2(self, points) -> np.ndarray:
        """Max squared distance to any point of the box (lib.rs:293)."""
        p = np.asarray(points)
        d = np.maximum(np.abs(self.min - p), np.abs(self.max - p))
        return np.sum(d * d, axis=-1)

    def intersects(self, other: "Aabb") -> bool:
        return bool(((self.min <= other.max) & (other.min <= self.max)).all())

    def enclose(self, other: "Aabb") -> "Aabb":
        return Aabb(np.minimum(self.min, other.min), np.maximum(self.max, other.max))

    def grow(self, amount: float) -> "Aabb":
        return Aabb(self.min - amount, self.max + amount)


# ---------------------------------------------------------------------------
# Orientation predicates (double precision; fenris-geometry lib.rs:355)
# ---------------------------------------------------------------------------


def orient2d(a, b, c) -> np.ndarray:
    """> 0 if (a, b, c) is counterclockwise."""
    a, b, c = (np.asarray(v) for v in (a, b, c))
    return (b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1]) - (
        b[..., 1] - a[..., 1]
    ) * (c[..., 0] - a[..., 0])


def orient3d(a, b, c, d) -> np.ndarray:
    """> 0 if d is on the positive side of plane (a, b, c)."""
    a, b, c, d = (np.asarray(v) for v in (a, b, c, d))
    m = np.stack([b - a, c - a, d - a], axis=-2)
    return np.linalg.det(m)


# ---------------------------------------------------------------------------
# Primitives + SDFs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HalfSpace:
    """{x : n·(x - p) <= 0}: the half-space behind the plane (normal points out)."""

    point: np.ndarray
    normal: np.ndarray  # unit

    @staticmethod
    def from_point_and_normal(point, normal) -> "HalfSpace":
        n = np.asarray(normal, dtype=np.float64)
        return HalfSpace(np.asarray(point, dtype=np.float64), n / np.linalg.norm(n))

    def signed_distance(self, points) -> np.ndarray:
        return (np.asarray(points) - self.point) @ self.normal

    def contains(self, points) -> np.ndarray:
        return self.signed_distance(points) <= 0.0


@dataclass(frozen=True)
class Plane:
    point: np.ndarray
    normal: np.ndarray

    def project(self, points) -> np.ndarray:
        p = np.asarray(points)
        d = (p - self.point) @ self.normal
        return p - d[..., None] * self.normal


@dataclass(frozen=True)
class Ball:
    """Solid ball; a :class:`BoundedSdf` (primitives + sdf.rs)."""

    center: np.ndarray
    radius: float

    def eval(self, points) -> np.ndarray:
        p = np.asarray(points)
        return np.linalg.norm(p - self.center, axis=-1) - self.radius

    def gradient(self, points) -> np.ndarray:
        p = np.asarray(points)
        d = p - self.center
        n = np.linalg.norm(d, axis=-1, keepdims=True)
        return d / np.maximum(n, 1e-300)

    def bounding_box(self):
        c = np.asarray(self.center, dtype=np.float64)
        return (c - self.radius, c + self.radius)


@dataclass(frozen=True)
class BoxSdf:
    """Axis-aligned box SDF."""

    min: np.ndarray
    max: np.ndarray

    def eval(self, points) -> np.ndarray:
        p = np.asarray(points)
        c = (np.asarray(self.min) + np.asarray(self.max)) / 2.0
        h = (np.asarray(self.max) - np.asarray(self.min)) / 2.0
        q = np.abs(p - c) - h
        outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
        inside = np.minimum(q.max(axis=-1), 0.0)
        return outside + inside

    def gradient(self, points) -> np.ndarray:
        eps = 1e-7
        p = np.asarray(points, dtype=np.float64)
        g = np.zeros_like(p)
        for ax in range(p.shape[-1]):
            e = np.zeros(p.shape[-1])
            e[ax] = eps
            g[..., ax] = (self.eval(p + e) - self.eval(p - e)) / (2 * eps)
        n = np.linalg.norm(g, axis=-1, keepdims=True)
        return g / np.maximum(n, 1e-300)

    def bounding_box(self):
        return (np.asarray(self.min, dtype=np.float64), np.asarray(self.max, dtype=np.float64))


@dataclass(frozen=True)
class SdfUnion:
    """Union of SDFs (min); bounded if all parts are."""

    parts: Tuple

    def eval(self, points):
        return np.minimum.reduce([p.eval(points) for p in self.parts])

    def gradient(self, points):
        vals = np.stack([p.eval(points) for p in self.parts])
        grads = np.stack([p.gradient(points) for p in self.parts])
        idx = np.argmin(vals, axis=0)
        return np.take_along_axis(
            grads, idx[None, ..., None], axis=0
        )[0]

    def bounding_box(self):
        los, his = zip(*(p.bounding_box() for p in self.parts))
        return (np.minimum.reduce(los), np.maximum.reduce(his))


@dataclass(frozen=True)
class LineSegment:
    """Segment [a, b] (line.rs:49); supports 2D and 3D queries."""

    a: np.ndarray
    b: np.ndarray

    @property
    def midpoint(self):
        return (np.asarray(self.a) + np.asarray(self.b)) / 2.0

    @property
    def length(self) -> float:
        return float(np.linalg.norm(np.asarray(self.b) - np.asarray(self.a)))

    def reverse(self) -> "LineSegment":
        return LineSegment(self.b, self.a)

    def to_line(self) -> "Line":
        a = np.asarray(self.a, dtype=np.float64)
        return Line(a, np.asarray(self.b, dtype=np.float64) - a)

    def tangent_dir(self) -> np.ndarray:
        d = np.asarray(self.b, dtype=np.float64) - np.asarray(self.a)
        return d / np.linalg.norm(d)

    def normal_dir(self) -> np.ndarray:
        """2D edge normal (t_y, -t_x): outward for CCW loops (line.rs:142)."""
        t = self.tangent_dir()
        return np.array([t[1], -t[0]])

    def point_from_parameter(self, t: float) -> np.ndarray:
        a = np.asarray(self.a, dtype=np.float64)
        return a + t * (np.asarray(self.b, dtype=np.float64) - a)

    def closest_point_parametric(self, point) -> float:
        """Clamped projection parameter in [0, 1] (line.rs:115)."""
        a, b = np.asarray(self.a, dtype=np.float64), np.asarray(self.b, dtype=np.float64)
        ab = b - a
        denom = float(ab @ ab)
        if denom == 0.0:
            return 0.0
        return float(np.clip((np.asarray(point) - a) @ ab / denom, 0.0, 1.0))

    def closest_point(self, points):
        a, b = np.asarray(self.a), np.asarray(self.b)
        ab = b - a
        t = np.clip(((np.asarray(points) - a) @ ab) / (ab @ ab), 0.0, 1.0)
        return a + t[..., None] * ab

    def distance(self, point) -> float:
        p = np.asarray(point, dtype=np.float64)
        return float(np.linalg.norm(p - self.point_from_parameter(self.closest_point_parametric(p))))

    def closest_segment(self, other: "LineSegment"):
        """Closest pair of points vs another segment -> (s, t, c1, c2)."""
        return segment_segment_closest(self.a, self.b, other.a, other.b)

    def intersect_segment_parametric(self, other: "LineSegment", tol: float = 1e-12):
        """Parameter t on self where the two 2D segments intersect, or None
        (line.rs:178)."""
        ts = self.to_line().intersect_line_parametric(other.to_line())
        if ts is None:
            return None
        t1, t2 = ts
        if -tol <= t1 <= 1.0 + tol and -tol <= t2 <= 1.0 + tol:
            return t1
        return None

    def intersect_half_plane_parametric(self, half: "HalfPlane"):
        """Sub-interval [t0, t1] of the segment inside the half-plane, or
        None (line.rs:217)."""
        da = float(half.signed_distance(np.asarray(self.a, dtype=np.float64)))
        db = float(half.signed_distance(np.asarray(self.b, dtype=np.float64)))
        if da > 0 and db > 0:
            return None
        if da <= 0 and db <= 0:
            return 0.0, 1.0
        t = da / (da - db)
        return (0.0, t) if da <= 0 else (t, 1.0)

    def intersect_half_plane(self, half: "HalfPlane") -> Optional["LineSegment"]:
        ts = self.intersect_half_plane_parametric(half)
        if ts is None:
            return None
        return LineSegment(self.point_from_parameter(ts[0]), self.point_from_parameter(ts[1]))

    def intersect_plane_parametric(self, plane: "Plane"):
        """t where the 3D segment crosses the plane, or None (line.rs:268)."""
        t = self.to_line().intersect_plane_parametric(plane)
        if t is None or not (0.0 <= t <= 1.0):
            return None
        return t

    def closest_point_to_plane(self, plane: "Plane") -> np.ndarray:
        """Closest point on the segment to a plane (line.rs:42): the
        intersection if it crosses, else the nearer endpoint."""
        t = self.to_line().intersect_plane_parametric(plane)
        if t is not None:
            return self.point_from_parameter(float(np.clip(t, 0.0, 1.0)))
        a = np.asarray(self.a, dtype=np.float64)
        b = np.asarray(self.b, dtype=np.float64)
        n = np.asarray(plane.normal)
        da = abs((a - plane.point) @ n)
        db = abs((b - plane.point) @ n)
        return a if da <= db else b


@dataclass(frozen=True)
class Triangle:
    vertices: np.ndarray  # [3, d]

    def area(self) -> float:
        v = np.asarray(self.vertices)
        e1, e2 = v[1] - v[0], v[2] - v[0]
        if v.shape[1] == 2:
            return 0.5 * abs(e1[0] * e2[1] - e1[1] * e2[0])
        return 0.5 * float(np.linalg.norm(np.cross(e1, e2)))

    def normal(self) -> np.ndarray:
        v = np.asarray(self.vertices)
        n = np.cross(v[1] - v[0], v[2] - v[0])
        return n / np.linalg.norm(n)

    def centroid(self) -> np.ndarray:
        return np.asarray(self.vertices).mean(axis=0)

    def edge(self, i: int) -> "LineSegment":
        v = np.asarray(self.vertices)
        return LineSegment(v[i], v[(i + 1) % 3])

    def closest_point(self, point):
        """Voronoi-region closest point -> (point, region) (triangle.rs)."""
        return triangle_closest_point(self.vertices, point)

    def distance(self, point) -> float:
        cp, _ = triangle_closest_point(self.vertices, point)
        return float(np.linalg.norm(np.asarray(point, dtype=np.float64) - cp))

    def solid_angle(self, point) -> float:
        """Signed solid angle subtended at ``point`` (triangle.rs:271)."""
        return 4.0 * np.pi * compute_winding_number_for_triangles_3d(
            [self.vertices], point
        )


@dataclass(frozen=True)
class Tetrahedron:
    vertices: np.ndarray  # [4, 3]

    def signed_volume(self) -> float:
        v = np.asarray(self.vertices)
        return float(np.linalg.det(np.stack([v[1] - v[0], v[2] - v[0], v[3] - v[0]])) / 6.0)

    def volume(self) -> float:
        return abs(self.signed_volume())

    def centroid(self) -> np.ndarray:
        return np.asarray(self.vertices).mean(axis=0)

    @staticmethod
    def reference() -> "Tetrahedron":
        """The [-1,1]-based reference tet (tetrahedron.rs:39)."""
        return Tetrahedron(
            np.array(
                [
                    [-1.0, -1.0, -1.0],
                    [1.0, -1.0, -1.0],
                    [-1.0, 1.0, -1.0],
                    [-1.0, -1.0, 1.0],
                ]
            )
        )

    def contains_point(self, point) -> bool:
        _, inside = tetrahedron_closest_point(self.vertices, point)
        return inside

    def closest_point(self, point):
        """(closest, inside) via face queries (tetrahedron.rs:616)."""
        return tetrahedron_closest_point(self.vertices, point)

    def distance(self, point) -> float:
        cp, inside = tetrahedron_closest_point(self.vertices, point)
        if inside:
            return 0.0
        return float(np.linalg.norm(np.asarray(point, dtype=np.float64) - cp))


# ---------------------------------------------------------------------------
# Convex clipping + PolyMesh
# ---------------------------------------------------------------------------


def convex_polygon_clip_halfplane(vertices: np.ndarray, half: HalfSpace) -> np.ndarray:
    """Sutherland-Hodgman clip of a convex polygon against a half-space."""
    v = np.asarray(vertices, dtype=np.float64)
    if len(v) == 0:
        return v
    d = half.signed_distance(v)
    out: List[np.ndarray] = []
    n = len(v)
    for i in range(n):
        j = (i + 1) % n
        if d[i] <= 0:
            out.append(v[i])
        if (d[i] <= 0) != (d[j] <= 0):
            t = d[i] / (d[i] - d[j])
            out.append(v[i] + t * (v[j] - v[i]))
    return np.asarray(out) if out else np.zeros((0, v.shape[1]))


