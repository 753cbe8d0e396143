"""Geometric primitives: lines, segments, planes, triangle/tet queries.

Counterpart of ``fenris_tpu/geometry/primitives.py``: a host-numpy copy that gives
the same results.

Parity: fenris-geometry/src/primitives/line.rs (Line/LineSegment
intersections and closest points, :115-434), triangle.rs (orientation,
area/normal, Voronoi-region closest point + distance, solid angle /
winding number, :18-299), tetrahedron.rs (:13-119), plane.rs.

Host-side numpy; single-query scalar semantics (vectorized batch variants
are provided where the FE pipeline needs them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "Line",
    "HalfPlane",
    "Disk",
    "segment_segment_closest",
    "triangle_closest_point",
    "tetrahedron_closest_point",
    "compute_winding_number_for_triangles_3d",
]

_EPS = np.finfo(np.float64).eps


@dataclass(frozen=True)
class Line:
    """Infinite line through ``point`` with direction ``dir`` (line.rs:276)."""

    point: np.ndarray
    dir: np.ndarray

    @staticmethod
    def from_point_and_dir(point, dir) -> "Line":
        return Line(np.asarray(point, dtype=np.float64), np.asarray(dir, dtype=np.float64))

    @staticmethod
    def from_point_through_point(point, through) -> "Line":
        p = np.asarray(point, dtype=np.float64)
        return Line(p, np.asarray(through, dtype=np.float64) - p)

    def tangent(self) -> np.ndarray:
        return self.dir / np.linalg.norm(self.dir)

    def point_from_parameter(self, t: float) -> np.ndarray:
        return self.point + t * self.dir

    def project_point_parametric(self, point) -> float:
        """t minimizing ||point - (p + t d)|| (line.rs:327)."""
        d = self.dir
        return float((np.asarray(point) - self.point) @ d / (d @ d))

    def project_point(self, point) -> np.ndarray:
        return self.point_from_parameter(self.project_point_parametric(point))

    def intersect_line_parametric(self, other: "Line") -> Optional[Tuple[float, float]]:
        """2D line-line intersection parameters (t_self, t_other) or None
        if (near-)parallel (line.rs:364)."""
        d1, d2 = self.dir, other.dir
        denom = d1[0] * d2[1] - d1[1] * d2[0]
        scale = max(np.linalg.norm(d1) * np.linalg.norm(d2), _EPS)
        if abs(denom) <= 100.0 * _EPS * scale:
            return None
        dp = other.point - self.point
        t1 = (dp[0] * d2[1] - dp[1] * d2[0]) / denom
        t2 = (dp[0] * d1[1] - dp[1] * d1[0]) / denom
        return float(t1), float(t2)

    def intersect(self, other: "Line") -> Optional[np.ndarray]:
        ts = self.intersect_line_parametric(other)
        return None if ts is None else self.point_from_parameter(ts[0])

    def intersect_plane_parametric(self, plane) -> Optional[float]:
        """t with p + t d on the plane, None if parallel (line.rs:423)."""
        n = np.asarray(plane.normal, dtype=np.float64)
        dn = float(self.dir @ n)
        if abs(dn) <= 100.0 * _EPS * max(np.linalg.norm(self.dir), _EPS):
            return None
        return float((np.asarray(plane.point) - self.point) @ n / dn)


@dataclass(frozen=True)
class HalfPlane:
    """2D half-plane {x : n·(x - p) <= 0} (outward normal, like HalfSpace)."""

    point: np.ndarray
    normal: np.ndarray

    @staticmethod
    def from_point_and_normal(point, normal) -> "HalfPlane":
        n = np.asarray(normal, dtype=np.float64)
        return HalfPlane(np.asarray(point, dtype=np.float64), n / np.linalg.norm(n))

    def signed_distance(self, points) -> np.ndarray:
        return (np.asarray(points) - self.point) @ self.normal

    def contains(self, points) -> np.ndarray:
        return self.signed_distance(points) <= 0.0

    def surface(self) -> Line:
        n = self.normal
        return Line(self.point, np.array([-n[1], n[0]]))


@dataclass(frozen=True)
class Disk:
    """Solid 2D disk (primitives; line.rs:154 intersections)."""

    center: np.ndarray
    radius: float

    def contains(self, points) -> np.ndarray:
        p = np.asarray(points)
        return np.sum((p - self.center) ** 2, axis=-1) <= self.radius**2


# ---------------------------------------------------------------------------
# Segment queries (methods are attached to geometry.LineSegment in __init__)
# ---------------------------------------------------------------------------


def segment_segment_closest(p1, q1, p2, q2) -> Tuple[float, float, np.ndarray, np.ndarray]:
    """Closest points between segments [p1,q1] and [p2,q2].

    Returns (s, t, c1, c2) with c1 = p1 + s (q1 - p1), c2 = p2 + t (q2 - p2)
    realizing the minimum distance.  Handles degenerate (point) segments.
    (LineSegment closest-pair query; the reference exposes the pieces via
    line.rs closest_point/intersect; this is the standard clamped quadratic
    minimization.)
    """
    p1, q1, p2, q2 = (np.asarray(v, dtype=np.float64) for v in (p1, q1, p2, q2))
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = d1 @ d1
    e = d2 @ d2
    f = d2 @ r
    if a <= _EPS and e <= _EPS:
        return 0.0, 0.0, p1, p2
    if a <= _EPS:
        t = np.clip(f / e, 0.0, 1.0)
        s = 0.0
    else:
        c = d1 @ r
        if e <= _EPS:
            t = 0.0
            s = np.clip(-c / a, 0.0, 1.0)
        else:
            b = d1 @ d2
            denom = a * e - b * b
            s = np.clip((b * f - c * e) / denom, 0.0, 1.0) if denom > _EPS * a * e else 0.0
            t = (b * s + f) / e
            if t < 0.0:
                t = 0.0
                s = np.clip(-c / a, 0.0, 1.0)
            elif t > 1.0:
                t = 1.0
                s = np.clip((b - c) / a, 0.0, 1.0)
    c1 = p1 + s * d1
    c2 = p2 + t * d2
    return float(s), float(t), c1, c2


# ---------------------------------------------------------------------------
# Triangle / tetrahedron closest-point queries (triangle.rs:450/536 closest
# point impls; tetrahedron.rs:616)
# ---------------------------------------------------------------------------


def triangle_closest_point(vertices, point) -> Tuple[np.ndarray, str]:
    """Closest point on a triangle + Voronoi-region tag.

    Works in 2D and 3D.  Returns ``(closest, region)`` where region is one
    of ``"vertex:i"``, ``"edge:ij"``, ``"interior"`` — the per-Voronoi-region
    semantics the reference property-tests (triangle.rs closest-point,
    tests/unit_tests/element/tetrahedron.rs:259-313).
    """
    v = np.asarray(vertices, dtype=np.float64)
    p = np.asarray(point, dtype=np.float64)
    a, b, c = v[0], v[1], v[2]
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = ab @ ap
    d2 = ac @ ap
    if d1 <= 0.0 and d2 <= 0.0:
        return a, "vertex:0"
    bp = p - b
    d3 = ab @ bp
    d4 = ac @ bp
    if d3 >= 0.0 and d4 <= d3:
        return b, "vertex:1"
    vc = d1 * d4 - d3 * d2
    if vc <= 0.0 and d1 >= 0.0 and d3 <= 0.0:
        w = d1 / (d1 - d3)
        return a + w * ab, "edge:01"
    cp = p - c
    d5 = ab @ cp
    d6 = ac @ cp
    if d6 >= 0.0 and d5 <= d6:
        return c, "vertex:2"
    vb = d5 * d2 - d1 * d6
    if vb <= 0.0 and d2 >= 0.0 and d6 <= 0.0:
        w = d2 / (d2 - d6)
        return a + w * ac, "edge:02"
    va = d3 * d6 - d5 * d4
    if va <= 0.0 and (d4 - d3) >= 0.0 and (d5 - d6) >= 0.0:
        w = (d4 - d3) / ((d4 - d3) + (d5 - d6))
        return b + w * (c - b), "edge:12"
    denom = 1.0 / (va + vb + vc)
    return a + ab * (vb * denom) + ac * (vc * denom), "interior"


_TET_FACES = ((0, 2, 1), (0, 1, 3), (1, 2, 3), (0, 3, 2))  # outward for +vol


def tetrahedron_closest_point(vertices, point) -> Tuple[np.ndarray, bool]:
    """Closest point on/in a tetrahedron; returns (closest, inside).

    Inside points return themselves (distance 0); outside points return the
    minimum over the four triangular faces (tetrahedron.rs:616 closest
    point / Distance impl).
    """
    v = np.asarray(vertices, dtype=np.float64)
    p = np.asarray(point, dtype=np.float64)
    vol = np.linalg.det(np.stack([v[1] - v[0], v[2] - v[0], v[3] - v[0]]))
    faces = _TET_FACES if vol >= 0 else tuple(f[::-1] for f in _TET_FACES)
    inside = True
    best = None
    best_d2 = np.inf
    for f in faces:
        a, b, c = v[f[0]], v[f[1]], v[f[2]]
        n = np.cross(b - a, c - a)
        if (p - a) @ n > 0.0:
            inside = False
        cp, _ = triangle_closest_point(np.stack([a, b, c]), p)
        d2 = float(np.sum((p - cp) ** 2))
        if d2 < best_d2:
            best_d2 = d2
            best = cp
    if inside:
        return p, True
    return best, False


def compute_winding_number_for_triangles_3d(triangles, point) -> float:
    """Generalized winding number of a triangle soup at ``point``.

    Sum of signed solid angles / 4π (triangle.rs:288, using the
    van Oosterom–Strackee formula of compute_solid_angle :271); ±1 inside a
    closed, consistently-oriented surface, 0 outside.
    """
    p = np.asarray(point, dtype=np.float64)
    total = 0.0
    for tri in triangles:
        v = np.asarray(tri, dtype=np.float64)
        a, b, c = v[0] - p, v[1] - p, v[2] - p
        la, lb, lc = np.linalg.norm(a), np.linalg.norm(b), np.linalg.norm(c)
        num = np.linalg.det(np.stack([a, b, c]))
        den = la * lb * lc + (a @ b) * lc + (b @ c) * la + (c @ a) * lb
        total += 2.0 * np.arctan2(num, den)
    return total / (4.0 * np.pi)
