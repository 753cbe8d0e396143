"""Polygons: simple polygons (2D/3D planar) and convex polygon clipping.

Counterpart of ``fenris_tpu/geometry/polygon.py``: a host-numpy copy that gives
the same results.

Parity: fenris-geometry/src/polygon.rs (``SimplePolygon``/``Polygon2d``:
signed area via the boundary form of Green's theorem, angle-weighted
pseudonormal signed distance, segment intersection tests, triangulation,
3D planar half-space clipping, :17-432) and src/polytope.rs
(``ConvexPolygon``: half-plane/polygon intersection, containment,
triangulation, :11-196).

Conventions: vertex loops are ordered; a positively-oriented (CCW) 2D
polygon has outward edge normals ``(t_y, -t_x)`` for edge tangent ``t``.
Half-planes/half-spaces contain ``{x : n·(x-p) <= 0}`` (outward normal),
matching :class:`..geometry.HalfSpace`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ClosestEdge", "SimplePolygon2d", "SimplePolygon3d", "ConvexPolygon"]

_EPS = np.finfo(np.float64).eps


class ClosestEdge(NamedTuple):
    """Closest-edge query result (polygon.rs:30)."""

    signed_distance: float
    edge_parameter: float
    edge_point: np.ndarray
    edge_index: int


def _as_loop(vertices) -> np.ndarray:
    v = np.asarray(vertices, dtype=np.float64)
    if v.ndim != 2:
        raise ValueError("vertices must be [n, d]")
    return v


@dataclass(frozen=True)
class SimplePolygon2d:
    """Simple (non-self-intersecting) polygon in the plane (polygon.rs:17)."""

    vertices: np.ndarray  # [n, 2]

    @staticmethod
    def from_vertices(vertices) -> "SimplePolygon2d":
        return SimplePolygon2d(_as_loop(vertices))

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    @property
    def num_edges(self) -> int:
        return len(self.vertices)

    def edge(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        v = self.vertices
        return v[i], v[(i + 1) % len(v)]

    def signed_area(self) -> float:
        """Positive iff counterclockwise (polygon.rs:163-181)."""
        v = self.vertices
        b = np.roll(v, -1, axis=0)
        return float(0.5 * np.sum((b[:, 1] - v[:, 1]) * (b[:, 0] + v[:, 0])))

    def area(self) -> float:
        return abs(self.signed_area())

    def orientation(self) -> str:
        return "counterclockwise" if self.signed_area() > 0 else "clockwise"

    def _edge_normal(self, i: int) -> np.ndarray:
        a, b = self.edge(i)
        t = b - a
        n = np.array([t[1], -t[0]])
        ln = np.linalg.norm(n)
        return n / ln if ln > 0 else n

    def pseudonormal_on_edge(self, edge_index: int, t: float) -> np.ndarray:
        """Angle-weighted pseudonormal at parameter t of an edge
        (polygon.rs:54-60): endpoint parameters average the neighboring
        edge's normal; interior parameters return the edge normal."""
        n = self._edge_normal(edge_index)
        m = self.num_edges
        if t == 0.0:
            n = n + self._edge_normal((edge_index - 1) % m)
        elif t == 1.0:
            n = n + self._edge_normal((edge_index + 1) % m)
        ln = np.linalg.norm(n)
        return n / ln if ln > 0 else n

    def closest_edge(self, x) -> Optional[ClosestEdge]:
        """Closest edge + pseudonormal-signed distance (polygon.rs:111).

        Negative signed distance = inside (for a CCW polygon).
        """
        x = np.asarray(x, dtype=np.float64)
        if self.num_edges == 0:
            return None
        best_i, best_d2 = 0, np.inf
        for i in range(self.num_edges):
            a, b = self.edge(i)
            ab = b - a
            denom = ab @ ab
            t = 0.0 if denom <= _EPS else float(np.clip((x - a) @ ab / denom, 0.0, 1.0))
            cp = a + t * ab
            d2 = float(np.sum((x - cp) ** 2))
            if d2 < best_d2:
                best_i, best_d2 = i, d2
        a, b = self.edge(best_i)
        ab = b - a
        denom = ab @ ab
        t = 0.0 if denom <= _EPS else float(np.clip((x - a) @ ab / denom, 0.0, 1.0))
        cp = a + t * ab
        pn = self.pseudonormal_on_edge(best_i, t)
        d = x - cp
        sign = 1.0 if d @ pn >= 0 else -1.0
        return ClosestEdge(
            signed_distance=sign * float(np.linalg.norm(d)),
            edge_parameter=t,
            edge_point=cp,
            edge_index=best_i,
        )

    def contains_point(self, x) -> bool:
        ce = self.closest_edge(x)
        return ce is not None and ce.signed_distance <= 0.0

    def distance(self, x) -> float:
        """Unsigned distance, 0 inside (polygon.rs Distance impl :380)."""
        ce = self.closest_edge(x)
        return max(ce.signed_distance, 0.0) if ce is not None else np.inf

    def intersects_segment(self, p, q) -> bool:
        """True iff segment [p, q] intersects the polygon (polygon.rs:105+):
        either it crosses an edge, or an endpoint lies inside."""
        from .primitives import segment_segment_closest

        p = np.asarray(p, dtype=np.float64)
        q = np.asarray(q, dtype=np.float64)
        if self.num_edges == 0:
            return False
        for i in range(self.num_edges):
            a, b = self.edge(i)
            _, _, c1, c2 = segment_segment_closest(p, q, a, b)
            if np.sum((c1 - c2) ** 2) <= (100 * _EPS) ** 2:
                return True
        return self.contains_point(p) or self.contains_point(q)

    def triangulate_at_point(self, point) -> List[np.ndarray]:
        """Triangles (point, v_i, v_i+1) (polygon.rs:399)."""
        point = np.asarray(point, dtype=np.float64)
        v = self.vertices
        return [
            np.stack([point, v[i], v[(i + 1) % len(v)]]) for i in range(len(v))
        ]

    def triangulate(self) -> List[np.ndarray]:
        """Fan triangulation from the vertex average (polygon.rs:415)."""
        return self.triangulate_at_point(self.vertices.mean(axis=0))


@dataclass(frozen=True)
class SimplePolygon3d:
    """Planar polygon embedded in 3D (polygon.rs SimplePolygon<T, 3>)."""

    vertices: np.ndarray  # [n, 3]

    @staticmethod
    def from_vertices(vertices) -> "SimplePolygon3d":
        return SimplePolygon3d(_as_loop(vertices))

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    def area_vector(self) -> np.ndarray:
        """Newell area vector: 0.5 Σ v_i × v_{i+1} (polygon.rs:250)."""
        v = self.vertices
        b = np.roll(v, -1, axis=0)
        return 0.5 * np.sum(np.cross(v, b), axis=0)

    def area(self) -> float:
        return float(np.linalg.norm(self.area_vector()))

    def normal(self) -> np.ndarray:
        av = self.area_vector()
        n = np.linalg.norm(av)
        return av / n if n > 0 else av

    def intersect_half_space(self, half) -> "SimplePolygon3d":
        """Clip against {x : n·(x-p) <= 0} keeping loop order
        (polygon.rs:266)."""
        v = self.vertices
        if len(v) == 0:
            return self
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
        return SimplePolygon3d(
            np.asarray(out) if out else np.zeros((0, 3))
        )

    def triangulate(self) -> List[np.ndarray]:
        c = self.vertices.mean(axis=0)
        v = self.vertices
        return [np.stack([c, v[i], v[(i + 1) % len(v)]]) for i in range(len(v))]


@dataclass(frozen=True)
class ConvexPolygon:
    """Convex polygon with CCW-ordered vertices (polytope.rs:11).

    Degenerate cases follow the reference: 0 vertices = empty set,
    1 = point, 2 = line segment.
    """

    vertices: np.ndarray  # [n, 2]

    @staticmethod
    def from_vertices(vertices) -> "ConvexPolygon":
        """Assumes CCW order + convexity (polytope.rs:37)."""
        return ConvexPolygon(_as_loop(vertices))

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    @property
    def num_edges(self) -> int:
        n = len(self.vertices)
        return n if n >= 3 else (1 if n == 2 else 0)

    def is_empty(self) -> bool:
        return len(self.vertices) == 0

    def is_point(self) -> bool:
        return len(self.vertices) == 1

    def is_line_segment(self) -> bool:
        return len(self.vertices) == 2

    def is_convex(self) -> bool:
        """All turns non-clockwise (validation helper)."""
        v = self.vertices
        n = len(v)
        if n < 4:
            return True
        cross = []
        for i in range(n):
            a, b, c = v[i], v[(i + 1) % n], v[(i + 2) % n]
            cross.append((b[0] - a[0]) * (c[1] - b[1]) - (b[1] - a[1]) * (c[0] - b[0]))
        return all(x >= -1e-12 for x in cross)

    def half_planes(self):
        """Outward half-planes of each edge (polytope.rs:85)."""
        from .primitives import HalfPlane

        out = []
        v = self.vertices
        n = len(v)
        for i in range(n if n >= 3 else n - 1):
            a, b = v[i], v[(i + 1) % n]
            t = b - a
            nrm = np.array([t[1], -t[0]])
            out.append(HalfPlane.from_point_and_normal(a, nrm))
        return out

    def contains_point(self, x, tol: float = 0.0) -> bool:
        """Inside all edge half-planes (polytope.rs:98)."""
        x = np.asarray(x, dtype=np.float64)
        if self.is_empty():
            return False
        if self.is_point():
            return bool(np.all(np.abs(x - self.vertices[0]) <= tol))
        if self.is_line_segment():
            # the lone edge half-plane would accept its whole side
            # (the reference refuses this case, polytope.rs:102; we
            # answer the segment-membership question exactly instead)
            a, b = self.vertices
            t = b - a
            L2 = float(t @ t)
            s = 0.0 if L2 == 0.0 else float(np.clip((x - a) @ t / L2, 0.0, 1.0))
            return bool(np.linalg.norm(x - (a + s * t)) <= tol)
        for hp in self.half_planes():
            if hp.signed_distance(x) > tol:
                return False
        return True

    def intersect_halfplane(self, half) -> "ConvexPolygon":
        """Sutherland–Hodgman clip preserving CCW order (polytope.rs:114)."""
        v = self.vertices
        n = len(v)
        if n == 0:
            return self
        d = half.signed_distance(v)
        if n == 1:
            return self if d[0] <= 0 else ConvexPolygon(np.zeros((0, 2)))
        if n == 2:
            a, b = v[0], v[1]
            da, db = d[0], d[1]
            if da > 0 and db > 0:
                return ConvexPolygon(np.zeros((0, 2)))
            if da <= 0 and db <= 0:
                return self
            t = da / (da - db)
            cut = a + t * (b - a)
            kept = a if da <= 0 else b
            return ConvexPolygon(np.stack([kept, cut]))
        out: List[np.ndarray] = []
        for i in range(n):
            j = (i + 1) % n
            if d[i] <= 0:
                out.append(v[i])
            if (d[i] <= 0) != (d[j] <= 0):
                t = d[i] / (d[i] - d[j])
                out.append(v[i] + t * (v[j] - v[i]))
        return ConvexPolygon(np.asarray(out) if out else np.zeros((0, 2)))

    def intersect_polygon(self, other: "ConvexPolygon") -> "ConvexPolygon":
        """Intersection = successive clips against the other's half-planes
        (polytope.rs:152)."""
        result = self
        for hp in other.half_planes():
            result = result.intersect_halfplane(hp)
            if result.is_empty():
                break
        return result

    def signed_area(self) -> float:
        return SimplePolygon2d(self.vertices).signed_area() if len(self.vertices) >= 3 else 0.0

    def area(self) -> float:
        return abs(self.signed_area())

    def triangulate(self) -> List[np.ndarray]:
        """Fan triangulation (v0, v_i, v_{i+1}) (polytope.rs:175)."""
        v = self.vertices
        return [np.stack([v[0], v[i], v[i + 1]]) for i in range(1, len(v) - 1)]
