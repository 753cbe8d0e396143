"""Quadrature rules on the reference domains (numpy, host side).

Counterpart of ``fenris_tpu/quadrature/``: univariate Gauss,
Gauss-Lobatto and Gauss-Jacobi rules, tensor-product rules for quads and hexes, the
minimum-point Witherden–Vincent tables (``polyquad``, the port's own copy
of ``_polyquad_data.npz``), collapsed-coordinate rules beyond the
tables (triangle, tetrahedron, prism, pyramid), total-order selection, the canonical per-element rules and
composite rules by subdivision (``subdivide``).  Point
orders are the JAX package's, so tabulations match it entry for entry.

A rule is a ``Rule(weights[q], points[q, d])`` pair of float64 arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = [
    "Rule",
    "gauss",
    "gauss_lobatto",
    "gauss_jacobi",
    "tensor_product",
    "quadrilateral_gauss",
    "hexahedron_gauss",
    "canonical_mass",
    "canonical_stiffness",
    "polyquad",
    "simplex",
    "total_order",
    "subdivide",
    "subdivide_univariate",
    "subdivide_triangle",
]


class Rule(NamedTuple):
    """A quadrature rule ``(weights[q], points[q, d])`` on a reference domain."""

    weights: np.ndarray
    points: np.ndarray

    @property
    def num_points(self) -> int:
        return len(self.weights)

    @property
    def dim(self) -> int:
        return self.points.shape[1]

    def integrate(self, f) -> float:
        """The rule applied to a callable ``f(point [d]) -> scalar``."""
        return float(np.dot(self.weights, np.array([f(p) for p in self.points])))


from . import polyquad, simplex, subdivide, total_order  # noqa: E402
from .canonical import canonical_mass, canonical_stiffness  # noqa: E402
from .subdivide import subdivide_triangle, subdivide_univariate  # noqa: E402
from .tensor import hexahedron_gauss, quadrilateral_gauss, tensor_product  # noqa: E402
from .univariate import gauss, gauss_jacobi, gauss_lobatto  # noqa: E402
