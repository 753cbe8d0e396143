"""Gauss quadrature for the hex8 slice (numpy, host side).

Counterpart of ``fenris_tpu/quadrature/univariate.py`` (``gauss``),
``tensor.py`` (``tensor_product``, ``hexahedron_gauss``) and
``canonical.py`` (``canonical_stiffness``), cut down to what the
structured hex8 path needs.  The point order is the reference's: the
first rule varies slowest (x-major), so tabulations match the JAX
package entry for entry.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["Rule", "gauss", "tensor_product", "hexahedron_gauss", "canonical_stiffness"]


class Rule(NamedTuple):
    """A quadrature rule ``(weights[q], points[q, d])`` on a reference domain."""

    weights: np.ndarray
    points: np.ndarray


def gauss(num_points: int) -> Rule:
    """Gauss-Legendre rule with ``n`` points on [-1, 1] (exact to degree 2n - 1)."""
    if num_points < 1:
        raise ValueError("number of points must be positive")
    x, w = np.polynomial.legendre.leggauss(int(num_points))
    return Rule(w, x.reshape(-1, 1))


def tensor_product(*rules: Rule) -> Rule:
    """Tensor product of 1D rules; the first rule varies slowest."""
    ws = [np.asarray(r.weights).reshape(-1) for r in rules]
    xs = [np.asarray(r.points).reshape(-1) for r in rules]
    grids = np.meshgrid(*xs, indexing="ij")
    wgrids = np.meshgrid(*ws, indexing="ij")
    points = np.stack([g.reshape(-1) for g in grids], axis=-1)
    weights = np.prod(np.stack([g.reshape(-1) for g in wgrids], axis=-1), axis=-1)
    return Rule(weights, points)


def hexahedron_gauss(num_points_per_dim: int) -> Rule:
    """Gauss rule on the reference hex [-1, 1]^3 (n points per dimension)."""
    g = gauss(num_points_per_dim)
    return tensor_product(g, g, g)


def canonical_stiffness(element_name: str) -> Rule:
    """Rule that integrates the element's stiffness matrix exactly."""
    if element_name != "hex8":
        raise NotImplementedError(f"the port supports hex8 only, not {element_name!r}")
    return hexahedron_gauss(2)
