"""Tensor-product Gauss rules for quads and hexes.

Counterpart of ``fenris_tpu/quadrature/tensor.py``: the first rule varies
slowest (x-major), the JAX package's point order.
"""

from __future__ import annotations

import numpy as np

from .univariate import gauss

__all__ = ["tensor_product", "quadrilateral_gauss", "hexahedron_gauss"]


def tensor_product(*rules):
    """Tensor product of 1D rules; the first rule varies slowest."""
    from . import Rule

    ws = [np.asarray(r.weights).reshape(-1) for r in rules]
    xs = [np.asarray(r.points).reshape(-1) for r in rules]
    grids = np.meshgrid(*xs, indexing="ij")
    wgrids = np.meshgrid(*ws, indexing="ij")
    points = np.stack([g.reshape(-1) for g in grids], axis=-1)
    weights = np.prod(np.stack([g.reshape(-1) for g in wgrids], axis=-1), axis=-1)
    return Rule(weights, points)


def quadrilateral_gauss(num_points_per_dim: int):
    """Gauss rule on the reference quad [-1, 1]^2 (n points per dimension)."""
    g = gauss(num_points_per_dim)
    return tensor_product(g, g)


def hexahedron_gauss(num_points_per_dim: int):
    """Gauss rule on the reference hex [-1, 1]^3 (n points per dimension)."""
    g = gauss(num_points_per_dim)
    return tensor_product(g, g, g)
