"""Composite quadrature rules by subdividing the reference domain.

Counterpart of ``fenris_tpu/quadrature/subdivide.py`` (src/quadrature/subdivide.rs:
``subdivide_univariate`` :18, ``subdivide_triangle`` :74), for integrands
with kinks inside an element.
"""

from __future__ import annotations

import numpy as np

__all__ = ["subdivide_univariate", "subdivide_triangle"]


def subdivide_univariate(rule, pieces: int):
    """``rule`` applied in each of ``pieces`` equal subintervals of [-1, 1]."""
    from . import Rule

    if pieces < 1:
        raise ValueError("number of pieces must be >= 1")
    w0 = np.asarray(rule.weights)
    x0 = np.asarray(rule.points).reshape(-1)
    size = 2.0 / pieces
    a = np.arange(pieces)[:, None] * size - 1.0  # [pieces, 1] left ends
    points = ((size * x0)[None, :] + (2.0 * a + size)) / 2.0
    return Rule(np.tile(w0 * (size / 2.0), pieces), points.reshape(-1, 1))


def _triangle_image(p0: np.ndarray, v0, v1, v2):
    """Weight factor |det J| and points of the affine map of the reference triangle (-1,-1), (1,-1),
    (-1,1) onto (v0, v1, v2)."""
    v0, v1, v2 = (np.asarray(v) for v in (v0, v1, v2))
    phi0 = -0.5 * p0[:, 0] - 0.5 * p0[:, 1]
    phi1 = 0.5 * p0[:, 0] + 0.5
    phi2 = 0.5 * p0[:, 1] + 0.5
    x = np.outer(phi0, v0) + np.outer(phi1, v1) + np.outer(phi2, v2)
    return abs(np.linalg.det(np.stack([(v1 - v0) / 2.0, (v2 - v0) / 2.0], axis=-1))), x


def subdivide_triangle(rule, subdivisions: int):
    """Composite rule on the reference triangle by a regular grid subdivision.

    The square [-1, 1]^2 is cut into ``subdivisions^2`` cells; of the cells
    in the lower-left triangle, the diagonal ones keep their lower triangle
    and the others split into two, each carrying the mapped base rule.
    """
    from . import Rule

    if subdivisions < 1:
        raise ValueError("number of subdivisions must be >= 1")
    w0 = np.asarray(rule.weights)
    p0 = np.asarray(rule.points).reshape(-1, 2)
    cell = 2.0 / subdivisions
    weights, points = [], []
    for i in range(subdivisions):
        for j in range(i + 1):
            cx, cy = -1.0 + cell * (j + 0.5), 1.0 - cell * (i + 0.5)
            c00, c10 = (cx - cell / 2, cy - cell / 2), (cx + cell / 2, cy - cell / 2)
            c11, c01 = (cx + cell / 2, cy + cell / 2), (cx - cell / 2, cy + cell / 2)
            for verts in [(c00, c10, c01)] + ([(c10, c11, c01)] if i != j else []):
                det, x = _triangle_image(p0, *verts)
                weights.append(w0 * det)
                points.append(x)
    return Rule(np.concatenate(weights), np.concatenate(points))
