"""Collapsed-coordinate (Duffy / Gauss-Jacobi) rules on the reference triangle, tetrahedron, prism and pyramid.

Counterpart of ``fenris_tpu/quadrature/simplex.py``: tensor products of
Gauss-Legendre and Gauss-Jacobi rules under the collapsed-coordinate
maps, exact to any total degree; the Jacobi weights absorb the
collapse's Jacobian.
"""

from __future__ import annotations

import numpy as np

from .univariate import gauss, gauss_jacobi

__all__ = ["triangle_collapsed", "tetrahedron_collapsed", "prism_collapsed", "pyramid_collapsed"]


def _npts(strength: int) -> int:
    return max(1, (int(strength) + 2) // 2)  # ceil((p + 1) / 2)


def triangle_collapsed(strength: int):
    """Rule on the triangle (-1,-1), (1,-1), (-1,1), exact to total degree ``strength``."""
    from . import Rule

    n = _npts(strength)
    wa, pa = gauss(n)
    wb, pb = gauss_jacobi(n, 1.0, 0.0)
    a, b = pa[:, 0][:, None], pb[:, 0][None, :]
    x = (1.0 + a) * (1.0 - b) / 2.0 - 1.0
    y = np.broadcast_to(b, x.shape)
    w = (wa[:, None] * wb[None, :]) / 2.0  # dx dy = ((1 - b) / 2) da db
    return Rule(w.reshape(-1), np.stack([x.reshape(-1), y.reshape(-1)], axis=-1))


def tetrahedron_collapsed(strength: int):
    """Rule on the reference tetrahedron, exact to total degree ``strength``."""
    from . import Rule

    n = _npts(strength)
    wa, pa = gauss(n)
    wb, pb = gauss_jacobi(n, 1.0, 0.0)
    wc, pc = gauss_jacobi(n, 2.0, 0.0)
    a, b, c = pa[:, 0][:, None, None], pb[:, 0][None, :, None], pc[:, 0][None, None, :]
    x = (1.0 + a) * (1.0 - b) * (1.0 - c) / 4.0 - 1.0
    y = np.broadcast_to((1.0 + b) * (1.0 - c) / 2.0 - 1.0, x.shape)
    z = np.broadcast_to(c, x.shape)
    # dx dy dz = ((1 - b) / 2) ((1 - c) / 2)^2 da db dc
    w = wa[:, None, None] * wb[None, :, None] * wc[None, None, :] / 8.0
    return Rule(w.reshape(-1), np.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], axis=-1))


def prism_collapsed(strength: int):
    """Rule on the reference prism (triangle x segment), exact to total degree ``strength``."""
    from . import Rule

    tri = triangle_collapsed(strength)
    n = _npts(strength)
    wz, pz = gauss(n)
    w = (tri.weights[:, None] * wz[None, :]).reshape(-1)
    xy = np.repeat(tri.points, n, axis=0)
    z = np.tile(pz[:, 0], tri.num_points)
    return Rule(w, np.concatenate([xy, z[:, None]], axis=-1))


def pyramid_collapsed(strength: int):
    """Rule on the reference pyramid (base [-1, 1]^2 at z = -1, apex (0, 0, 1))."""
    from . import Rule

    n = _npts(strength)
    wa, pa = gauss(n)
    wc, pc = gauss_jacobi(n, 2.0, 0.0)
    a, b, c = pa[:, 0][:, None, None], pa[:, 0][None, :, None], pc[:, 0][None, None, :]
    s = (1.0 - c) / 2.0  # the cross-section's scale: 1 at z = -1, 0 at the apex
    x = np.broadcast_to(a * s, (n, n, n))
    y = np.broadcast_to(b * s, (n, n, n))
    z = np.broadcast_to(c, (n, n, n))
    # dx dy dz = s^2 da db dc, absorbed by the Gauss-Jacobi (2, 0) weights
    w = wa[:, None, None] * wa[None, :, None] * wc[None, None, :] / 4.0
    return Rule(w.reshape(-1), np.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], axis=-1))
