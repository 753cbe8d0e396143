"""Collapsed-coordinate (Duffy / Gauss-Jacobi) rules on the reference triangle and tetrahedron.

Counterpart of ``triangle_collapsed`` and ``tetrahedron_collapsed`` in
``fenris_tpu/quadrature/simplex.py``: tensor products of Gauss-Legendre
and Gauss-Jacobi rules under the collapsed-coordinate maps, exact to any
total degree; the Jacobi weights absorb the collapse's Jacobian.
"""

from __future__ import annotations

import numpy as np

from .univariate import gauss, gauss_jacobi

__all__ = ["triangle_collapsed", "tetrahedron_collapsed"]


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
