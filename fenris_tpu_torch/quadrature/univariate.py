"""Univariate Gauss-Legendre and Gauss-Jacobi rules on [-1, 1].

Counterpart of ``fenris_tpu/quadrature/univariate.py``: numpy's
``leggauss`` for Gauss-Legendre, Golub-Welsch on the Jacobi recurrence
for Gauss-Jacobi (the collapsed simplex rules' weights).
"""

from __future__ import annotations

from functools import lru_cache
from math import lgamma

import numpy as np

__all__ = ["gauss", "gauss_jacobi"]


@lru_cache(maxsize=None)
def _gauss(n: int):
    x, w = np.polynomial.legendre.leggauss(n)
    return w, x.reshape(-1, 1)


def gauss(num_points: int):
    """Gauss-Legendre rule with ``n`` points (exact to degree ``2n - 1``)."""
    from . import Rule

    if num_points < 1:
        raise ValueError("number of points must be positive")
    w, p = _gauss(int(num_points))
    return Rule(w.copy(), p.copy())


@lru_cache(maxsize=None)
def _gauss_jacobi(n: int, a: float, b: float):
    apb = a + b
    # recurrence coefficients of the monic Jacobi polynomials; at k = 0 the diagonal's 0/0 for
    # a + b = 0 has the limit (b - a) / (a + b + 2)
    A = np.empty(n, dtype=np.float64)
    A[0] = (b - a) / (apb + 2.0)
    if n > 1:
        k = np.arange(1, n, dtype=np.float64)
        A[1:] = (b**2 - a**2) / ((2 * k + apb) * (2 * k + apb + 2))
    k1 = np.arange(1, n, dtype=np.float64)
    B = 4.0 * k1 * (k1 + a) * (k1 + b) * (k1 + apb) / (
        (2 * k1 + apb) ** 2 * (2 * k1 + apb + 1) * (2 * k1 + apb - 1)
    )
    J = np.diag(A) + np.diag(np.sqrt(B), 1) + np.diag(np.sqrt(B), -1)
    x, V = np.linalg.eigh(J)
    # the weight's integral 2^(a+b+1) B(a+1, b+1)
    mu0 = np.exp((apb + 1) * np.log(2.0) + lgamma(a + 1) + lgamma(b + 1) - lgamma(apb + 2))
    return mu0 * V[0, :] ** 2, x.reshape(-1, 1)


def gauss_jacobi(num_points: int, alpha: float, beta: float):
    """Gauss-Jacobi rule for the weight ``(1 - x)^alpha (1 + x)^beta`` on [-1, 1]."""
    from . import Rule

    if num_points < 1:
        raise ValueError("number of points must be positive")
    w, p = _gauss_jacobi(int(num_points), float(alpha), float(beta))
    return Rule(w.copy(), p.copy())
