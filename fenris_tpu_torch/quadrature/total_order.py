"""Total-order rules per reference domain.

Counterpart of ``fenris_tpu/quadrature/total_order.py``: the minimum-point
Witherden–Vincent rule of at least the requested strength, and beyond the
tables the collapsed simplex rules (triangle, tetrahedron) or tensor Gauss
(quad, hex), as the JAX package falls back.
"""

from __future__ import annotations

from . import polyquad, simplex
from .tensor import hexahedron_gauss, quadrilateral_gauss

__all__ = ["triangle", "quadrilateral", "tetrahedron", "hexahedron"]


def triangle(strength: int):
    try:
        return polyquad.rule("tri", strength)
    except polyquad.NoRuleAvailable:
        return simplex.triangle_collapsed(strength)


def quadrilateral(strength: int):
    try:
        return polyquad.rule("quad", strength)
    except polyquad.NoRuleAvailable:
        return quadrilateral_gauss(max(1, (strength + 2) // 2))


def tetrahedron(strength: int):
    try:
        return polyquad.rule("tet", strength)
    except polyquad.NoRuleAvailable:
        return simplex.tetrahedron_collapsed(strength)


def hexahedron(strength: int):
    try:
        return polyquad.rule("hex", strength)
    except polyquad.NoRuleAvailable:
        return hexahedron_gauss(max(1, (strength + 2) // 2))
