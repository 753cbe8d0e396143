"""Total-order rules per reference domain.

Counterpart of ``fenris_tpu/quadrature/total_order.py``: the minimum-point
Witherden–Vincent rule of at least the requested strength, and beyond the
tables the collapsed rules (triangle, tetrahedron, prism, pyramid) or
tensor Gauss (quad, hex), as the JAX package falls back; ``for_domain``
picks the constructor by domain name.
"""

from __future__ import annotations

from . import polyquad, simplex
from .tensor import hexahedron_gauss, quadrilateral_gauss

__all__ = ["triangle", "quadrilateral", "tetrahedron", "hexahedron", "prism", "pyramid", "for_domain"]


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


def prism(strength: int):
    try:
        return polyquad.rule("pri", strength)
    except polyquad.NoRuleAvailable:
        return simplex.prism_collapsed(strength)


def pyramid(strength: int):
    try:
        return polyquad.rule("pyr", strength)
    except polyquad.NoRuleAvailable:
        return simplex.pyramid_collapsed(strength)


def for_domain(domain: str, strength: int):
    """Total-order rule for a named reference domain (``segment``: Gauss with ``ceil((strength + 1) / 2)`` points)."""
    table = {"tri": triangle, "quad": quadrilateral, "tet": tetrahedron, "hex": hexahedron,
             "pri": prism, "prism": prism, "pyr": pyramid, "pyramid": pyramid}
    if domain == "segment":
        from .univariate import gauss

        return gauss(max(1, (strength + 2) // 2))
    return table[domain](strength)
