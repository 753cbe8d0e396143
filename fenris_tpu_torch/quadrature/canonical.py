"""Canonical per-element rules: exact for the element's mass and stiffness matrices.

Counterpart of ``fenris_tpu/quadrature/canonical.py`` (canonical.rs:86-120):
the same rule, point order included, for every element type.
"""

from __future__ import annotations

from . import total_order
from .tensor import hexahedron_gauss, quadrilateral_gauss
from .univariate import gauss

__all__ = ["canonical_mass", "canonical_stiffness"]

# (mass rule, stiffness rule) per element type
_CANONICAL = {
    "seg2": (lambda: gauss(2), lambda: gauss(1)),
    "seg3": (lambda: gauss(3), lambda: gauss(2)),
    "tri3": (lambda: total_order.triangle(2), lambda: total_order.triangle(1)),
    "tri6": (lambda: total_order.triangle(4), lambda: total_order.triangle(2)),
    "quad4": (lambda: quadrilateral_gauss(2), lambda: quadrilateral_gauss(2)),
    "quad8": (lambda: quadrilateral_gauss(3), lambda: quadrilateral_gauss(3)),
    "quad9": (lambda: quadrilateral_gauss(3), lambda: quadrilateral_gauss(3)),
    "tet4": (lambda: total_order.tetrahedron(2), lambda: total_order.tetrahedron(1)),
    "tet10": (lambda: total_order.tetrahedron(4), lambda: total_order.tetrahedron(2)),
    "tet20": (lambda: total_order.tetrahedron(6), lambda: total_order.tetrahedron(4)),
    "hex8": (lambda: hexahedron_gauss(2), lambda: hexahedron_gauss(2)),
    "hex20": (lambda: hexahedron_gauss(3), lambda: hexahedron_gauss(3)),
    "hex27": (lambda: hexahedron_gauss(3), lambda: hexahedron_gauss(3)),
}


def _name(element) -> str:
    return element if isinstance(element, str) else element.name


def canonical_mass(element):
    """The rule that integrates the element's mass matrix exactly."""
    return _CANONICAL[_name(element)][0]()


def canonical_stiffness(element):
    """The rule that integrates the element's stiffness matrix exactly."""
    return _CANONICAL[_name(element)][1]()
