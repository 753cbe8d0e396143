"""Host-side basis tabulation for one (element, quadrature rule) pair.

Counterpart of ``Tabulation``/``tabulate`` in
``fenris_tpu/assembly/local.py``.  The batched element assemblers of
that module belong to the assembled path and are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..quadrature import Rule
from ..reference_elements import ReferenceElement

__all__ = ["Tabulation", "tabulate"]


@dataclass(frozen=True)
class Tabulation:
    """Basis values and reference gradients at a rule's points (float64 numpy)."""

    element: ReferenceElement
    weights: np.ndarray  # [q]
    points: np.ndarray  # [q, d]
    phi: np.ndarray  # [q, n]
    dphi: np.ndarray  # [q, n, d]


def tabulate(element: ReferenceElement, rule: Rule) -> Tabulation:
    """Tabulate ``element``'s basis at ``rule``'s points."""
    w = np.asarray(rule.weights, dtype=np.float64)
    pts = np.asarray(rule.points, dtype=np.float64).reshape(len(w), element.ref_dim)
    phi, dphi = element.tabulate(pts)
    return Tabulation(element, w, pts, phi, dphi)
