"""The hex8 reference element (numpy, host side).

Counterpart of ``HEX8`` in ``fenris_tpu/reference_elements.py``: the
trilinear Lagrange basis on [-1, 1]^3 with the reference's corner order
(counter-clockwise on the z = -1 face, then on the z = +1 face).  The
JAX package derives the basis from a monomial Vandermonde solve; here the
closed form ``phi_n = (1 + x_n x)(1 + y_n y)(1 + z_n z) / 8`` is used,
which agrees with it to rounding.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

__all__ = ["ReferenceElement", "HEX8"]


@dataclass(frozen=True)
class ReferenceElement:
    """A reference element with closed-form basis tabulation."""

    name: str
    ref_dim: int
    nodes: np.ndarray  # [n, d]
    #: vertex pairs of the element's edges and vertex tuples of its faces,
    #: in the JAX package's order (uniform refinement numbers its new
    #: vertices in that order)
    edges: Tuple[Tuple[int, int], ...] = ()
    faces: Tuple[Tuple[int, ...], ...] = ()

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def geometry(self) -> "ReferenceElement":
        """Element of the geometry map: the port's elements are isoparametric."""
        return self

    def tabulate(self, points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """``(phi[q, n], dphi[q, n, d])`` at ``points[q, d]``, float64."""
        pts = np.asarray(points, dtype=np.float64).reshape(-1, self.ref_dim)
        # factors[q, n, d] = (1 + node_d x_d) / 2 per axis
        factors = 0.5 * (1.0 + pts[:, None, :] * self.nodes[None, :, :])
        phi = np.prod(factors, axis=-1)
        dphi = np.empty(factors.shape)
        for ax in range(self.ref_dim):
            others = np.prod(np.delete(factors, ax, axis=-1), axis=-1)
            dphi[:, :, ax] = 0.5 * self.nodes[None, :, ax] * others
        return phi, dphi


_HEX_FACES = (
    (3, 2, 1, 0),
    (0, 1, 5, 4),
    (1, 2, 6, 5),
    (2, 3, 7, 6),
    (4, 7, 3, 0),
    (5, 6, 7, 4),
)
_HEX_EDGES = (
    (0, 1),
    (0, 3),
    (0, 4),
    (1, 2),
    (1, 5),
    (2, 3),
    (2, 6),
    (3, 7),
    (4, 5),
    (4, 7),
    (5, 6),
    (6, 7),
)

HEX8 = ReferenceElement(
    name="hex8",
    ref_dim=3,
    nodes=np.array(
        [
            [-1, -1, -1],
            [1, -1, -1],
            [1, 1, -1],
            [-1, 1, -1],
            [-1, -1, 1],
            [1, -1, 1],
            [1, 1, 1],
            [-1, 1, 1],
        ],
        dtype=np.float64,
    ),
    edges=_HEX_EDGES,
    faces=_HEX_FACES,
)
