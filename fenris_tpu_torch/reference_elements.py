"""Reference finite elements: nodes, Lagrange bases, topology (numpy, host side).

Counterpart of ``fenris_tpu/reference_elements.py``, with its reference
domains ([-1, 1]-based), node orders, polynomial spaces and subparametric
geometry: tet10/tet20 map through tet4, hex20/hex27 through hex8,
tri6 through tri3 and quad8/quad9 through quad4 (``geometry``).

Bases come from the generalized Vandermonde matrix of the element's
polynomial space at its nodes, inverted in exact rational arithmetic, as
in the JAX package, so coefficients are correctly rounded and tabulations
match it entry for entry.  HEX8 keeps the closed form
``phi_n = (1 + x_n x)(1 + y_n y)(1 + z_n z) / 8``, which agrees with the
Vandermonde basis to rounding (the structured stencils read its table).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from fractions import Fraction
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ReferenceElement",
    "element",
    "ELEMENTS",
    "SEG2",
    "SEG3",
    "TRI3",
    "TRI6",
    "QUAD4",
    "QUAD8",
    "QUAD9",
    "TET4",
    "TET10",
    "TET20",
    "HEX8",
    "HEX20",
    "HEX27",
]


# -- polynomial spaces (exponent tuples) -------------------------------------------------


def _sorted_space(exps) -> Tuple[Tuple[int, ...], ...]:
    """Exponent tuples in the JAX package's order: by total degree, then lexicographic."""
    return tuple(sorted(exps, key=lambda e: (sum(e), e)))


def _p_space(dim: int, degree: int) -> Tuple[Tuple[int, ...], ...]:
    """Total-degree (simplex) space P_k."""
    return _sorted_space(e for e in itertools.product(range(degree + 1), repeat=dim) if sum(e) <= degree)


def _q_space(dim: int, degree: int) -> Tuple[Tuple[int, ...], ...]:
    """Tensor (box) space Q_k."""
    return _sorted_space(itertools.product(range(degree + 1), repeat=dim))


_SERENDIPITY_QUAD8 = _sorted_space([(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (0, 2), (2, 1), (1, 2)])
# Q2 monomials with at most one exponent 2, plus x^2yz, xy^2z, xyz^2
_SERENDIPITY_HEX20 = _sorted_space(
    [
        (0, 0, 0),
        (1, 0, 0), (0, 1, 0), (0, 0, 1),
        (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1),
        (2, 0, 0), (0, 2, 0), (0, 0, 2),
        (2, 1, 0), (2, 0, 1), (1, 2, 0), (0, 2, 1), (1, 0, 2), (0, 1, 2),
        (2, 1, 1), (1, 2, 1), (1, 1, 2),
    ]
)


def _fprod(node: Sequence[Fraction], exp: Tuple[int, ...]) -> Fraction:
    out = Fraction(1)
    for x, e in zip(node, exp):
        out *= Fraction(x) ** e
    return out


def _lagrange_coeffs(nodes, exps) -> np.ndarray:
    """``C[k, j]`` with ``phi_j(x) = sum_k C[k, j] x**exps[k]``: ``V^-1`` by exact Gauss-Jordan."""
    n = len(nodes)
    if len(exps) != n:
        raise ValueError("the polynomial space's dimension must equal the node count")
    aug = [[_fprod(node, e) for e in exps] + [Fraction(int(i == j)) for j in range(n)] for i, node in enumerate(nodes)]
    for col in range(n):
        piv = max(range(col, n), key=lambda r: abs(aug[r][col]))
        if aug[piv][col] == 0:
            raise ValueError("singular Vandermonde: the nodes are not unisolvent")
        aug[col], aug[piv] = aug[piv], aug[col]
        inv = Fraction(1) / aug[col][col]
        aug[col] = [v * inv for v in aug[col]]
        for r in range(n):
            if r != col and aug[r][col] != 0:
                f = aug[r][col]
                aug[r] = [a - f * b for a, b in zip(aug[r], aug[col])]
    return np.array([[float(aug[i][n + j]) for j in range(n)] for i in range(n)])


# -- the element ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class ReferenceElement:
    """Static description of a reference finite element."""

    name: str
    domain: str  # 'segment' | 'tri' | 'quad' | 'tet' | 'hex'
    ref_dim: int
    nodes_rational: Tuple[Tuple[Fraction, ...], ...]
    exponents: Tuple[Tuple[int, ...], ...]
    num_vertices: int  # the leading corner vertices
    degree: int  # polynomial degree
    #: corner-vertex pairs of the edges and corner tuples of the faces (outward), in the JAX
    #: package's order (uniform refinement numbers its new vertices in that order)
    edges: Tuple[Tuple[int, int], ...] = ()
    faces: Tuple[Tuple[int, ...], ...] = ()
    geometry_name: Optional[str] = None  # the subparametric geometry element

    @property
    def num_nodes(self) -> int:
        return len(self.nodes_rational)

    @property
    def nodes(self) -> np.ndarray:
        """``[n, d]`` float64 reference node coordinates."""
        return _nodes_float(self.name)

    @property
    def coeffs(self) -> np.ndarray:
        """``C[k, j]`` with ``phi_j(x) = sum_k C[k, j] x**exponents[k]``."""
        return _coeffs(self.name)

    @property
    def geometry(self) -> "ReferenceElement":
        """Element of the geometry map (the lowest-order one; may be self)."""
        if self.geometry_name is None or self.geometry_name == self.name:
            return self
        return ELEMENTS[self.geometry_name]

    def monomials(self, points: np.ndarray) -> np.ndarray:
        """``m[q, k] = prod_d points[q, d] ** exponents[k, d]``."""
        pts = np.asarray(points, dtype=np.float64).reshape(-1, self.ref_dim)
        exps = np.asarray(self.exponents)
        return np.prod(pts[:, None, :] ** exps[None, :, :], axis=-1)

    def monomial_gradients(self, points: np.ndarray) -> np.ndarray:
        """``dm[q, k, d] = d/dx_d m_k(points[q])``."""
        pts = np.asarray(points, dtype=np.float64).reshape(-1, self.ref_dim)
        exps = np.asarray(self.exponents)
        out = np.empty((pts.shape[0], exps.shape[0], self.ref_dim))
        for ax in range(self.ref_dim):
            e = exps.copy()
            coef = e[:, ax].astype(np.float64)
            e[:, ax] = np.maximum(e[:, ax] - 1, 0)
            out[:, :, ax] = coef[None, :] * np.prod(pts[:, None, :] ** e[None, :, :], axis=-1)
        return out

    def tabulate(self, points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """``(phi[q, n], dphi[q, n, d])`` at ``points[q, d]``, float64."""
        if self.name == "hex8":
            return _tabulate_hex8(self.nodes, points)
        C = self.coeffs
        return self.monomials(points) @ C, np.einsum("qkd,kn->qnd", self.monomial_gradients(points), C)

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        return isinstance(other, ReferenceElement) and other.name == self.name


def _tabulate_hex8(nodes: np.ndarray, points: np.ndarray):
    """The trilinear basis in closed form."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    factors = 0.5 * (1.0 + pts[:, None, :] * nodes[None, :, :])  # [q, n, d], (1 + node_d x_d) / 2
    phi = np.prod(factors, axis=-1)
    dphi = np.empty(factors.shape)
    for ax in range(3):
        dphi[:, :, ax] = 0.5 * nodes[None, :, ax] * np.prod(np.delete(factors, ax, axis=-1), axis=-1)
    return phi, dphi


def _read_only(a: np.ndarray) -> np.ndarray:
    a.setflags(write=False)  # one cached array is handed to every caller
    return a


@lru_cache(maxsize=None)
def _nodes_float(name: str) -> np.ndarray:
    return _read_only(np.array([[float(x) for x in node] for node in ELEMENTS[name].nodes_rational]))


@lru_cache(maxsize=None)
def _coeffs(name: str) -> np.ndarray:
    el = ELEMENTS[name]
    return _read_only(_lagrange_coeffs(el.nodes_rational, el.exponents))


# -- concrete elements (JAX package's node orders) ------------------------------------------

F = Fraction
ELEMENTS: dict = {}


def _fr(*vals) -> Tuple[Fraction, ...]:
    return tuple(F(v) for v in vals)


def _register(el: ReferenceElement) -> ReferenceElement:
    ELEMENTS[el.name] = el
    return el


def _mid(a, b):
    return tuple((x + y) / 2 for x, y in zip(a, b))


def _third(a, b, t):
    """``a + t (b - a)``, t rational."""
    return tuple(x + t * (y - x) for x, y in zip(a, b))


def _centroid(*pts):
    return tuple(sum(c) / len(pts) for c in zip(*pts))


SEG2 = _register(ReferenceElement("seg2", "segment", 1, (_fr(-1), _fr(1)), _p_space(1, 1), 2, 1))
# corners first, the midpoint last
SEG3 = _register(ReferenceElement("seg3", "segment", 1, (_fr(-1), _fr(1), _fr(0)), _p_space(1, 2), 2, 2))

_TRI_EDGES = ((0, 1), (1, 2), (2, 0))
TRI3 = _register(
    ReferenceElement("tri3", "tri", 2, (_fr(-1, -1), _fr(1, -1), _fr(-1, 1)), _p_space(2, 1), 3, 1, edges=_TRI_EDGES)
)
# corners, then the midpoints of edges 01, 12, 20
TRI6 = _register(
    ReferenceElement(
        "tri6", "tri", 2,
        (_fr(-1, -1), _fr(1, -1), _fr(-1, 1), _fr(0, -1), _fr(0, 0), _fr(-1, 0)),
        _p_space(2, 2), 3, 2, edges=_TRI_EDGES, geometry_name="tri3",
    )
)

_QUAD_EDGES = ((0, 1), (1, 2), (2, 3), (3, 0))
_quad_v = (_fr(-1, -1), _fr(1, -1), _fr(1, 1), _fr(-1, 1))
_quad_mids = (_fr(0, -1), _fr(1, 0), _fr(0, 1), _fr(-1, 0))  # edges 01, 12, 23, 30
QUAD4 = _register(ReferenceElement("quad4", "quad", 2, _quad_v, _q_space(2, 1), 4, 1, edges=_QUAD_EDGES))
QUAD8 = _register(
    ReferenceElement("quad8", "quad", 2, _quad_v + _quad_mids, _SERENDIPITY_QUAD8, 4, 2, edges=_QUAD_EDGES,
                     geometry_name="quad4")
)
QUAD9 = _register(
    ReferenceElement("quad9", "quad", 2, _quad_v + _quad_mids + (_fr(0, 0),), _q_space(2, 2), 4, 2,
                     edges=_QUAD_EDGES, geometry_name="quad4")
)

_TET_FACES = ((0, 2, 1), (0, 1, 3), (1, 2, 3), (0, 3, 2))
_TET_EDGES = ((0, 1), (1, 2), (0, 2), (0, 3), (2, 3), (1, 3))
_tet_v = (_fr(-1, -1, -1), _fr(1, -1, -1), _fr(-1, 1, -1), _fr(-1, -1, 1))
TET4 = _register(
    ReferenceElement("tet4", "tet", 3, _tet_v, _p_space(3, 1), 4, 1, edges=_TET_EDGES, faces=_TET_FACES)
)
# corners, then the midpoints of edges 01, 12, 02, 03, 23, 13
TET10 = _register(
    ReferenceElement(
        "tet10", "tet", 3, _tet_v + tuple(_mid(_tet_v[a], _tet_v[b]) for a, b in _TET_EDGES),
        _p_space(3, 2), 4, 2, edges=_TET_EDGES, faces=_TET_FACES, geometry_name="tet4",
    )
)
# corners, two points an edge (1/3 then 2/3 from the first vertex) in edge order 01 02 03 12 13 23,
# then the centroids of faces 012, 013, 023, 123
_TET20_EDGE_ORDER = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
_TET20_FACES = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))
TET20 = _register(
    ReferenceElement(
        "tet20", "tet", 3,
        _tet_v
        + tuple(_third(_tet_v[a], _tet_v[b], t) for a, b in _TET20_EDGE_ORDER for t in (F(1, 3), F(2, 3)))
        + tuple(_centroid(*(_tet_v[i] for i in f)) for f in _TET20_FACES),
        _p_space(3, 3), 4, 3, edges=_TET_EDGES, faces=_TET_FACES, geometry_name="tet4",
    )
)

_HEX_FACES = ((3, 2, 1, 0), (0, 1, 5, 4), (1, 2, 6, 5), (2, 3, 7, 6), (4, 7, 3, 0), (5, 6, 7, 4))
_HEX_EDGES = ((0, 1), (0, 3), (0, 4), (1, 2), (1, 5), (2, 3), (2, 6), (3, 7), (4, 5), (4, 7), (5, 6), (6, 7))
_hex_v = (
    _fr(-1, -1, -1), _fr(1, -1, -1), _fr(1, 1, -1), _fr(-1, 1, -1),
    _fr(-1, -1, 1), _fr(1, -1, 1), _fr(1, 1, 1), _fr(-1, 1, 1),
)
_hex_edge_mids = tuple(_mid(_hex_v[a], _hex_v[b]) for a, b in _HEX_EDGES)
# face centres z-, y-, x-, x+, y+, z+
_hex_face_centers = (_fr(0, 0, -1), _fr(0, -1, 0), _fr(-1, 0, 0), _fr(1, 0, 0), _fr(0, 1, 0), _fr(0, 0, 1))
HEX8 = _register(
    ReferenceElement("hex8", "hex", 3, _hex_v, _q_space(3, 1), 8, 1, edges=_HEX_EDGES, faces=_HEX_FACES)
)
HEX20 = _register(
    ReferenceElement("hex20", "hex", 3, _hex_v + _hex_edge_mids, _SERENDIPITY_HEX20, 8, 2, edges=_HEX_EDGES,
                     faces=_HEX_FACES, geometry_name="hex8")
)
HEX27 = _register(
    ReferenceElement("hex27", "hex", 3, _hex_v + _hex_edge_mids + _hex_face_centers + (_fr(0, 0, 0),),
                     _q_space(3, 2), 8, 2, edges=_HEX_EDGES, faces=_HEX_FACES, geometry_name="hex8")
)


def element(name: str) -> ReferenceElement:
    """The element type of that name (e.g. ``"tet10"``)."""
    try:
        return ELEMENTS[name]
    except KeyError:
        raise KeyError(f"unknown element type {name!r}; available: {sorted(ELEMENTS)}") from None
