"""Finite element spaces: point location, inverse mapping, interpolation.

Counterpart of ``fenris_tpu/space.py`` (src/space/* and src/element.rs):

* :func:`map_physical_coordinates` (element.rs:303) and
  :func:`project_physical_coordinates` (element.rs:396): a fixed 24
  Newton / Gauss-Newton steps on the geometry map with the closed-form
  small inverse (:func:`~.assembly.local.inv_and_det`);
* :func:`closest_point_in_element`: the interior Newton point, every
  vertex and a Gauss-Newton solve on every boundary face and edge chart
  of the reference domain, the feasible candidate of least physical
  distance winning; ``charts=False`` is the cheap pre-pass;
* :class:`GridIndex`: the JAX package's replacement of the reference's
  R*-tree, a padded ``[cells, K]`` table of the elements whose inflated
  AABB touches each grid cell, built on the host with numpy (the same
  arrays, bitwise), with empty cells filled from their nearest non-empty
  cell;
* :func:`find_closest_element`: candidates by AABB distance (the grid's
  3^d ring, or every element), the closest-point query on the best k of
  them, and the certification of each answer: a query whose distance
  exceeds the ring's guarantee radius or the first dropped candidate's
  AABB distance is re-run with more candidates;
* :func:`interpolate_at_points`, :func:`interpolate_gradient_at_points`
  (interpolate.rs:161, :214) and :class:`FixedInterpolator`
  (fixed_interpolator.rs:13).

Everything runs in the points' dtype on their device (the card unless
the caller passes ``device="cpu"``).  Differences from the JAX package:
inputs are always concrete, so only its concrete branch exists (the
pre-pass, the certification and the re-run); queries run in chunks of
``chunk_size`` points, which bounds the card's memory (the ring gather
is ``[Q, 3^d K]``, the brute-force candidates ``[Q, E]``) and does not
change any result; and candidates of equal AABB distance are ranked by a
stable sort, which keeps the lower position first as ``jax.lax.top_k``
does.  The brute-force candidates are found without materialising every
``[Q, E, d]`` box difference: a point's distance to an element's AABB
lies between its distance to the box centre less the box's half
diagonal and that distance itself, so only the elements whose lower
bound does not exceed the (k+1)-th smallest upper bound can be among the
k+1 nearest, and only their AABB distances are computed.  The top k+1 are
the JAX package's.  The closest-point queries skip the candidates that
cannot win (:func:`_select_among_candidates`), which JAX computes and
discards.

``location_counts["charted"]`` counts the queries that the pre-pass left
to the chart pass, ``location_counts["reruns"]`` the queries that a
certification sent to a re-run (callers reset them).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from .assembly.local import inv_and_det
from .config import resolve_device
from .mesh import Mesh
from .reference_elements import ReferenceElement

__all__ = [
    "map_physical_coordinates",
    "project_physical_coordinates",
    "project_reference_domain",
    "closest_point_in_element",
    "reference_domain_distance",
    "find_closest_element",
    "interpolate_at_points",
    "interpolate_gradient_at_points",
    "ClosestElementResult",
    "FixedInterpolator",
    "GridIndex",
    "location_counts",
]

#: entries of one ``[chunk, width]`` candidate array: a ring gather, or (``BRUTE_ENTRIES``) the distances to
#: every element's box centre
CHUNK_ENTRIES = 1 << 24
BRUTE_ENTRIES = 1 << 27
#: (point, candidate) pairs of one batch of closest-point queries, and the candidate columns taken first
SELECT_PAIRS = 1 << 22
FIRST_BLOCK = 8
#: elements a block whose least centre distance bounds the brute force's threshold
BRUTE_BLOCK = 8


def _map(phi, X):
    """``x[b, i] = Σ_m phi[b, m] X[b, m, i]``."""
    return (phi[:, None, :] @ X)[:, 0]


def _jac(X, dphi):
    """``J[b, i, j] = Σ_m X[b, m, i] dphi[b, m, j]``."""
    return X.transpose(1, 2) @ dphi


def _matvec(A, v):
    """``y[b, i] = Σ_j A[b, i, j] v[b, j]``."""
    return (A @ v[:, :, None])[:, :, 0]


def _newton(el: ReferenceElement, X_geo, x, s0, num_iterations: int, normal: bool, c=None, Bm=None):
    """``num_iterations`` steps on ``T(c + Bm s) = x`` from ``s0`` (``c``, ``Bm`` None: ``ξ = s``): Newton
    ``s -= J⁻¹ r``, or with ``normal`` Gauss-Newton ``s -= (JᵀJ)⁻¹ Jᵀ r``.  An affine geometry's Jacobian is
    the same at every point, so it and its inverse are formed once (the values are those of forming them
    every step)."""
    geo = el.geometry
    s = s0
    inv = None
    for _ in range(num_iterations):
        xi = s if Bm is None else c + s @ Bm.T
        if inv is None or not geo.is_affine:
            J = _jac(X_geo, geo.dphi(xi))
            if Bm is not None:
                J = J @ Bm
            Jt = J.transpose(1, 2)
            inv, _ = inv_and_det(Jt @ J if normal else J)
        r = _map(geo.phi(xi), X_geo) - x
        s = s - _matvec(inv, _matvec(Jt, r) if normal else r)
    return s


def map_physical_coordinates(el: ReferenceElement, X_geo: torch.Tensor, x: torch.Tensor, num_iterations: int = 24):
    """Newton-invert the geometry map for a batch of (element, point) pairs.

    ``X_geo [B, m, d]`` per-query geometry nodes, ``x [B, d]`` physical
    points -> ``xi [B, d]``.  A fixed step count, as in the JAX package
    (affine geometry converges in one step).
    """
    return _newton(el, X_geo, x, torch.zeros(x.shape, dtype=X_geo.dtype, device=X_geo.device), num_iterations, False)


def _domain_distance(domain: str, xi: torch.Tensor) -> torch.Tensor:
    if domain in ("segment", "quad", "hex"):
        return (xi.abs().amax(-1) - 1.0).clamp_min(0.0)
    if domain in ("tri", "tet"):
        bound = 2.0 - xi.shape[-1]  # x + y (+ z) <= 2 - d
        return torch.maximum((-1.0 - xi).amax(-1), xi.sum(-1) - bound).clamp_min(0.0)
    raise ValueError(f"unknown domain {domain}")


def reference_domain_distance(el: ReferenceElement, xi: torch.Tensor) -> torch.Tensor:
    """How far outside the reference domain ``xi`` lies: the largest violation of its inequalities (0 inside)."""
    return _domain_distance(el.domain, xi)


def project_reference_domain(el: ReferenceElement, xi: torch.Tensor) -> torch.Tensor:
    """Euclidean projection of ``xi`` onto the reference domain.

    Boxes clip coordinatewise; simplices map affinely to ``{y >= 0, Σy <=
    1}`` and take the sort-based projection onto it.
    """
    if el.domain in ("segment", "quad", "hex"):
        return xi.clamp(-1.0, 1.0)
    if el.domain in ("tri", "tet"):
        d = xi.shape[-1]
        y = (xi + 1.0) / 2.0
        z = y.clamp_min(0.0)
        free_ok = z.sum(-1) <= 1.0
        u = torch.sort(y, dim=-1, descending=True).values
        css = torch.cumsum(u, dim=-1) - 1.0
        j = torch.arange(1, d + 1, dtype=xi.dtype, device=xi.device)
        rho = (u - css / j > 0).sum(-1).clamp_min(1)
        tau = torch.gather(css, -1, (rho - 1)[..., None])[..., 0] / rho.to(xi.dtype)
        w = (y - tau[..., None]).clamp_min(0.0)
        return 2.0 * torch.where(free_ok[..., None], z, w) - 1.0
    raise ValueError(f"unknown domain {el.domain}")


def project_physical_coordinates(el: ReferenceElement, X_geo: torch.Tensor, x: torch.Tensor,
                                 num_iterations: int = 24):
    """Unconstrained Gauss-Newton projection (element.rs:396): ``JᵀJ dξ = Jᵀ r``, also for surface elements."""
    xi0 = torch.zeros((x.shape[0], el.ref_dim), dtype=X_geo.dtype, device=X_geo.device)
    return _newton(el, X_geo, x, xi0, num_iterations, True)


def _domain_vertices(domain: str) -> np.ndarray:
    if domain == "segment":
        return np.array([[-1.0], [1.0]])
    if domain == "quad":
        return np.array([[-1.0, -1], [1, -1], [1, 1], [-1, 1]])
    if domain == "hex":
        return np.asarray([[x, y, z] for z in (-1.0, 1.0) for y in (-1.0, 1.0) for x in (-1.0, 1.0)])
    if domain == "tri":
        return np.array([[-1.0, -1], [1, -1], [-1, 1]])
    if domain == "tet":
        return np.array([[-1.0, -1, -1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]])
    raise ValueError(domain)


def _domain_faces(domain: str):
    """The reference domain's vertices ``[nv, d]`` and its proper faces and edges as affine charts.

    A chart ``(c [d], B [d, k], subdomain)`` parametrises a k-face as
    ``ξ(s) = c + B s`` with ``s`` in ``subdomain``'s reference domain
    (the face recursion of triangle.rs:450 and tetrahedron.rs:616).
    """
    V = _domain_vertices(domain)
    charts = []

    def edge(i, j):
        charts.append(((V[i] + V[j]) / 2.0, ((V[j] - V[i]) / 2.0)[:, None], "segment"))

    def tri_face(i, j, k):
        # s = (-1, -1) -> V_i, (1, -1) -> V_j, (-1, 1) -> V_k
        b0, b1 = (V[j] - V[i]) / 2.0, (V[k] - V[i]) / 2.0
        charts.append((V[i] + b0 + b1, np.stack([b0, b1], axis=1), "tri"))

    def quad_face(i, j, k, l):
        c = (V[i] + V[j] + V[k] + V[l]) / 4.0
        charts.append((c, np.stack([(V[j] - V[i]) / 2.0, (V[l] - V[i]) / 2.0], axis=1), "quad"))

    if domain == "quad":
        for i, j in ((0, 1), (1, 2), (2, 3), (3, 0)):
            edge(i, j)
    elif domain == "tri":
        for i, j in ((0, 1), (1, 2), (2, 0)):
            edge(i, j)
    elif domain == "tet":
        for i, j in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)):
            edge(i, j)
        for f in ((0, 2, 1), (0, 1, 3), (1, 2, 3), (0, 3, 2)):
            tri_face(*f)
    elif domain == "hex":
        # vertex order: x fastest, then y, then z; edges along x, y, z; faces z = -1, +1, y = -1, +1, x = -1, +1
        for i, j in ((0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7), (0, 4), (1, 5), (2, 6), (3, 7)):
            edge(i, j)
        for f in ((0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4), (2, 3, 7, 6), (0, 2, 6, 4), (1, 3, 7, 5)):
            quad_face(*f)
    elif domain != "segment":
        raise ValueError(domain)
    return V, charts


_CHART_CACHE: dict = {}


def _device_charts(domain: str, dtype, device):
    """The vertices and charts as tensors of ``dtype`` on ``device``, uploaded once."""
    key = (domain, dtype, device)
    if key not in _CHART_CACHE:
        V, charts = _domain_faces(domain)
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
        _CHART_CACHE[key] = ([as_t(v) for v in V], [(as_t(c), as_t(B), sub) for c, B, sub in charts])
    return _CHART_CACHE[key]


def closest_point_in_element(el: ReferenceElement, X_geo: torch.Tensor, x: torch.Tensor, num_iterations: int = 24,
                             tol: float = 1e-10, charts: bool = True):
    """The closest point of each element to its query (``ClosestPointInElement``, element.rs:462).

    Returns ``(xi, inside, distance)``: reference coordinates of the
    closest point (the inverse-mapped point when the query is inside),
    insideness (domain violation <= ``tol``) and ``||T(xi) - x||``.
    Candidates: the interior Newton point, every vertex and the
    Gauss-Newton point of every face and edge chart that lies in its
    chart's domain; the one of least distance wins (the first on ties).
    ``charts=False`` answers inside queries only: the others get ``inf``.
    """
    B_ = x.shape[0]
    xi_n = map_physical_coordinates(el, X_geo, x, num_iterations)
    inside = reference_domain_distance(el, xi_n) <= tol
    interior = torch.where(inside, 0.0, torch.inf).to(X_geo.dtype)
    if not charts:
        return xi_n, inside, interior

    def phys_dist(xi):
        return torch.linalg.vector_norm(_map(el.geometry.phi(xi), X_geo) - x, dim=-1)

    cand_xi, cand_dist = [xi_n], [interior]
    verts, chart_list = _device_charts(el.domain, X_geo.dtype, X_geo.device)
    for v in verts:
        xi_v = v.expand(B_, v.shape[0])
        cand_xi.append(xi_v)
        cand_dist.append(phys_dist(xi_v))
    for c, Bm, subdomain in chart_list:
        s0 = torch.zeros((B_, Bm.shape[1]), dtype=X_geo.dtype, device=X_geo.device)
        s = _newton(el, X_geo, x, s0, num_iterations, True, c, Bm)
        xi_f = c + s @ Bm.T
        cand_xi.append(xi_f)
        cand_dist.append(torch.where(_domain_distance(subdomain, s) <= tol, phys_dist(xi_f), torch.inf))
    dists = torch.stack(cand_dist, dim=1)
    best = torch.argmin(dists, dim=1)
    rows = torch.arange(B_, device=x.device)
    xi = torch.where(inside[:, None], xi_n, torch.stack(cand_xi, dim=1)[rows, best])
    return xi, inside, torch.where(inside, 0.0, dists[rows, best])


# ---------------------------------------------------------------------------
# The grid index
# ---------------------------------------------------------------------------


class _Aabbs(NamedTuple):
    lo: np.ndarray  # [E, d]
    hi: np.ndarray  # [E, d]


def _element_aabbs(mesh: Mesh) -> _Aabbs:
    X = mesh.cell_points()
    return _Aabbs(lo=X.min(axis=1), hi=X.max(axis=1))


@dataclass(frozen=True, eq=False)
class GridIndex:
    """Uniform-grid acceleration structure over element AABBs (spatially_indexed.rs:89).

    ``table [num_grid_cells, K]`` int32 lists, -1 padded, the elements
    whose inflated AABB overlaps each grid cell; host numpy arrays, equal
    to the JAX package's.  The device copies it and the mesh's location
    arrays are made on first use per device and dtype.
    """

    origin: np.ndarray  # [d]
    inv_cell: np.ndarray  # [d], 1 / cell size
    dims: np.ndarray  # [d] int64
    table: np.ndarray  # [num_cells, K] int32, -1 padded
    mesh: Mesh
    _cache: dict = field(default_factory=dict, repr=False)

    @staticmethod
    def build(mesh: Mesh, avg_elements_per_cell: float = 2.0) -> "GridIndex":
        """Rasterise every element's AABB (inflated by 1e-9 of the extent) into a grid of about
        ``E / avg_elements_per_cell`` cells shaped like the domain, on the host."""
        aabbs = _element_aabbs(mesh)
        d = mesh.dim
        lo_g = aabbs.lo.min(axis=0)
        hi_g = aabbs.hi.max(axis=0)
        extent = np.maximum(hi_g - lo_g, 1e-300)
        E = mesh.num_cells
        target_cells = max(1, int(E / avg_elements_per_cell))
        scale = (target_cells / np.prod(extent / extent.max())) ** (1.0 / d)
        dims = np.maximum(1, np.floor(extent / extent.max() * scale).astype(np.int64))
        cell = extent / dims
        inflate = 1e-9 * extent.max()
        lo_idx = np.clip(np.floor((aabbs.lo - inflate - lo_g) / cell).astype(np.int64), 0, dims - 1)
        hi_idx = np.clip(np.floor((aabbs.hi + inflate - lo_g) / cell).astype(np.int64), 0, dims - 1)
        # every (element, covered cell) pair, enumerated by its rank within the element's span
        spans = hi_idx - lo_idx + 1
        counts = np.prod(spans, axis=1)
        total = int(counts.sum())
        elem_ids = np.repeat(np.arange(E, dtype=np.int64), counts)
        offs = np.concatenate([[0], np.cumsum(counts)])[:-1]
        rank = np.arange(total) - np.repeat(offs, counts)
        cell_coords = np.empty((total, d), dtype=np.int64)
        stride = np.ones((E, d), dtype=np.int64)
        for ax in range(d - 2, -1, -1):
            stride[:, ax] = stride[:, ax + 1] * spans[:, ax + 1]
        stride_r = np.repeat(stride, counts, axis=0)
        lo_r = np.repeat(lo_idx, counts, axis=0)
        span_r = np.repeat(spans, counts, axis=0)
        rem = rank
        for ax in range(d):
            q = rem // stride_r[:, ax]
            cell_coords[:, ax] = lo_r[:, ax] + q % span_r[:, ax]
            rem = rem % stride_r[:, ax]
        lin = np.zeros(total, dtype=np.int64)
        mul = 1
        for ax in range(d - 1, -1, -1):
            lin += cell_coords[:, ax] * mul
            mul *= dims[ax]
        order = np.argsort(lin, kind="stable")
        lin_s, elem_s = lin[order], elem_ids[order]
        ncells = int(np.prod(dims))
        starts = np.searchsorted(lin_s, np.arange(ncells + 1))
        percell = np.diff(starts)
        K = max(1, int(percell.max()))
        table = np.full((ncells, K), -1, dtype=np.int32)
        table[lin_s, np.arange(total) - np.repeat(starts[:-1], percell)] = elem_s
        # an empty cell takes the candidates of its nearest non-empty cell (multi-source BFS dilation)
        if (percell == 0).any() and (percell > 0).any():
            grid = np.where(percell > 0, np.arange(ncells, dtype=np.int64), -1).reshape(tuple(dims))
            while (grid < 0).any():
                new = grid.copy()
                for ax in range(d):
                    for shift in (1, -1):
                        shifted = np.roll(grid, shift, axis=ax)
                        edge = [slice(None)] * d
                        edge[ax] = 0 if shift == 1 else -1
                        shifted[tuple(edge)] = -1
                        new = np.where((new < 0) & (shifted >= 0), shifted, new)
                if np.array_equal(new, grid):
                    break  # disconnected slabs: never loop forever
                grid = new
            src = grid.reshape(-1)
            empty = percell == 0
            table[empty] = table[np.maximum(src[empty], 0)]
        return GridIndex(origin=lo_g, inv_cell=1.0 / cell, dims=dims, table=table, mesh=mesh)

    def arrays(self, device, dtype) -> dict:
        """The table and the mesh's location arrays (:func:`_mesh_arrays`) on ``device``, made once."""
        key = (torch.device(device), dtype)
        if key not in self._cache:
            out = _mesh_arrays(self.mesh, key[0], dtype)
            out.update(
                table=torch.as_tensor(self.table, device=key[0]),
                origin=torch.as_tensor(self.origin, dtype=dtype, device=key[0]),
                inv_cell=torch.as_tensor(self.inv_cell, dtype=dtype, device=key[0]),
                dims=torch.as_tensor(self.dims, device=key[0]),
                strides=torch.as_tensor(np.cumprod(np.append(self.dims[1:], 1)[::-1])[::-1].copy(), device=key[0]),
            )
            self._cache[key] = out
        return self._cache[key]

    def _cells_of(self, points: torch.Tensor) -> torch.Tensor:
        a = self.arrays(points.device, points.dtype)
        idx = torch.floor((points - a["origin"]) * a["inv_cell"]).to(torch.int64)
        return torch.minimum(idx.clamp_min(0), a["dims"] - 1)

    def candidates(self, points: torch.Tensor, ring: bool = False) -> torch.Tensor:
        """Candidate element ids per point, -1 padded: the landing cell's ``[Q, K]``, or with ``ring=True`` its
        3^d neighbourhood's tables concatenated, ``[Q, 3^d K]`` (duplicates possible)."""
        a = self.arrays(points.device, points.dtype)
        idx = self._cells_of(points)
        if ring:
            d = idx.shape[-1]
            offsets = np.stack(np.meshgrid(*([np.array([-1, 0, 1])] * d), indexing="ij"), -1).reshape(-1, d)
            off = torch.as_tensor(offsets, device=points.device)
            idx = torch.minimum((idx[:, None, :] + off).clamp_min(0), a["dims"] - 1)  # [Q, 3^d, d]
        cand = a["table"][(idx * a["strides"]).sum(-1)].long()
        return cand.reshape(points.shape[0], -1)

    def guarantee_radius(self, points: torch.Tensor) -> torch.Tensor:
        """Per-point provable search radius of the ring gather, in f64.

        An element missing from the ring has its AABB outside the gathered
        3^d cells, so its distance exceeds the distance from the point to
        the region's exterior; faces on the grid's border count as +inf.
        """
        p = points.to(torch.float64)
        dims = torch.as_tensor(self.dims, device=p.device)
        origin = torch.as_tensor(self.origin, device=p.device)
        inv_cell = torch.as_tensor(self.inv_cell, device=p.device)
        c = torch.minimum(torch.floor((p - origin) * inv_cell).to(torch.int64).clamp_min(0), dims - 1)
        cell = 1.0 / inv_cell
        lo_cell, hi_cell = c - 1, c + 2
        dist_lo = torch.where(lo_cell <= 0, torch.inf, p - (origin + lo_cell * cell))
        dist_hi = torch.where(hi_cell >= dims, torch.inf, origin + hi_cell * cell - p)
        return torch.minimum(dist_lo, dist_hi).amin(dim=1)


def _mesh_arrays(mesh: Mesh, device, dtype) -> dict:
    """The mesh's location arrays on ``device``: geometry nodes ``X [E, m, d]``, AABBs ``lo``/``hi``, in f32 the
    brute force's filter (the rows ``[-2c, 1, |c|²]`` of the box centres, the half diagonals and their
    bounds), and the cells (int64)."""
    aabbs = _element_aabbs(mesh)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)  # noqa: E731
    lo, hi = as_t(aabbs.lo), as_t(aabbs.hi)
    centres = (0.5 * (lo + hi)).float()
    c2 = (centres * centres).sum(-1)
    radii = (0.5 * torch.linalg.vector_norm(hi - lo, dim=-1)).float()
    return dict(
        X=as_t(mesh.cell_points()[:, : mesh.element.geometry.num_nodes, :]),
        lo=lo,
        hi=hi,
        centre_rows=torch.cat([-2.0 * centres.T, torch.ones_like(c2)[None], c2[None]], 0),  # [d + 2, E]
        c2_max=c2.max() if c2.numel() else c2.new_zeros(()),
        c_max=centres.abs().max() if c2.numel() else c2.new_zeros(()),
        r_max=radii.max() if c2.numel() else c2.new_zeros(()),
        radii32=radii,
        cells=torch.as_tensor(mesh.cells, dtype=torch.int64, device=device),
    )


# ---------------------------------------------------------------------------
# Closest-element queries
# ---------------------------------------------------------------------------


class ClosestElementResult(NamedTuple):
    element_indices: torch.Tensor  # [Q] int64
    reference_coords: torch.Tensor  # [Q, d]
    domain_distance: torch.Tensor  # [Q] physical distance to the element, 0 inside


def _aabb_d2(lo, hi, p):
    """Squared distances from points ``p [..., d]`` to boxes ``lo``/``hi [..., d]`` (the JAX package's sum)."""
    return ((lo - p).clamp_min(0.0) ** 2 + (p - hi).clamp_min(0.0) ** 2).sum(-1)


def _closest_pairs(el: ReferenceElement, X_all, points, cand, q, j, tol: float, charts: bool, num_iterations: int = 24):
    """:func:`closest_point_in_element` on the (point ``q``, candidate column ``j``) pairs, SELECT_PAIRS at a
    time."""
    parts = [closest_point_in_element(el, X_all[cand[q[p0 : p0 + SELECT_PAIRS], j[p0 : p0 + SELECT_PAIRS]]],
                                      points[q[p0 : p0 + SELECT_PAIRS]], num_iterations, tol, charts)
             for p0 in range(0, max(q.numel(), 1), SELECT_PAIRS)]
    return [torch.cat(t) for t in zip(*parts)]


def _open_pairs(cand, cand_dist, covered, bound, lo: int, hi: int):
    """The (query, column) pairs of columns ``lo:hi`` that can still win: real candidates of queries that no
    candidate contains yet, whose AABB distance does not exceed the query's ``bound``."""
    mask = (cand[:, lo:hi] >= 0) & ~covered[:, None] & (cand_dist[:, lo:hi] <= bound[:, None])
    q, j = torch.nonzero(mask).unbind(1)
    return q, j + lo


def _inside_pass(el: ReferenceElement, X_all, points, cand, q, j, tol: float):
    """The pre-pass (no charts) on the pairs.  On an affine geometry one Newton step gives the 24 steps'
    coordinates to rounding, so the pairs whose point lies outside by more than the tolerance plus 1e-9 after
    one step are outside (distance inf) without the 24 steps."""
    if not el.geometry.is_affine:
        return _closest_pairs(el, X_all, points, cand, q, j, tol, False)
    xi, inside, dist = _closest_pairs(el, X_all, points, cand, q, j, tol, False, num_iterations=1)
    near = torch.nonzero(reference_domain_distance(el, xi) <= tol + 1e-9).reshape(-1)
    xi[near], inside[near], dist[near] = _closest_pairs(el, X_all, points, cand, q[near], j[near], tol, False)
    return xi, inside, dist


def _charts_that_can_win(el: ReferenceElement, X_all, points, cand, q, j, chart, best_dist, slack, tol: float):
    """The pairs ``chart`` (positions in ``q``, ``j``) left to the 24-step chart pass.  On an affine geometry
    one Gauss-Newton step finds each chart's minimiser to rounding, so a chart pass of one step drops the
    pairs farther than their query's best (so far, or in this pass) by more than ``slack``."""
    if not el.geometry.is_affine:
        return chart
    qc = q[chart]
    d1 = _closest_pairs(el, X_all, points, cand, qc, j[chart], tol, True, num_iterations=1)[2]
    bound = torch.minimum(best_dist, torch.full_like(best_dist, torch.inf).scatter_reduce(0, qc, d1, "amin"))
    return chart[d1 <= bound[qc] * (1.0 + 1e-9) + slack[qc]]


class _Best(NamedTuple):
    """Each query's best candidate so far: its score, column, distance and reference coordinates, whether a
    candidate contains the query, and the columns taken."""

    score: torch.Tensor
    j: torch.Tensor
    dist: torch.Tensor
    xi: torch.Tensor
    covered: torch.Tensor
    cols: int

    def rows(self, sel) -> "_Best":
        return _Best(*(t[sel] for t in self[:5]), self.cols)


def _select_among_candidates(el: ReferenceElement, X_all, points, cand, cand_dist, tol: float,
                             best: Optional[_Best] = None) -> _Best:
    """The closest-point query on the candidates ``cand [Q, k]`` (-1 pads), ranked by their AABB distances
    ``cand_dist``; the least physical distance wins, the AABB distance breaking exact ties only and the first
    column among equal scores (space/mod.rs:217).

    The JAX package queries every candidate: the pre-pass, then the chart
    pass for every candidate of a query that no candidate contains.  The
    port takes the columns in blocks (the first FIRST_BLOCK, then four
    times as many at a time), and a later block only for the queries that
    no candidate contains yet and only on the candidates whose AABB
    distance does not exceed the best distance so far plus 1e-12 (1 +
    |p|) for rounding: a candidate past that lies farther away than the
    best and cannot win, and a contained query's later candidates lose
    every tie to its first contained one.  On an affine geometry one
    Gauss-Newton step finds each chart's minimiser to rounding, so a
    chart pass of one step first drops the candidates farther than the
    block's best by more than that slack; the others take the full 24
    steps.  ``best`` carries the result of the first ``best.cols`` columns
    of the same ranking (a certification's re-run with more candidates).
    The winner is the one JAX's ``argmin`` picks.
    """
    Q, k = cand.shape
    dev, dtype = points.device, points.dtype
    if best is None:
        best = _Best(torch.full((Q,), torch.inf, dtype=dtype, device=dev), torch.zeros(Q, dtype=torch.int64, device=dev),
                     torch.full((Q,), torch.inf, dtype=dtype, device=dev),
                     torch.zeros((Q, el.ref_dim), dtype=dtype, device=dev),
                     torch.zeros(Q, dtype=torch.bool, device=dev), 0)
    best_score, best_j, best_dist, best_xi, covered = (t.clone() for t in best[:5])
    slack = 1e-12 * (1.0 + points.abs().amax(1))
    lo = best.cols
    hi = min(k, max(FIRST_BLOCK, 4 * lo))
    while lo < k:
        q, j = _open_pairs(cand, cand_dist, covered, best_dist + slack, lo, hi)
        lo, hi = hi, min(4 * hi, k)
        if not q.numel():
            continue
        # the pre-pass answers the pairs whose point lies inside; queries left uncovered pay the chart pass
        xi, inside, dist = _inside_pass(el, X_all, points, cand, q, j, tol)
        covered[q[inside]] = True
        chart = torch.nonzero(~inside & ~covered[q]).reshape(-1)
        if chart.numel():
            location_counts["charted"] += torch.unique(q[chart]).numel()
            chart = _charts_that_can_win(el, X_all, points, cand, q, j, chart, best_dist, slack, tol)
            xi[chart], inside[chart], dist[chart] = _closest_pairs(el, X_all, points, cand, q[chart], j[chart], tol,
                                                                   charts=True)
        score = torch.where(inside, 0.0, dist) + 1e-12 * cand_dist[q, j]
        # per query: the least score, and the first column among equal ones
        m = torch.full((Q,), torch.inf, dtype=dtype, device=dev).scatter_reduce(0, q, score, "amin")
        win = score == m[q]
        jmin = torch.full((Q,), k, device=dev).scatter_reduce(0, q, torch.where(win, j, k), "amin")
        pick = torch.nonzero(win & (j == jmin[q])).reshape(-1)
        pq = q[pick]
        better = (m[pq] < best_score[pq]) | ((m[pq] == best_score[pq]) & (j[pick] < best_j[pq]))
        pq, pick = pq[better], pick[better]
        best_score[pq] = score[pick]
        best_j[pq] = j[pick]
        best_dist[pq] = torch.where(inside[pick], 0.0, dist[pick])
        best_xi[pq] = xi[pick]
    return _Best(best_score, best_j, best_dist, best_xi, covered, k)


def _result(best: _Best, cand) -> ClosestElementResult:
    rows = torch.arange(cand.shape[0], device=cand.device)
    return ClosestElementResult(cand[rows, best.j].clamp_min(0), best.xi, best.dist)


def _grid_candidates(index: GridIndex, a: dict, points, num_candidates: int):
    """Ring candidates, deduplicated, and the best k by AABB distance: ``(cand [Q, k], AABB distance [Q, k],
    limit [Q])``, where ``limit`` is the smaller of the ring's guarantee radius and the first dropped AABB
    distance: an answer no farther than it is certified."""
    cand = index.candidates(points, ring=True)
    safe = cand.clamp_min(0)
    d2 = torch.where(cand < 0, torch.inf, _aabb_d2(a["lo"][safe], a["hi"][safe], points[:, None]))
    # an element rasterised into several ring cells appears once: sort by id, drop repeats
    cand, order = torch.sort(cand, dim=1, stable=True)
    d2 = torch.gather(d2, 1, order)
    dup = torch.zeros_like(cand, dtype=torch.bool)
    dup[:, 1:] = cand[:, 1:] == cand[:, :-1]
    cand = torch.where(dup, -1, cand)
    d2 = torch.where(dup, torch.inf, d2)
    W = cand.shape[1]
    k = min(num_candidates, W)
    d2, sel = torch.sort(d2, dim=1, stable=True)  # top_k's order: equal distances keep the lower position
    limit = index.guarantee_radius(points)
    if k < W:
        limit = torch.minimum(limit, torch.sqrt(d2[:, k].clamp_min(0.0)).double())
    return torch.gather(cand, 1, sel[:, :k]), torch.sqrt(d2[:, :k].clamp_min(0.0)), limit


def _brute_candidates(a: dict, points, num_candidates: int):
    """The k elements of least AABB distance to each point, in the order of ``jax.lax.top_k`` over every
    element: ``(cand [Q, k], AABB distance [Q, k], limit [Q])``, ``limit`` the first dropped AABB distance
    (a lower bound of a dropped element's distance; inf when every element is a candidate).

    Only elements whose lower bound ``|p - centre| - half diagonal`` does
    not exceed an upper bound ``T`` of the (k+1)-th smallest upper bound
    ``|p - centre|`` are measured, in the points' dtype.  The test runs on
    squared centre distances from one f32 matrix product, ``[p, |p|², 1]
    · [-2c, 1, |c|²]``: ``|p - c|² <= (T + r + e)² + e2`` with ``e2`` a
    bound of the product's absolute error and ``e`` of the inputs' f32
    rounding, so it keeps every element that can be among the k+1
    nearest.  ``T`` is the (k+1)-th smallest of the minima of blocks of
    BRUTE_BLOCK elements (k+1 distinct elements lie within it): a
    selection over 1 / BRUTE_BLOCK of the entries.
    """
    Q, E = points.shape[0], a["lo"].shape[0]
    k = min(num_candidates, E)
    kk = min(k + 1, E)
    p32 = points.float()
    p2 = (p32 * p32).sum(1, keepdim=True)
    lhs = torch.cat([p32, p2, torch.ones_like(p2)], 1)  # [Q, d + 2]
    d2 = lhs @ a["centre_rows"]  # [Q, E] squared centre distances
    eps = torch.finfo(torch.float32).eps
    e2 = 16.0 * eps * (p2.max() + a["c2_max"])
    e = 4.0 * eps * (p32.abs().max() + a["c_max"] + a["r_max"])
    Eb = E // BRUTE_BLOCK * BRUTE_BLOCK
    mins = d2[:, :Eb].reshape(Q, -1, BRUTE_BLOCK).amin(-1)
    if Eb < E:
        mins = torch.cat([mins, d2[:, Eb:].amin(1, keepdim=True)], 1)
    T2 = (torch.topk(mins, kk, dim=1, largest=False).values[:, -1:] if kk <= mins.shape[1]
          else d2.amax(1, keepdim=True))
    T = torch.sqrt((T2 + e2).clamp_min(0.0)) * (1.0 + 1e-6) + e
    rows, cols = torch.nonzero(d2 <= (T + a["radii32"] + e).square_() + e2).unbind(1)
    del d2
    counts = torch.bincount(rows, minlength=Q)
    pos = torch.arange(rows.numel(), device=rows.device) - (torch.cumsum(counts, 0) - counts)[rows]
    M = int(counts.max())
    table = torch.full((Q, M), torch.inf, dtype=points.dtype, device=points.device)
    ids = torch.zeros((Q, M), dtype=torch.int64, device=points.device)
    table[rows, pos] = _aabb_d2(a["lo"][cols], a["hi"][cols], points[rows])
    ids[rows, pos] = cols  # ascending within a row: a stable sort keeps the lower element id first on ties
    d2, sel = torch.sort(table, dim=1, stable=True)
    cand = torch.gather(ids, 1, sel[:, :k])
    limit = torch.sqrt(d2[:, k].clamp_min(0.0)).double() if kk > k else points.new_full((Q,), torch.inf).double()
    return cand, torch.sqrt(d2[:, :k] + 1e-300), limit


def _chunked(fn, points, chunk: int):
    """``fn(points)``, ``chunk`` points at a time, its outputs concatenated."""
    return [torch.cat(t) for t in zip(*(fn(points[q0 : q0 + chunk]) for q0 in range(0, points.shape[0], chunk)))]


def _brute_force(mesh: Mesh, a: dict, points, num_candidates: int, tol: float, chunk: int) -> ClosestElementResult:
    """The brute-force branch: the k nearest boxes of every element, the closest-point query on them, and
    the certification, re-running the uncertified points with four times the candidates (their first k
    columns, the same elements in the same order, keep their results)."""
    el, E = mesh.element, mesh.num_cells
    out, pending, best, k = None, None, None, num_candidates
    while True:
        pts = points if pending is None else points[pending]
        cand, cand_dist, limit = _chunked(lambda p: _brute_candidates(a, p, k), pts, chunk)
        best = _select_among_candidates(el, a["X"], pts, cand, cand_dist, tol, best)
        res = _result(best, cand)
        if out is None:
            out = res
        else:
            for full, part in zip(out, res):
                full[pending] = part
        unsafe = torch.nonzero(~(res.domain_distance.double() <= limit)).reshape(-1)
        if not unsafe.numel() or k >= E:
            return out
        location_counts["reruns"] += unsafe.numel()
        pending = unsafe if pending is None else pending[unsafe]
        best, k = best.rows(unsafe), min(4 * k, E)


def find_closest_element(mesh: Mesh, points, num_candidates: int = 8, tol: float = 1e-10,
                         index: Optional[GridIndex] = None, chunk_size: Optional[int] = None,
                         device=None) -> ClosestElementResult:
    """The element containing, or closest to, each point ``[Q, d]``.

    Candidates are the ``num_candidates`` elements of least AABB distance
    among the :class:`GridIndex` ring (``index``) or among all elements;
    the closest-point query on them picks the nearest.  Every answer is
    certified: with the grid, the distance must not exceed the ring's
    guarantee radius nor the first dropped candidate's AABB distance,
    else the query re-runs through the brute-force branch; there, a
    distance above the first dropped AABB distance re-runs it with four
    times the candidates.  Candidates are found ``chunk_size`` points at a
    time (default: CHUNK_ENTRIES ring entries, or BRUTE_ENTRIES element
    distances, a chunk) and the closest-point queries run SELECT_PAIRS
    (point, candidate) pairs at a time; the results depend on neither.
    ``points`` may be numpy (then put on ``device``, the card by default)
    or a tensor (its device).
    """
    if isinstance(points, torch.Tensor):
        dev = points.device if device is None else resolve_device(device)
        points = points.to(dev)
    else:
        dev = resolve_device("cuda" if device is None else device)
        points = torch.as_tensor(np.asarray(points, dtype=np.float64), device=dev)
    if not points.shape[0]:
        return ClosestElementResult(torch.zeros(0, dtype=torch.int64, device=dev),
                                    points.new_zeros((0, mesh.element.ref_dim)), points.new_zeros(0))
    a = index.arrays(dev, points.dtype) if index is not None else _mesh_arrays(mesh, dev, points.dtype)
    brute_chunk = chunk_size or max(16, BRUTE_ENTRIES // max(mesh.num_cells, 1))
    if index is None:
        return _brute_force(mesh, a, points, num_candidates, tol, brute_chunk)
    chunk = chunk_size or max(16, CHUNK_ENTRIES // (3 ** mesh.dim * index.table.shape[1]))
    cand, cand_dist, limit = _chunked(lambda p: _grid_candidates(index, a, p, num_candidates), points, chunk)
    res = _result(_select_among_candidates(mesh.element, a["X"], points, cand, cand_dist, tol), cand)
    idx = torch.nonzero(~(res.domain_distance.double() <= limit)).reshape(-1)
    if idx.numel():
        location_counts["reruns"] += idx.numel()
        for full, part in zip(res, _brute_force(mesh, a, points[idx], num_candidates, tol, brute_chunk)):
            full[idx] = part
    return res


location_counts = {"charted": 0, "reruns": 0}


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------


def _dofs(u, s: int, like: torch.Tensor) -> torch.Tensor:
    u = u if isinstance(u, torch.Tensor) else torch.as_tensor(np.asarray(u), device=like.device)
    return u.reshape(-1, s)


def _physical_basis_gradients(mesh: Mesh, res: ClosestElementResult) -> torch.Tensor:
    """``∇φ [Q, n, d]`` at the located points: ``dphi J⁻¹`` with J from the geometry nodes."""
    el = mesh.element
    xi = res.reference_coords
    m = el.geometry.num_nodes
    X = torch.as_tensor(mesh.points, dtype=xi.dtype, device=xi.device)[
        torch.as_tensor(mesh.cells[:, :m], dtype=torch.int64, device=xi.device)[res.element_indices]]
    Jinv, _ = inv_and_det(torch.einsum("qmi,qmd->qid", X, el.geometry.dphi(xi)))
    return torch.einsum("qnk,qki->qni", el.dphi(xi), Jinv)


def _nodes(mesh: Mesh, res: ClosestElementResult) -> torch.Tensor:
    return torch.as_tensor(mesh.cells, device=res.element_indices.device)[res.element_indices]


def interpolate_at_points(mesh: Mesh, u, points, solution_dim: int = 1, num_candidates: int = 8,
                          index: Optional[GridIndex] = None, chunk_size: Optional[int] = None, device=None):
    """A finite element function ``u [num_nodes * s]`` at arbitrary points -> ``([Q, s], located)``.

    Outside points evaluate at the closest point of their closest element
    (interpolate.rs:161 with ``SpatiallyIndexed``'s extrapolation).
    """
    res = find_closest_element(mesh, points, num_candidates, index=index, chunk_size=chunk_size, device=device)
    phi = mesh.element.phi(res.reference_coords)
    u2 = _dofs(u, solution_dim, phi)
    return torch.einsum("qn,qns->qs", phi, u2[_nodes(mesh, res)]), res


def interpolate_gradient_at_points(mesh: Mesh, u, points, solution_dim: int = 1, num_candidates: int = 8,
                                   index: Optional[GridIndex] = None, chunk_size: Optional[int] = None,
                                   device=None):
    """``∇u`` at arbitrary points (interpolate.rs:214) -> ``([Q, d, s], located)``."""
    res = find_closest_element(mesh, points, num_candidates, index=index, chunk_size=chunk_size, device=device)
    gp = _physical_basis_gradients(mesh, res)
    u2 = _dofs(u, solution_dim, gp)
    return torch.einsum("qni,qns->qis", gp, u2[_nodes(mesh, res)]), res


@dataclass(frozen=True, eq=False)
class FixedInterpolator:
    """Interpolation at a fixed set of points (fixed_interpolator.rs:13): the located points' nodes ``[Q, n]``
    (int32), basis values ``[Q, n]`` and optionally physical basis gradients ``[Q, n, d]``; applying it is a
    gather and a contraction."""

    nodes: torch.Tensor
    phi: torch.Tensor
    grad_phi: Optional[torch.Tensor]

    @staticmethod
    def from_space_and_points(mesh: Mesh, points, with_gradients: bool = False, num_candidates: int = 8,
                              index: Optional[GridIndex] = None, chunk_size: Optional[int] = None,
                              device=None) -> "FixedInterpolator":
        res = find_closest_element(mesh, points, num_candidates, index=index, chunk_size=chunk_size, device=device)
        grad = _physical_basis_gradients(mesh, res) if with_gradients else None
        return FixedInterpolator(nodes=_nodes(mesh, res), phi=mesh.element.phi(res.reference_coords), grad_phi=grad)

    def _gather(self, u, s: int) -> torch.Tensor:
        Q, n = self.nodes.shape
        return _dofs(u, s, self.phi).index_select(0, self.nodes.reshape(-1)).reshape(Q, n, s)

    def interpolate(self, u, solution_dim: int = 1) -> torch.Tensor:
        """``[Q, s]`` values of ``u [num_nodes * s]``."""
        return torch.einsum("qn,qns->qs", self.phi, self._gather(u, solution_dim))

    def interpolate_gradient(self, u, solution_dim: int = 1) -> torch.Tensor:
        """``[Q, d, s]`` gradients of ``u``."""
        if self.grad_phi is None:
            raise ValueError("built without gradients")
        return torch.einsum("qni,qns->qis", self.grad_phi, self._gather(u, solution_dim))
