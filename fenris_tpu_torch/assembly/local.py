"""Element-level assembly: basis tabulation and batched element kernels.

Counterpart of ``fenris_tpu/assembly/local.py``.  Every quantity is
computed for a whole batch of elements at once, with the element axis
first: jacobians ``[E, q, d, d]``, closed-form inverses, operator
evaluations over the ``[E, q]`` batch axes and the quadrature reduction as
one einsum.  The JAX package's element-minor (``local_em.py``) layouts are
TPU layout; the port computes the same values in this layout.

Material parameters follow the JAX package's leaf rules (``_vmap2``): a
leaf whose leading axis has the element count ``E`` is per element, and
per point as well when its next axis has the point count ``q`` (``[E,
q]``); a leaf whose leading axis is ``q`` (and not ``E``) is per point,
the same for every element; scalars and any other leaf are constants.
When ``E == q`` a leading axis is read as per element.  Per-element and
per-point leaves map through the operator with ``torch.func.vmap``;
constant parameters call it directly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import vmap
from torch.utils import _pytree as pytree

from ..quadrature import Rule
from ..reference_elements import ReferenceElement

__all__ = [
    "Tabulation",
    "tabulate",
    "jacobians",
    "inv_and_det",
    "physical_gradients",
    "compute_element_elliptic_energy",
    "assemble_element_elliptic_vectors",
    "assemble_element_elliptic_matrices",
    "assemble_element_elliptic_matrices_pairs",
    "assemble_element_elliptic_matrices_em",
    "assemble_element_mass_matrices",
    "assemble_element_source_vectors",
    "assemble_element_surface_source_vectors",
]


@dataclass(frozen=True)
class Tabulation:
    """Basis and geometry-basis values and reference gradients at a rule's points (float64 numpy).

    ``geo_phi``/``geo_dphi`` tabulate ``element.geometry`` at the same
    points: the element's own basis for isoparametric elements, the
    lowest-order one for subparametric tet10/tet20/hex20/hex27.
    """

    element: ReferenceElement
    weights: np.ndarray  # [q]
    points: np.ndarray  # [q, d]
    phi: np.ndarray  # [q, n]
    dphi: np.ndarray  # [q, n, d]
    geo_phi: np.ndarray  # [q, m]
    geo_dphi: np.ndarray  # [q, m, d]

    @property
    def num_points(self) -> int:
        return len(self.weights)


def tabulate(element: ReferenceElement, rule: Rule) -> Tabulation:
    """Tabulate ``element``'s basis and its geometry element's at ``rule``'s points."""
    w = np.asarray(rule.weights, dtype=np.float64)
    pts = np.asarray(rule.points, dtype=np.float64).reshape(len(w), element.ref_dim)
    phi, dphi = element.tabulate(pts)
    geo = element.geometry
    gphi, gdphi = (phi, dphi) if geo is element else geo.tabulate(pts)
    return Tabulation(element, w, pts, phi, dphi, gphi, gdphi)


def _const(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=like.dtype, device=like.device)


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim > 0


def _leaf_axes(x, E: int, q: int):
    """``(element axis, point axis)`` of one parameter leaf by JAX's ``_vmap2`` rules (None: not mapped)."""
    if not _is_array(x):
        return None, None
    if x.shape[0] == E:
        return 0, (0 if x.ndim >= 2 and x.shape[1] == q else None)
    if x.shape[0] == q:
        return None, 0
    return None, None


def has_mapped_params(params, E: int, q: int) -> bool:
    """Whether a parameter leaf is per element or per point (by :func:`_leaf_axes`)."""
    return any(_leaf_axes(x, E, q) != (None, None) for x in pytree.tree_leaves(params))


def _leaf_tensor(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _vmap2(fn, params, E: int, q: int):
    """``fn(*Gs, params)`` mapped over the leading ``[E, q]`` axes of the ``Gs`` (JAX's ``_vmap2``).

    Returns a function of ``(*Gs, params)``.  Per-element and per-point
    leaves (:func:`_leaf_axes`) map with their axes, as tensors of the
    first ``G``'s dtype and device; with none, ``fn`` itself is returned.
    """
    axes = [_leaf_axes(x, E, q) for x in pytree.tree_leaves(params)]
    if all(a == (None, None) for a in axes):
        return fn

    def mapped(*args):
        Gs, (leaves, spec) = args[:-1], pytree.tree_flatten(args[-1])
        p = pytree.tree_unflatten(
            [x if a == (None, None) else _leaf_tensor(x, Gs[0]) for x, a in zip(leaves, axes)], spec
        )
        inner = vmap(fn, in_dims=(0,) * len(Gs) + (pytree.tree_unflatten([a[1] for a in axes], spec),))
        outer = vmap(inner, in_dims=(0,) * len(Gs) + (pytree.tree_unflatten([a[0] for a in axes], spec),))
        return outer(*Gs, p)

    return mapped


def map_params(fn, params, batch_shape):
    """``fn(*Gs, params)`` over ``Gs [*batch_shape, d, s]`` with element-minor parameter leaves
    (JAX's ``local_em._pointwise_map``).

    Returns a function of ``(*Gs, params)``.  A leaf whose last ``k`` axes
    equal the last ``k`` batch axes maps with them (an ``[E]`` leaf over
    the element axis of batch ``(E,)``); any other leaf is a constant.
    With no mapped leaf, ``fn`` itself is returned.
    """
    nb = len(batch_shape)

    def k_of(x):
        k = 0
        if _is_array(x):
            while k < min(x.ndim, nb) and x.shape[x.ndim - 1 - k] == batch_shape[nb - 1 - k]:
                k += 1
        return k

    ks = [k_of(x) for x in pytree.tree_leaves(params)]
    if not any(ks):
        return fn

    def mapped(*args):
        Gs, (leaves, spec) = args[:-1], pytree.tree_flatten(args[-1])
        p = pytree.tree_unflatten([_leaf_tensor(x, Gs[0]) if k else x for x, k in zip(leaves, ks)], spec)
        f = fn
        for j in range(nb):  # level j maps batch axis j (the outermost level the last batch axis)
            dims = pytree.tree_unflatten([-1 if k >= nb - j else None for k in ks], spec)
            f = vmap(f, in_dims=(j,) * len(Gs) + (dims,), out_dims=j)
        return f(*Gs, p)

    return mapped


def slice_params(params, E: int, index):
    """The parameters of elements ``index`` (a slice or an index tensor): leaves with a leading axis
    of length ``E`` are indexed, the others pass through."""
    return pytree.tree_map(lambda x: x[index] if _is_array(x) and x.shape[0] == E else x, params)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def jacobians(X_geo: torch.Tensor, geo_dphi) -> torch.Tensor:
    """J[e, q, i, j] = sum_m X[e, m, i] dphi_geo[q, m, j]."""
    return torch.einsum("emi,qmj->eqij", X_geo, _const(geo_dphi, X_geo))


def _inv_det(J: torch.Tensor):
    """Closed-form inverse and determinant of ``J[d, d, ...]`` (matrix axes first).

    The cofactor formulas of the JAX package's ``local_em._inv_det``.
    """
    d = J.shape[0]
    if d == 1:
        det = J[0, 0]
        return (1.0 / det)[None, None], det
    if d == 2:
        det = J[0, 0] * J[1, 1] - J[0, 1] * J[1, 0]
        r = 1.0 / det
        inv = torch.stack(
            [torch.stack([J[1, 1] * r, -J[0, 1] * r]), torch.stack([-J[1, 0] * r, J[0, 0] * r])]
        )
        return inv, det
    if d == 3:
        c = [[None] * 3 for _ in range(3)]
        c[0][0] = J[1, 1] * J[2, 2] - J[1, 2] * J[2, 1]
        c[0][1] = J[0, 2] * J[2, 1] - J[0, 1] * J[2, 2]
        c[0][2] = J[0, 1] * J[1, 2] - J[0, 2] * J[1, 1]
        c[1][0] = J[1, 2] * J[2, 0] - J[1, 0] * J[2, 2]
        c[1][1] = J[0, 0] * J[2, 2] - J[0, 2] * J[2, 0]
        c[1][2] = J[0, 2] * J[1, 0] - J[0, 0] * J[1, 2]
        c[2][0] = J[1, 0] * J[2, 1] - J[1, 1] * J[2, 0]
        c[2][1] = J[0, 1] * J[2, 0] - J[0, 0] * J[2, 1]
        c[2][2] = J[0, 0] * J[1, 1] - J[0, 1] * J[1, 0]
        det = J[0, 0] * c[0][0] + J[0, 1] * c[1][0] + J[0, 2] * c[2][0]
        r = 1.0 / det
        return torch.stack([torch.stack([cij * r for cij in row]) for row in c]), det
    raise ValueError(f"unsupported dimension {d}")


def inv_and_det(J: torch.Tensor):
    """Closed-form batched inverse and determinant of ``J[..., d, d]``, d in {1, 2, 3}."""
    inv, det = _inv_det(J.movedim((-2, -1), (0, 1)))
    return inv.movedim((0, 1), (-2, -1)), det


def physical_gradients(dphi, Jinv: torch.Tensor) -> torch.Tensor:
    """grad_x phi = J^{-T} grad_xi phi: ``dphi [q, n, d]``, ``Jinv [E, q, d, d]`` -> ``[E, q, n, d]``."""
    return torch.einsum("qnk,eqki->eqni", _const(dphi, Jinv), Jinv)


def _wdet(tab: Tabulation, detJ: torch.Tensor) -> torch.Tensor:
    return _const(tab.weights, detJ)[None, :] * detJ.abs()


def _gradients_and_ugrad(X_geo, u_el, tab: Tabulation):
    J = jacobians(X_geo, tab.geo_dphi)
    Jinv, detJ = inv_and_det(J)
    gp = physical_gradients(tab.dphi, Jinv)  # [E, q, n, d]
    G = None if u_el is None else torch.einsum("eqnd,ens->eqds", gp, u_el)
    return gp, G, detJ


# ---------------------------------------------------------------------------
# Energies, vectors, matrices
# ---------------------------------------------------------------------------


def compute_element_elliptic_energy(X_geo, u_el, op, params, tab: Tabulation):
    """Per-element energies ``[E]`` (elliptic.rs:551)."""
    _, G, detJ = _gradients_and_ugrad(X_geo, u_el, tab)
    psi = _vmap2(op.energy, params, X_geo.shape[0], tab.num_points)(G, params)  # [E, q]
    return torch.einsum("eq,eq->e", _wdet(tab, detJ), psi)


def assemble_element_elliptic_vectors(X_geo, u_el, op, params, tab: Tabulation):
    """Element vectors ``f[e, n*s]``, f_I = ∫ g(∇u)^T ∇φ_I (elliptic.rs:457); node-major dofs."""
    gp, G, detJ = _gradients_and_ugrad(X_geo, u_el, tab)
    gvals = _vmap2(op.g, params, X_geo.shape[0], tab.num_points)(G, params)  # [E, q, d, s]
    f = torch.einsum("eq,eqds,eqnd->ens", _wdet(tab, detJ), gvals, gp)
    return f.reshape(f.shape[0], -1)


def _affine_geometry(tab: Tabulation) -> bool:
    """True when the geometry gradients do not depend on the quadrature point."""
    gd = np.asarray(tab.geo_dphi)
    return bool(np.all(np.abs(gd - gd[:1]) < 1e-12))


def _affine_const_applies(op, params, tab: Tabulation, E: int) -> bool:
    """The constant-projector form: a constant contraction on affine elements, and no per-element or
    per-point parameter (those take the general path, equal to roundoff)."""
    return (
        bool(getattr(op, "constant_contraction", False))
        and _affine_geometry(tab)
        and not has_mapped_params(params, E, tab.num_points)
    )


def assemble_element_elliptic_matrices(
    X_geo, u_el, op, params, tab: Tabulation, *, chunk: Optional[int] = None
):
    """Element matrices ``A[e, n*s, n*s]`` (elliptic.rs:361).

    ``A[(I,i),(J,j)] = ∫ ∇φ_I,k D[k,i,m,j](∇u) ∇φ_J,m`` with the operator's
    contraction tensor D; symmetric operators are symmetrised.  ``chunk``
    bounds memory by assembling that many elements at a time.
    """
    if chunk and X_geo.shape[0] > chunk:
        return _chunked_elliptic_matrices(X_geo, u_el, op, params, tab, chunk)
    if _affine_const_applies(op, params, tab, X_geo.shape[0]):
        return _elliptic_matrices_affine_const(X_geo, op, params, tab, "e")
    gp, G, detJ = _gradients_and_ugrad(X_geo, u_el, tab)
    s = op.solution_dim
    if G is None:
        E, q, _, d = gp.shape
        G = gp.new_zeros((E, q, d, s))
    D = _vmap2(op.contraction, params, X_geo.shape[0], tab.num_points)(G, params)  # [E, q, d, s, d, s]
    # the small m-contraction first, then one batched product over (q, k)
    T = torch.einsum("eqkimj,eqpm->eqkipj", D, gp)
    A = torch.einsum("eq,eqnk,eqkipj->enipj", _wdet(tab, detJ), gp, T)
    E, n = A.shape[0], A.shape[1]
    A = A.reshape(E, n * s, n * s)
    if op.symmetric:
        A = 0.5 * (A + A.transpose(1, 2))
    return A


def _chunked_elliptic_matrices(X_geo, u_el, op, params, tab: Tabulation, chunk: int):
    """Element matrices ``chunk`` elements at a time (same per-element math).

    Per-element leaves (leading axis ``E``) are sliced with the geometry;
    a constant leaf whose leading axis is ``chunk`` would read as per
    element inside a chunk and raises ``ValueError``, as in the JAX package.
    """
    E = X_geo.shape[0]
    for x in pytree.tree_leaves(params):
        if _is_array(x) and x.shape[0] == chunk != E:
            raise ValueError(
                f"chunk={chunk} collides with a constant parameter leaf of shape {tuple(x.shape)}: inside a "
                "chunk it would read as per-element. Pick a different chunk size or give the leaf an explicit "
                "leading axis."
            )
    parts = [
        assemble_element_elliptic_matrices(
            X_geo[e0 : e0 + chunk], None if u_el is None else u_el[e0 : e0 + chunk], op,
            slice_params(params, E, slice(e0, e0 + chunk)), tab,
        )
        for e0 in range(0, E, chunk)
    ]
    return torch.cat(parts, 0)


def assemble_element_elliptic_matrices_em(X_geo, u_el, op, params, tab: Tabulation):
    """Element matrices in the element-minor layout ``A[n*s, n*s, E]``.

    The values of :func:`assemble_element_elliptic_matrices` with the
    element axis last (the JAX package's TPU layout; its block-DIA scatter
    reads it).
    """
    return assemble_element_elliptic_matrices(X_geo, u_el, op, params, tab).permute(1, 2, 0).contiguous()


def assemble_element_elliptic_matrices_pairs(X_geo, u_el, op, params, tab: Tabulation, kernel=False):
    """Element matrices in the component-pair layout ``[s², n², E]``.

    Entry ``[i·s + j, a·n + b, e]`` is element ``e``'s matrix entry
    ``((a, i), (b, j))``.  ``kernel="auto"`` (the JAX package's
    ``pallas="auto"``) sends constant-contraction f32 CUDA inputs to the
    hand-written stiffness kernel (:mod:`..ops.stiffness_pairs`);
    ``kernel=True`` forces its wrapper; ``False`` (the default, as in the
    JAX package) is the plain formulation.  The kernel takes constant
    parameters only: with per-element or per-point leaves ``"auto"`` runs
    the plain pairs formulation, as the JAX package does (no TPU kernel
    takes them there either).
    """
    if kernel in ("auto", True):
        from ..ops.stiffness_pairs import stiffness_pairs, supports_stiffness_kernel

        if kernel is True or supports_stiffness_kernel(op, params, tab, X_geo):
            return stiffness_pairs(X_geo, op, params, tab)
    if _affine_const_applies(op, params, tab, X_geo.shape[0]):
        return _elliptic_matrices_affine_const(X_geo, op, params, tab, "pairs")
    return _elliptic_matrices_pairs(X_geo, u_el, op, params, tab)


def _pair_list(s: int, symmetric: bool):
    return [(i, j) for i in range(s) for j in range(s) if (not symmetric) or i <= j]


def _elliptic_matrices_pairs(X_geo, u_el, op, params, tab: Tabulation):
    """Pairs-layout assembly around the constant reference projector.

    The JAX package's ``_elliptic_matrices_mxu(out_layout="pairs")``: with
    ``lhs[(a, b, q), e] = wdet · Jinv[a,k] C[k,m] Jinv[b,m]`` (C the
    Ft-pair average of D for symmetric operators) and the host projector
    ``W[(a, b, q), (n, p)] = dphi[q,n,a] dphi[q,p,b]``, block (i, j) is
    ``Wᵀ @ lhs``.  The mirrored blocks (i > j) of a symmetric operator are
    node transposes of their upper blocks.  This is also the plain version
    of the stiffness kernel (``u_el=None`` with a constant contraction).
    """
    E = X_geo.shape[0]
    q = tab.num_points
    s = op.solution_dim
    m, d = tab.geo_dphi.shape[1], tab.geo_dphi.shape[2]
    n = tab.dphi.shape[1]
    J = torch.einsum("qmj,emi->ijqe", _const(tab.geo_dphi, X_geo), X_geo)  # [d, d, q, E]
    Jinv, det = _inv_det(J)
    wdet = _const(tab.weights, X_geo)[:, None] * det.abs()  # [q, E]
    Jmw = Jinv * wdet
    mapped = has_mapped_params(params, E, q)
    const_D = bool(getattr(op, "constant_contraction", False)) and not mapped
    if const_D:
        # independent of ∇u, position and element: evaluated once, unbatched
        D = op.contraction(X_geo.new_zeros((d, s)), params)  # [d, s, d, s]
    else:
        if u_el is None:  # a constant contraction with per-element or per-point parameters
            G = X_geo.new_zeros((q, E, d, s))
        else:
            dphi = _const(tab.dphi, X_geo)
            gp = torch.einsum("qna,akqe->qenk", dphi, Jinv)  # [q, E, n, d]
            G = torch.einsum("qenk,ens->qeks", gp, u_el)
        if mapped:
            D = _vmap2(op.contraction, params, E, q)(G.transpose(0, 1), params).permute(2, 3, 4, 5, 1, 0)
        else:
            D = op.contraction(G, params).permute(2, 3, 4, 5, 0, 1)  # [d, s, d, s, q, E]
    Wc_np = np.einsum("qna,qpb->abqnp", tab.dphi, tab.dphi).reshape(d * d * q, n * n)
    Wc = _const(Wc_np, X_geo)

    def lhs_pair(i, j):
        C = D[:, i, :, j]
        if op.symmetric:
            C = 0.5 * (C + D[:, j, :, i].transpose(0, 1))
        if const_D:
            t = torch.einsum("km,bmqe->kbqe", C, Jinv)
        else:
            t = torch.einsum("kmqe,bmqe->kbqe", C, Jinv)
        return torch.einsum("akqe,kbqe->abqe", Jmw, t).reshape(d * d * q, E)

    blocks = {}
    for i, j in _pair_list(s, op.symmetric):
        blocks[(i, j)] = Wc.T @ lhs_pair(i, j)  # [n², E]
        if op.symmetric and i != j:
            blocks[(j, i)] = blocks[(i, j)].reshape(n, n, E).transpose(0, 1).reshape(n * n, E)
    return torch.stack([blocks[(i, j)] for i in range(s) for j in range(s)], 0)


def _interleaved_projector(W2h: np.ndarray, s: int, layout: str) -> np.ndarray:
    """Host ``[s²d², cols]`` block-diagonal projector from ``W2h [d, d, n, n]``.

    Columns (i, j, n, p) for the "pairs" layout, (n, i, p, j) for "e".
    """
    d, _, n, _ = W2h.shape
    if layout == "pairs":
        W4 = np.zeros((s, s, d, d, s, s, n, n), W2h.dtype)
        for i in range(s):
            for j in range(s):
                W4[i, j, :, :, i, j, :, :] = W2h
    else:
        W4 = np.zeros((s, s, d, d, n, s, n, s), W2h.dtype)
        for i in range(s):
            for j in range(s):
                W4[i, j, :, :, :, i, :, j] = W2h
    return W4.reshape(s * s * d * d, s * s * n * n)


def _elliptic_matrices_affine_const(X_geo, op, params, tab: Tabulation, out_layout: str):
    """Element matrices of a constant-contraction operator on affine elements.

    With J, J⁻¹ and det J the same at every quadrature point and D
    independent of ∇u, the quadrature sum hoists into a constant projector
    ``W2[(a,b),(n,p)] = Σ_q w_q dphi[q,n,a] dphi[q,p,b]`` (the JAX
    package's ``_elliptic_matrices_affine_const``); ``u`` is not read.
    """
    E = X_geo.shape[0]
    s = op.solution_dim
    gd0 = np.asarray(tab.geo_dphi[0])  # [m, d]
    d = gd0.shape[1]
    n = tab.dphi.shape[1]
    J = torch.einsum("mj,emi->ije", _const(gd0, X_geo), X_geo)  # [d, d, E]
    Jinv, det = _inv_det(J)
    D = op.contraction(X_geo.new_zeros((d, s)), params)  # [d, s, d, s]
    ft = det.abs() * torch.einsum("ake,kimj,bme->aibje", Jinv, D, Jinv)  # [d, s, d, s, E]
    if op.symmetric:
        ft = 0.5 * (ft + ft.permute(2, 3, 0, 1, 4))
    lhs = ft.permute(1, 3, 0, 2, 4).reshape(s * s * d * d, E)  # rows (i, j, a, b)
    W2h = np.einsum("q,qna,qpb->abnp", tab.weights, tab.dphi, tab.dphi)
    W4 = _const(_interleaved_projector(W2h, s, out_layout), X_geo)
    if out_layout == "pairs":
        return (W4.T @ lhs).reshape(s * s, n * n, E)
    return (lhs.T @ W4).reshape(E, n * s, n * s)


def assemble_element_mass_matrices(X_geo, density, solution_dim: int, tab: Tabulation):
    """Element mass matrices ``M[e, (I,i), (J,j)] = ∫ ρ φ_I φ_J δ_ij`` (mass.rs:191).

    ``density``: a scalar, per element ``[E]`` or per point ``[E, q]``.
    ``solution_dim`` 1 gives ``[E, n, n]``, s gives ``[E, n*s, n*s]``.
    """
    J = jacobians(X_geo, tab.geo_dphi)
    _, detJ = inv_and_det(J)
    rho = _leaf_tensor(density, X_geo)
    if rho.ndim == 1 and rho.shape[0] == X_geo.shape[0]:
        rho = rho[:, None]  # per element, the same at every point
    phi = _const(tab.phi, X_geo)
    Mn = torch.einsum("eq,qn,qm->enm", _wdet(tab, detJ) * rho, phi, phi)  # [E, n, n]
    s = solution_dim
    if s == 1:
        return Mn
    E, n = Mn.shape[0], Mn.shape[1]
    eye = torch.eye(s, dtype=X_geo.dtype, device=X_geo.device)
    return torch.einsum("enm,ij->enimj", Mn, eye).reshape(E, n * s, n * s)


def _source_values(X_geo, source, params, solution_dim: int, tab: Tabulation) -> torch.Tensor:
    """``f(x) [E, q, s]`` at the mapped quadrature points: ``source`` a pointwise callable ``f(x [D], params)
    -> [s]`` (per-element and per-point parameter leaves map by :func:`_leaf_axes`) or a constant ``[s]``."""
    E, q = X_geo.shape[0], tab.num_points
    if not callable(source):
        return _leaf_tensor(source, X_geo).reshape(1, 1, solution_dim).expand(E, q, solution_dim)
    x = torch.einsum("qm,emd->eqd", _const(tab.geo_phi, X_geo), X_geo)

    def f(xp, p):  # a number is a constant source, as in the JAX package
        return torch.atleast_1d(torch.as_tensor(source(xp, p), dtype=xp.dtype, device=xp.device))

    if has_mapped_params(params, E, q):
        fvals = _vmap2(f, params, E, q)(x, params)
    else:
        fvals = vmap(lambda xp: f(xp, params))(x.reshape(E * q, -1))
    return fvals.to(X_geo.dtype).reshape(E, q, solution_dim)


def assemble_element_source_vectors(X_geo, source, params, solution_dim: int, tab: Tabulation):
    """Element source vectors ``b[e, (I,i)] = ∫ f(x)_i φ_I`` (source.rs:217).

    ``source`` is a pointwise torch callable ``f(x [d], params) -> [s]``,
    evaluated at the mapped quadrature points, or a constant ``[s]`` array.
    """
    J = jacobians(X_geo, tab.geo_dphi)
    _, detJ = inv_and_det(J)
    fvals = _source_values(X_geo, source, params, solution_dim, tab)
    b = torch.einsum("eq,eqs,qn->ens", _wdet(tab, detJ), fvals, _const(tab.phi, X_geo))
    return b.reshape(X_geo.shape[0], -1)


def assemble_element_surface_source_vectors(X_geo, source, params, solution_dim: int, tab: Tabulation):
    """Surface (traction, Neumann) load vectors ``b[e, (I,i)] = ∫_Γ t(x)_i φ_I``.

    :func:`assemble_element_source_vectors` on faces embedded in a space of
    higher dimension: ``X_geo [E, m, D]`` are face nodes (e.g. of
    ``mesh.boundary_mesh()``), ``tab`` tabulates the face element, and the
    weight is the generalised volume form sqrt(det(JᵀJ)).
    """
    from ..integrate import volume_form

    wvol = _const(tab.weights, X_geo)[None, :] * volume_form(jacobians(X_geo, tab.geo_dphi))
    fvals = _source_values(X_geo, source, params, solution_dim, tab)
    b = torch.einsum("eq,eqs,qn->ens", wvol, fvals, _const(tab.phi, X_geo))
    return b.reshape(X_geo.shape[0], -1)
