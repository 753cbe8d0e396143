"""Quadrature-driven integration of functions over finite element spaces.

Counterpart of ``fenris_tpu/integrate.py`` (integrate.rs:20, :596, :708):
``volume_form``, ``integrate_over_elements`` and ``integrate``.  The
integrand is a pointwise torch callable ``f(x, u, grad_u)`` evaluated at
every (element, quadrature point) pair through ``torch.func.vmap``.

Elements are taken about ``2**22`` quadrature points' worth at a time
(whole elements, in order), so a high-order rule on millions of cells
never holds every point's gradients at once; the per-element integrals are concatenated in element order and
global sums are taken over them, so two runs give bitwise-equal results.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import vmap

from .assembly.local import Tabulation, _const, inv_and_det, jacobians, physical_gradients

__all__ = ["volume_form", "integrate_over_elements", "integrate"]

#: quadrature points evaluated at once (elements per chunk = this // points a rule)
_POINTS_PER_CHUNK = 2**22


def element_chunks(num_elements: int, tab: Tabulation):
    """Element slices in order, each about ``_POINTS_PER_CHUNK`` quadrature points' worth."""
    c = max(1, _POINTS_PER_CHUNK // tab.num_points)
    return [slice(e0, e0 + c) for e0 in range(0, max(num_elements, 1), c)]


def volume_form(J: torch.Tensor) -> torch.Tensor:
    """Generalised volume factor sqrt(det(JᵀJ)) of ``J [..., D, d]`` (integrate.rs:20).

    Non-square Jacobians belong to surface and curve elements embedded in
    a space of higher dimension; a square J gives |det J|.
    """
    if J.shape[-2] == J.shape[-1]:
        _, det = inv_and_det(J)
        return det.abs()
    _, det = inv_and_det(torch.einsum("...ki,...kj->...ij", J, J))
    return torch.sqrt(det)


def quadrature_fields(X_geo, u_el, tab: Tabulation, needs_gradient: bool):
    """Physical points ``x [E, q, D]``, ``u_h [E, q, s]``, ``∇u_h [E, q, D, s]`` and ``w·|det J| [E, q]``.

    ``u_h`` is None when ``u_el`` is, ``∇u_h`` unless ``needs_gradient``.
    """
    J = jacobians(X_geo, tab.geo_dphi)
    x = torch.einsum("qm,emd->eqd", _const(tab.geo_phi, X_geo), X_geo)
    u = G = None
    if u_el is not None:
        u = torch.einsum("qn,ens->eqs", _const(tab.phi, X_geo), u_el)
        if needs_gradient:
            Jinv, _ = inv_and_det(J)
            G = torch.einsum("eqnd,ens->eqds", physical_gradients(tab.dphi, Jinv), u_el)
    return x, u, G, _const(tab.weights, X_geo)[None, :] * volume_form(J)


def _element_integrals(X_geo, u_el, f: Callable, tab: Tabulation, needs_gradient: bool):
    """Per-element integrals of one chunk of elements."""
    x, u, G, wv = quadrature_fields(X_geo, u_el, tab, needs_gradient)
    E, q = wv.shape
    if u is None:
        u = X_geo.new_zeros((E, q, 0))
    if G is None:
        G = X_geo.new_zeros((E, q, 0, 0))
    fv = vmap(vmap(f))(x, u, G)
    return (wv.reshape(wv.shape + (1,) * (fv.dim() - 2)) * fv).sum(1)


def integrate_over_elements(X_geo, u_el, f: Callable, tab: Tabulation, needs_gradient: bool = True):
    """Per-element integrals of ``f(x, u, grad_u)`` (integrate.rs:596).

    ``X_geo``: ``[E, m, D]`` geometry node coordinates; ``u_el``: ``[E, n,
    s]`` local solution dofs or None.  ``f(x [D], u [s], G [D, s])`` is a
    pointwise torch function returning a scalar or a fixed-shape tensor
    (``u``/``G`` have zero size when ``u_el`` is None or the gradient is
    not asked for); returns the ``[E, ...]`` per-element integrals.
    """
    parts = [
        _element_integrals(X_geo[c], None if u_el is None else u_el[c], f, tab, needs_gradient)
        for c in element_chunks(X_geo.shape[0], tab)
    ]
    return parts[0] if len(parts) == 1 else torch.cat(parts, 0)


def integrate(X_geo, u_el, f: Callable, tab: Tabulation, needs_gradient: bool = True):
    """Global integral: the sum of :func:`integrate_over_elements`."""
    return integrate_over_elements(X_geo, u_el, f, tab, needs_gradient).sum(0)
