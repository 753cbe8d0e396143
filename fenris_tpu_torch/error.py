"""A-posteriori error estimation against analytic solutions.

Counterpart of ``fenris_tpu/error.py`` (error.rs:117, :153, :313, :358):
element-wise and global L² and H¹-seminorm errors by high-order
quadrature, and the batched forms whose exact solution is evaluated on
all quadrature points at once.  Pointwise callables (``u_exact(x [d]) ->
[s]``) run under ``torch.func.vmap``; batched ones take ``points [M, d]``.

Every estimator walks the elements in chunks (:func:`.integrate.element_chunks`):
the MMS error rule has 216 points, and all their gradients on millions of
cells would not fit on the card.  Chunk sums are added in element order,
so two runs give bitwise-equal errors.
"""

from __future__ import annotations

from typing import Callable

import torch

from .assembly.local import Tabulation
from .integrate import element_chunks, integrate_over_elements, quadrature_fields

__all__ = [
    "estimate_element_L2_error_squared",
    "estimate_element_H1_seminorm_error_squared",
    "estimate_L2_error",
    "estimate_H1_seminorm_error",
    "estimate_L2_error_batched",
    "estimate_H1_seminorm_error_batched",
]


def estimate_element_L2_error_squared(X_geo, u_el, u_exact: Callable, tab: Tabulation):
    """Per-element ∫ |u_h - u|² with ``u_exact(x) -> [s]`` (error.rs:117)."""

    def f(x, u, G):
        diff = u - torch.atleast_1d(u_exact(x))
        return (diff * diff).sum()

    return integrate_over_elements(X_geo, u_el, f, tab, needs_gradient=False)


def estimate_element_H1_seminorm_error_squared(X_geo, u_el, u_exact_grad: Callable, tab: Tabulation):
    """Per-element ∫ |∇u_h - ∇u|²_F with ``u_exact_grad(x) -> [d, s]`` (error.rs:153)."""

    def f(x, u, G):
        diff = G - torch.as_tensor(u_exact_grad(x)).reshape(G.shape)
        return (diff * diff).sum()

    return integrate_over_elements(X_geo, u_el, f, tab, needs_gradient=True)


def _chunked_sum(X_geo, u_el, tab: Tabulation, term):
    """Sum over elements of ``term(X chunk, u chunk)``, chunk sums added in element order."""
    total = X_geo.new_zeros(())
    for c in element_chunks(X_geo.shape[0], tab):
        total = total + term(X_geo[c], u_el[c])
    return total


def estimate_L2_error_batched(X_geo, u_el, u_exact_batched: Callable, tab: Tabulation):
    """Global L² error with a batched exact solution ``u_exact_batched(points [M, d]) -> [M, s]``."""

    def term(X, ue):
        x, u, _, wv = quadrature_fields(X, ue, tab, needs_gradient=False)
        E, q, d = x.shape
        ux = torch.as_tensor(u_exact_batched(x.reshape(E * q, d))).reshape(E, q, -1)
        return (wv * ((u - ux) ** 2).sum(-1)).sum()

    return torch.sqrt(_chunked_sum(X_geo, u_el, tab, term))


def estimate_H1_seminorm_error_batched(X_geo, u_el, u_exact_grad_batched: Callable, tab: Tabulation):
    """Global H¹-seminorm error with a batched gradient ``u_exact_grad_batched(points [M, d]) -> [M, d, s]``."""

    def term(X, ue):
        x, _, G, wv = quadrature_fields(X, ue, tab, needs_gradient=True)
        E, q, d = x.shape
        gx = torch.as_tensor(u_exact_grad_batched(x.reshape(E * q, d))).reshape(G.shape)
        return (wv * ((G - gx) ** 2).sum((-1, -2))).sum()

    return torch.sqrt(_chunked_sum(X_geo, u_el, tab, term))


def estimate_L2_error(X_geo, u_el, u_exact: Callable, tab: Tabulation):
    """Global L² error (error.rs:313)."""
    return torch.sqrt(estimate_element_L2_error_squared(X_geo, u_el, u_exact, tab).sum())


def estimate_H1_seminorm_error(X_geo, u_el, u_exact_grad: Callable, tab: Tabulation):
    """Global H¹ seminorm error (error.rs:358)."""
    return torch.sqrt(estimate_element_H1_seminorm_error_squared(X_geo, u_el, u_exact_grad, tab).sum())
