"""Element-minor local assembly: element sweeps with the element axis last.

Counterpart of ``fenris_tpu/assembly/local_em.py``: the same quantities as
:mod:`.local` in the element-minor layouts of the banded matrix-free path

* ``X_em``: ``[m, d, *batch]`` geometry node coordinates,
* ``u_em``/``v_em``: ``[n, s, *batch]`` local solution dofs,
* outputs: ``[n, s, *batch]`` (vectors, diagonals) or ``[*batch]`` (energies),

where ``*batch`` is usually the element axis ``E``.  The functions are the
plain versions of the fused element-sweep kernels (:mod:`..ops.em_sweep`).
Inside, each quadrature point is one pass of batched tensor code over the
element axis (a Python loop over points, no ``vmap``): the operator's
pointwise functions see ``[*batch, d, s]`` gradients.  A parameter leaf
whose trailing axes equal the batch's (an ``[E]`` leaf: one value an
element) maps with them through ``torch.func.vmap``, as the JAX package's
``_params_levels`` rule has it; other leaves are constants, and
per-point leaves are not taken on this path.  Only volumetric
(square-jacobian) elements.
"""

from __future__ import annotations

import numpy as np
import torch

from .local import Tabulation, _inv_det, map_params

__all__ = [
    "elliptic_vector_qp",
    "elliptic_vector_tangent_qp",
    "assemble_element_elliptic_vectors_em",
    "assemble_element_elliptic_tangent_vectors_em",
    "compute_element_elliptic_energy_em",
    "elliptic_matrix_diagonal_em",
    "params_to_element_minor",
]


def params_to_element_minor(params, E: int):
    """Move a leading per-element axis of each parameter leaf to the end.

    Leaves with ``ndim >= 2`` and a leading axis of length ``E`` move it
    last; scalars and 1-D leaves pass through unchanged (an ``[E]`` leaf is
    already per element on the element axis here).
    """
    if params is None:
        return None

    def conv(x):
        if isinstance(x, torch.Tensor) and x.ndim >= 2 and x.shape[0] == E:
            return torch.movedim(x, 0, -1)
        return x

    if isinstance(params, tuple):
        leaves = [conv(x) for x in params]
        return type(params)(*leaves) if hasattr(params, "_fields") else tuple(leaves)
    return conv(params)


def _tables(tab: Tabulation, like: torch.Tensor):
    """The rule's ``geo_dphi [q, m, d]``, ``dphi [q, n, d]`` as tensors, weights as floats."""
    gd = torch.as_tensor(np.asarray(tab.geo_dphi), dtype=like.dtype, device=like.device)
    dp = torch.as_tensor(np.asarray(tab.dphi), dtype=like.dtype, device=like.device)
    return gd, dp, [float(w) for w in tab.weights]


def _check_square(X_em, tab: Tabulation) -> None:
    if tab.geo_dphi.shape[2] != X_em.shape[1]:
        raise ValueError("element-minor assembly requires square jacobians")


def _qp_geometry(X_em, gd_q, dphi_q, w_q):
    """Physical basis gradients ``gp [n, d, *batch]`` and ``wdet [*batch]`` at one point.

    ``J[i, j] = Σ_m gd_q[m, j] X[m, i]``; ``gp[n, i] = Σ_k dphi_q[n, k] J⁻¹[k, i]``
    (``J⁻ᵀ ∇ξφ``); ``wdet = w_q |det J|``.  J is summed over coordinates
    relative to the element's first node: the columns of ``gd_q`` sum to
    zero, so J is the same, and in f32 the sum then keeps its digits when
    the coordinates are large against the element size.
    """
    J = torch.einsum("mj,mi...->ij...", gd_q, X_em - X_em[:1])
    Jinv, det = _inv_det(J)
    gp = torch.einsum("nk,ki...->ni...", dphi_q, Jinv)
    return gp, w_q * det.abs()


def _u_grad(gp, u_em):
    """``G[d, s, *batch] = Σ_n gp[n, d] u[n, s]``."""
    return torch.einsum("nd...,ns...->ds...", gp, u_em)


def _batch_last(G):
    """``[d, s, *batch]`` -> ``[*batch, d, s]`` (the operators' layout)."""
    return torch.movedim(G, (0, 1), (-2, -1))


def _batch_first(g):
    """``[*batch, d, s]`` -> ``[d, s, *batch]``."""
    return torch.movedim(g, (-2, -1), (0, 1))


def _pointwise(fn, params, X_em, *Gs):
    """``fn(*Gs, params)`` on ``[d, s, *batch]`` gradients, the result's matrix axes first."""
    return map_params(fn, params, X_em.shape[2:])(*(_batch_last(G) for G in Gs), params)


def elliptic_vector_qp(X_em, u_em, op, params, gd_q, dphi_q, w_q):
    """One quadrature point's weighted element-vector contribution ``[n, s, *batch]``."""
    gp, wdet = _qp_geometry(X_em, gd_q, dphi_q, w_q)
    gv = _batch_first(_pointwise(op.g, params, X_em, _u_grad(gp, u_em)))  # [d, s, *batch]
    return wdet * torch.einsum("nd...,ds...->ns...", gp, gv)


def elliptic_vector_tangent_qp(X_em, u_em, v_em, op, params, gd_q, dphi_q, w_q):
    """One quadrature point's weighted Hessian-action contribution ``[n, s, *batch]``.

    The directional derivative of :func:`elliptic_vector_qp` in ``v``,
    from the operator's closed-form ``g_tangent``.
    """
    gp, wdet = _qp_geometry(X_em, gd_q, dphi_q, w_q)
    dgv = _batch_first(_pointwise(op.g_tangent, params, X_em, _u_grad(gp, u_em), _u_grad(gp, v_em)))
    return wdet * torch.einsum("nd...,ds...->ns...", gp, dgv)


def assemble_element_elliptic_tangent_vectors_em(X_em, u_em, v_em, op, params, tab: Tabulation):
    """Element Hessian-action vectors ``(∂f_el/∂u)[v]``, ``[n, s, *batch]``.

    The plain version of :func:`..ops.em_sweep.em_vector_tangent_sweep`.
    """
    _check_square(X_em, tab)
    gd, dp, w = _tables(tab, X_em)
    out = torch.zeros_like(u_em)
    for q in range(tab.num_points):
        out = out + elliptic_vector_tangent_qp(X_em, u_em, v_em, op, params, gd[q], dp[q], w[q])
    return out


def assemble_element_elliptic_vectors_em(X_em, u_em, op, params, tab: Tabulation):
    """Element vectors ``[n, s, *batch]`` (elliptic.rs:457).

    The plain version of :func:`..ops.em_sweep.em_vector_sweep`.
    """
    _check_square(X_em, tab)
    gd, dp, w = _tables(tab, X_em)
    out = torch.zeros_like(u_em)
    for q in range(tab.num_points):
        out = out + elliptic_vector_qp(X_em, u_em, op, params, gd[q], dp[q], w[q])
    return out


def compute_element_elliptic_energy_em(X_em, u_em, op, params, tab: Tabulation):
    """Per-element energies ``[*batch]`` (elliptic.rs:551)."""
    _check_square(X_em, tab)
    gd, dp, w = _tables(tab, X_em)
    out = X_em.new_zeros(X_em.shape[2:])
    for q in range(tab.num_points):
        gp, wdet = _qp_geometry(X_em, gd[q], dp[q], w[q])
        out = out + wdet * _pointwise(op.energy, params, X_em, _u_grad(gp, u_em))
    return out


def elliptic_matrix_diagonal_em(X_em, u_em, op, params, tab: Tabulation):
    """Diagonal of the element matrices, ``[n, s, *batch]`` (elliptic.rs:361).

    ``diag[n, i] = Σ_q wdet Σ_{k,m} gp[n, k] D[k, i, m, i] gp[n, m]``: only
    the ``s`` diagonal slices of the contraction tensor are contracted.
    """
    _check_square(X_em, tab)
    gd, dp, w = _tables(tab, X_em)
    out = torch.zeros_like(u_em)
    for q in range(tab.num_points):
        gp, wdet = _qp_geometry(X_em, gd[q], dp[q], w[q])
        D = _pointwise(op.contraction, params, X_em, _u_grad(gp, u_em))  # [*batch, d, s, d, s]
        Dii = torch.diagonal(D, dim1=-3, dim2=-1)  # [*batch, d(k), d(m), s(i)]
        out = out + wdet * torch.einsum("nk...,...kmi,nm...->ni...", gp, Dii, gp)
    return out
