"""Manufactured solutions for nonlinear elasticity.

Counterpart of ``fenris_tpu/solid/mms.py``.  Pick a smooth displacement
``u_exact``, derive the body force ``f = -Div P(F(u_exact))`` by nested
forward-mode differentiation (``torch.func.jacfwd``) of the material's
first Piola-Kirchhoff stress, solve with that load, and measure the L2
error against ``u_exact``: it converges at the element order (O(h^2) in
L2 for hex8).  This extends the reference's linear-Poisson MMS method
(tests/convergence_tests/poisson_mms_common.rs:173) to the hyperelastic
operator.

Conventions are :mod:`fenris_tpu_torch.solid`'s: ``u_grad[i, j] = d u_j /
d x_i`` (so ``F = I + u_gradᵀ``), ``P = stress_du(u_grad)``, and the
strong form of the residual is ``-(Div P)_i = -sum_j dP_ij / dx_j = f_i``.
"""

from __future__ import annotations

import math

import torch
from torch.func import jacfwd

__all__ = ["manufactured_body_force", "sine_bubble_displacement"]


def manufactured_body_force(material, params, u_exact):
    """Body force for which ``u_exact`` solves the hyperelastic problem.

    Args:
        material: a :class:`~fenris_tpu_torch.solid.HyperelasticMaterial`.
        params: its parameters.
        u_exact: smooth displacement ``u(x [3]) -> [3]``, a torch function.

    Returns:
        ``body_force(x, p=None) -> [3]``, ``-Div P`` at ``x``: the
        ``body_force`` of a :class:`~fenris_tpu_torch.structured.StructuredHyperelasticModel`
        or :class:`~fenris_tpu_torch.elasticity.HyperelasticModel`.  With
        Dirichlet conditions from ``u_exact`` on the whole boundary, the
        discrete solution converges to ``u_exact`` at the element order.
    """

    def P(x):
        # jacfwd gives J[i, j] = d u_i / d x_j; u_grad is its transpose
        u_grad = jacfwd(u_exact)(x).transpose(-1, -2)
        return material.stress_du(u_grad, params)

    def body_force(x, p=None):
        dP = jacfwd(P)(x)  # [i, j, k] = d P_ij / d x_k
        return -torch.einsum("ijj->i", dP)

    return body_force


def sine_bubble_displacement(extent=1.0, amplitude=(0.03, -0.02, 0.04)):
    """Smooth displacement vanishing on the boundary of ``[0, extent]^3``.

    ``u_i(x) = a_i sin(pi x / L) sin(pi y / L) sin(pi z / L)``: zero on every
    face of the box, so a model clamping the whole boundary is consistent
    with it; distinct amplitudes exercise every stress component.
    """

    def u_exact(x):
        a = torch.tensor(amplitude, dtype=x.dtype, device=x.device)
        return a * torch.prod(torch.sin(math.pi * x / extent))

    return u_exact
