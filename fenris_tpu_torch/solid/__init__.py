"""Solid mechanics: hyperelastic materials and their elliptic operators.

Counterpart of ``fenris_tpu/solid/__init__.py`` (reference: fenris-solid
lib.rs / materials.rs).  Materials are functions of the displacement
gradient ``u_grad = ∇u`` with shape ``[..., d, d]`` (leading axes are
batch axes) and a :class:`LameParameters` pair.  The shipped materials
carry closed-form stress, contraction tensor and stress tangent; a custom
material implements ``energy_density_du`` and gets the rest from
``torch.func``.

Conventions (lib.rs:20-41): ``F = I + (∇u)ᵀ``; the elliptic operator is
``g(G) = P(F)ᵀ``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
from torch.func import grad, jacfwd, jvp

from ..operators import EllipticOperator, pointwise

__all__ = [
    "LameParameters",
    "lame_from_young_poisson",
    "HyperelasticMaterial",
    "LinearElasticMaterial",
    "NeoHookeanMaterial",
    "StVKMaterial",
    "MaterialEllipticOperator",
    "GravitySource",
    "log_det_F",
    "deformation_gradient",
]


class LameParameters(NamedTuple):
    """Lamé parameters (materials.rs:9)."""

    mu: Any
    lam: Any


def lame_from_young_poisson(young, poisson) -> LameParameters:
    """Young's modulus / Poisson ratio -> Lamé (materials.rs:31-43)."""
    mu = 0.5 * young / (1.0 + poisson)
    lam = 2.0 * mu * poisson / (1.0 - 2.0 * poisson)
    return LameParameters(mu=mu, lam=lam)


def _eye(d, like):
    return torch.eye(d, dtype=like.dtype, device=like.device)


def _t(a):
    return a.transpose(-1, -2)


def _trace(a):
    return torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)


def deformation_gradient(u_grad):
    """F = I + (∇u)ᵀ (lib.rs:20-29)."""
    return _eye(u_grad.shape[-1], u_grad) + _t(u_grad)


def _inv_and_det(J):
    """Closed-form inverse and determinant of ``[..., d, d]``, d in {1, 2, 3}."""
    d = J.shape[-1]
    if d == 1:
        det = J[..., 0, 0]
        return (1.0 / det)[..., None, None], det
    if d == 2:
        det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
        adj = torch.stack(
            [
                torch.stack([J[..., 1, 1], -J[..., 0, 1]], -1),
                torch.stack([-J[..., 1, 0], J[..., 0, 0]], -1),
            ],
            -2,
        )
        return adj / det[..., None, None], det
    if d == 3:
        a = J
        adj = torch.stack(
            [
                torch.stack(
                    [
                        a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1],
                        a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2],
                        a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1],
                    ],
                    -1,
                ),
                torch.stack(
                    [
                        a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2],
                        a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0],
                        a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2],
                    ],
                    -1,
                ),
                torch.stack(
                    [
                        a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0],
                        a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1],
                        a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0],
                    ],
                    -1,
                ),
            ],
            -2,
        )
        det = (
            a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
            - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
            + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0])
        )
        return adj / det[..., None, None], det
    raise ValueError(f"unsupported dimension {d}")


def log_det_F(du_dX):
    """log(det(I + du_dX)) computed stably via log1p (logdet.rs:17).

    Expands det(I + U) = 1 + γ symbolically so small strains keep their
    precision.  Returns -inf for non-positive J (the energy is then +inf,
    a barrier for the line search).
    """
    d = du_dX.shape[-1]
    U = du_dX
    if d == 1:
        gamma = U[..., 0, 0]
    elif d == 2:
        gamma = U[..., 0, 0] * U[..., 1, 1] + U[..., 0, 0] + U[..., 1, 1] - U[..., 0, 1] * U[..., 1, 0]
    elif d == 3:
        a, b, c = U[..., 0, 0], U[..., 0, 1], U[..., 0, 2]
        dd, e, f = U[..., 1, 0], U[..., 1, 1], U[..., 1, 2]
        g, h, i = U[..., 2, 0], U[..., 2, 1], U[..., 2, 2]
        # det(I + U) = 1 + tr(U) + (2x2 principal minors) + det(U)
        gamma = (
            (a + e + i)
            + (a * e - b * dd + a * i - c * g + e * i - f * h)
            + (a * (e * i - f * h) - b * (dd * i - f * g) + c * (dd * h - e * g))
        )
    else:
        raise ValueError("physical dimension must be 1, 2 or 3")
    return torch.where(
        gamma > -1.0,
        torch.log1p(torch.clamp(gamma, min=-1.0 + 1e-300)),
        torch.full_like(gamma, -torch.inf),
    )


class HyperelasticMaterial:
    """Base class. Implement ``energy_density_du``; derivatives default to AD."""

    #: stress is linear in ∇u (constant contraction tensor)
    linear_stress: bool = False

    def energy_density_du(self, u_grad, params):
        raise NotImplementedError

    def stress_du(self, u_grad, params):
        """First Piola-Kirchhoff stress P = (∂ψ/∂∇u)ᵀ; default autodiff."""
        dpsi = pointwise(grad(lambda G: self.energy_density_du(G, params)), u_grad)
        return _t(dpsi)

    def stress_contraction_tensor_du(self, u_grad, params):
        """A[..., i, k, j, m] = ∂P_ik/∂F_jm at F(∇u); default autodiff."""
        d = u_grad.shape[-1]

        def P_of_F(F):
            return self.stress_du(_t(F) - _eye(d, F), params)

        return pointwise(jacfwd(P_of_F), deformation_gradient(u_grad))

    def stress_tangent_du(self, u_grad, du_grad, params):
        """Directional stress tangent dP = (∂P/∂F)[dF], dF = (δ∇u)ᵀ; default AD."""
        return jvp(lambda G: self.stress_du(G, params), (u_grad,), (du_grad,))[1]

    # -- functions of F (lib.rs:143) ---------------------------------------------------------

    def energy_density(self, F, params):
        """ψ(F): :meth:`energy_density_du` at ``∇u = Fᵀ - I``."""
        return self.energy_density_du(_t(F) - _eye(F.shape[-1], F), params)

    def stress(self, F, params):
        """P(F): :meth:`stress_du` at ``∇u = Fᵀ - I``."""
        return self.stress_du(_t(F) - _eye(F.shape[-1], F), params)

    def stress_contraction(self, F, a, b, params):
        """``C_P(F, a, b)[i, j] = a_k (∂P_ik/∂F_jm) b_m`` (lib.rs:143); leading axes are batch axes."""
        A = self.stress_contraction_tensor_du(_t(F) - _eye(F.shape[-1], F), params)
        return torch.einsum("...k,...ikjm,...m->...ij", a, A, b)


class LinearElasticMaterial(HyperelasticMaterial):
    """ψ = μ ε:ε + λ/2 tr²(ε), ε = sym(∇u) (materials.rs:68)."""

    linear_stress = True

    def energy_density_du(self, u_grad, params):
        mu, lam = params.mu, params.lam
        du_dX = _t(u_grad)
        eps = 0.5 * (du_dX + _t(du_dX))
        return mu * (eps * eps).sum((-2, -1)) + 0.5 * lam * _trace(eps) ** 2

    def stress_du(self, u_grad, params):
        mu, lam = params.mu, params.lam
        du_dX = _t(u_grad)
        eps = 0.5 * (du_dX + _t(du_dX))
        eye = _eye(u_grad.shape[-1], u_grad)
        return 2.0 * mu * eps + lam * _trace(eps)[..., None, None] * eye

    def stress_contraction_tensor_du(self, u_grad, params):
        mu, lam = params.mu, params.lam
        delta = _eye(u_grad.shape[-1], u_grad)
        # μ δ_km δ_ij + μ δ_im δ_jk + λ δ_ik δ_jm
        A = (
            mu * torch.einsum("km,ij->ikjm", delta, delta)
            + mu * torch.einsum("im,jk->ikjm", delta, delta)
            + lam * torch.einsum("ik,jm->ikjm", delta, delta)
        )
        return A.expand(tuple(u_grad.shape[:-2]) + tuple(A.shape))

    def stress_tangent_du(self, u_grad, du_grad, params):
        # dP = 2μ dε + λ tr(dε) I — independent of u
        mu, lam = params.mu, params.lam
        ddu = _t(du_grad)
        deps = 0.5 * (ddu + _t(ddu))
        eye = _eye(u_grad.shape[-1], u_grad)
        return 2.0 * mu * deps + lam * _trace(deps)[..., None, None] * eye


class NeoHookeanMaterial(HyperelasticMaterial):
    """ψ = μ/2 (I_C - d) - μ log J + λ/2 log²J (materials.rs:125-232),
    in the small-strain-stable form of materials.rs:246-259."""

    def energy_density_du(self, u_grad, params):
        mu, lam = params.mu, params.lam
        du_dX = _t(u_grad)
        logJ = log_det_F(du_dX)
        tr_E = _trace(du_dX) + 0.5 * (du_dX * du_dX).sum((-2, -1))
        return torch.where(
            torch.isfinite(logJ),
            mu * tr_E - mu * logJ + 0.5 * lam * logJ**2,
            torch.full_like(logJ, torch.inf),
        )

    def stress_du(self, u_grad, params):
        mu, lam = params.mu, params.lam
        F = deformation_gradient(u_grad)
        logJ = log_det_F(_t(u_grad))
        Finv, _ = _inv_and_det(F)
        return (-mu + lam * logJ)[..., None, None] * _t(Finv) + mu * F

    def stress_contraction_tensor_du(self, u_grad, params):
        mu, lam = params.mu, params.lam
        F = deformation_gradient(u_grad)
        logJ = log_det_F(_t(u_grad))
        Finv, _ = _inv_and_det(F)
        FinvT = _t(Finv)
        alpha = (-mu + lam * logJ)[..., None, None, None, None]
        delta = _eye(u_grad.shape[-1], u_grad)
        # A[i,k,j,m] = λ F̂_ik F̂_jm - α F̂_im F̂_jk + μ δ_km δ_ij, F̂ = F^{-T}
        return (
            lam * torch.einsum("...ik,...jm->...ikjm", FinvT, FinvT)
            - alpha * torch.einsum("...im,...jk->...ikjm", FinvT, FinvT)
            + mu * torch.einsum("km,ij->ikjm", delta, delta)
        )

    def stress_tangent_du(self, u_grad, du_grad, params):
        """dP = μ dF + λ tr(F⁻¹dF) F⁻ᵀ − α F⁻ᵀ dFᵀ F⁻ᵀ,  α = −μ + λ log J."""
        mu, lam = params.mu, params.lam
        F = deformation_gradient(u_grad)
        dF = _t(du_grad)
        logJ = log_det_F(_t(u_grad))
        Finv, _ = _inv_and_det(F)
        FinvT = _t(Finv)
        alpha = -mu + lam * logJ
        dlogJ = torch.einsum("...ij,...ji->...", Finv, dF)
        dFinvT = -torch.einsum("...ik,...lk,...lj->...ij", FinvT, dF, FinvT)
        return (
            mu * dF
            + (lam * dlogJ)[..., None, None] * FinvT
            + alpha[..., None, None] * dFinvT
        )


class StVKMaterial(HyperelasticMaterial):
    """Saint Venant-Kirchhoff: ψ = μ E:E + λ/2 tr²E, E = (FᵀF - I)/2 (materials.rs:375)."""

    @staticmethod
    def _green(F):
        return 0.5 * (torch.einsum("...ki,...kj->...ij", F, F) - _eye(F.shape[-1], F))

    def energy_density_du(self, u_grad, params):
        mu, lam = params.mu, params.lam
        E = self._green(deformation_gradient(u_grad))
        return mu * (E * E).sum((-2, -1)) + 0.5 * lam * _trace(E) ** 2

    def stress_du(self, u_grad, params):
        mu, lam = params.mu, params.lam
        F = deformation_gradient(u_grad)
        E = self._green(F)
        S = 2.0 * mu * E + lam * _trace(E)[..., None, None] * _eye(F.shape[-1], F)
        return F @ S

    def stress_contraction_tensor_du(self, u_grad, params):
        mu, lam = params.mu, params.lam
        F = deformation_gradient(u_grad)
        E = self._green(F)
        delta = _eye(u_grad.shape[-1], u_grad)
        FFt = torch.einsum("...ik,...jk->...ij", F, F)
        trE = _trace(E)[..., None, None, None, None]
        DD = torch.einsum("km,ij->ikjm", delta, delta)
        return (
            2.0 * mu * torch.einsum("...km,ij->...ikjm", E, delta)
            + lam * trE * DD
            + mu * torch.einsum("...im,...jk->...ikjm", F, F)
            + lam * torch.einsum("...ik,...jm->...ikjm", F, F)
            + mu * torch.einsum("km,...ij->...ikjm", delta, FFt)
        )

    def stress_tangent_du(self, u_grad, du_grad, params):
        # P = F S  ⇒  dP = dF S + F dS,  dE = sym(Fᵀ dF), dS = 2μ dE + λ tr(dE) I
        mu, lam = params.mu, params.lam
        F = deformation_gradient(u_grad)
        dF = _t(du_grad)
        eye = _eye(u_grad.shape[-1], u_grad)
        E = self._green(F)
        FtdF = _t(F) @ dF
        dE = 0.5 * (FtdF + _t(FtdF))
        S = 2.0 * mu * E + lam * _trace(E)[..., None, None] * eye
        dS = 2.0 * mu * dE + lam * _trace(dE)[..., None, None] * eye
        return dF @ S + F @ dS


@dataclass
class MaterialEllipticOperator(EllipticOperator):
    """Adapt a hyperelastic material to the elliptic operator interface.

    Parity: fenris-solid/src/lib.rs:412-509 — energy = ψ, g(∇u) = P(F)ᵀ;
    the contraction tensor D[k,i,m,j] = ∂g_ki/∂G_mj equals A[i,k,j,m].
    """

    material: HyperelasticMaterial
    dim: int = 3
    symmetric: bool = True

    def __post_init__(self):
        self.solution_dim = self.dim
        self.constant_contraction = bool(getattr(self.material, "linear_stress", False))

    def energy(self, G, params):
        return self.material.energy_density_du(G, params)

    def g(self, G, params):
        return _t(self.material.stress_du(G, params))

    def contraction(self, G, params):
        A = self.material.stress_contraction_tensor_du(G, params)
        # D[..., k, i, m, j] = A[..., i, k, j, m]
        return A.transpose(-4, -3).transpose(-2, -1)

    def g_tangent(self, G, dG, params):
        return _t(self.material.stress_tangent_du(G, dG, params))


@dataclass
class GravitySource:
    """Body-force source f(x) = ρ g (gravity_source.rs:23), pointwise in ``x [3]``."""

    g_vector: Any
    density: float = 1.0

    def __call__(self, x, params):
        rho = params if params is not None else self.density
        return rho * torch.as_tensor(self.g_vector, dtype=x.dtype, device=x.device)
