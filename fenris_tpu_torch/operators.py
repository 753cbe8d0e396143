"""PDE operator abstraction (elliptic operators, energies, contractions).

Counterpart of ``fenris_tpu/operators.py``.  An operator is a set of
functions of the solution gradient ``G = ∇u`` with shape ``[..., d, s]``:
any leading axes are batch axes (quadrature points, cells), so one call
evaluates a whole grid.  Derivatives default to ``torch.func`` autodiff,
applied point by point through ``torch.func.vmap``; closed forms override
them where they exist.

Contraction convention (as in the reference): ``D[k, i, m, j] =
∂g_ki/∂G_mj``, so ``C(G, a, b)[i, j] = a_k D[k, i, m, j] b_m``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.func import grad, jacfwd, jvp, vmap

__all__ = ["EllipticOperator", "LaplaceOperator", "operator_from_energy", "pointwise"]


def pointwise(fn: Callable, *mats: torch.Tensor) -> torch.Tensor:
    """Apply ``fn`` (defined on single ``[d, s]`` matrices) over leading axes."""
    batch = mats[0].shape[:-2]
    if not batch:
        return fn(*mats)
    flat = [m.reshape((-1,) + tuple(m.shape[-2:])) for m in mats]
    out = vmap(fn)(*flat)
    return out.reshape(tuple(batch) + tuple(out.shape[1:]))


class EllipticOperator:
    """Base class for elliptic operators ``-div g(∇u) = f``.

    Subclasses set :attr:`solution_dim` and implement :meth:`energy` or
    :meth:`g`.  Every method takes ``G`` of shape ``[..., d, s]``.
    """

    solution_dim: int = 1
    #: whether C(G, a, b) == C(G, b, a)^T for all inputs
    symmetric: bool = False
    #: whether the contraction tensor is independent of G (linear operators)
    constant_contraction: bool = False

    def energy(self, G, params):
        """Energy density ψ(G), one value per point. Optional."""
        raise NotImplementedError(f"{type(self).__name__} has no energy")

    def g(self, G, params):
        """The operator g(G), shape ``[..., d, s]``; defaults to ∂ψ/∂G."""
        return pointwise(grad(lambda Gm: self.energy(Gm, params)), G)

    def contraction(self, G, params):
        """``D[..., k, i, m, j] = ∂g_ki/∂G_mj``; defaults to forward-mode AD."""
        return pointwise(jacfwd(lambda Gm: self.g(Gm, params)), G)

    def g_tangent(self, G, dG, params):
        """Directional tangent ``dg[k, i] = D[k, i, m, j] dG[m, j]``.

        The Hessian-action workhorse; defaults to forward-mode AD of
        :meth:`g` (closed forms override it).
        """
        return jvp(lambda Gm: self.g(Gm, params), (G,), (dG,))[1]

    def has_energy(self) -> bool:
        """Whether :meth:`energy` is implemented (``operators.py:82``): it is tried on one zero gradient
        with ``params=None``; only ``NotImplementedError`` means no."""
        try:
            self.energy(torch.zeros((1, self.solution_dim), dtype=torch.float64), None)
            return True
        except NotImplementedError:
            return False
        except Exception:
            return True


class LaplaceOperator(EllipticOperator):
    """g(∇u) = ∇u; ψ = |∇u|²/2 (operators/laplace.rs:14)."""

    solution_dim = 1
    symmetric = True
    constant_contraction = True

    def energy(self, G, params):
        return 0.5 * (G * G).sum((-2, -1))

    def g(self, G, params):
        return G

    def contraction(self, G, params):
        d = G.shape[-2]
        eye = torch.eye(d, dtype=G.dtype, device=G.device)
        D = eye[:, None, :, None]  # δ_km with s = 1
        return D.expand(tuple(G.shape[:-2]) + tuple(D.shape))

    def g_tangent(self, G, dG, params):
        return dG


@dataclass
class operator_from_energy(EllipticOperator):
    """An energy density ``psi(G, params)`` as an operator: ``g`` and the contraction come from ``torch.func``."""

    psi: Callable[[Any, Any], Any]
    solution_dim: int = 1
    symmetric: bool = True

    def energy(self, G, params):
        return pointwise(lambda Gm: self.psi(Gm, params), G)
