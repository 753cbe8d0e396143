"""Geometric multigrid preconditioning for structured-grid elasticity.

Counterpart of the structured part of ``fenris_tpu/multigrid.py``: a
matrix-free geometric V-cycle on the uniform hex grid, where every
transfer operator is slicing and averaging.

* levels: cell counts halved per level while even (at most 6 levels);
* level operators: rediscretized constant-coefficient linear elasticity
  (the u-independent small-strain Hessian), built once per model;
* smoother: damped Jacobi (symmetric pre/post sweeps);
* transfers: restriction R = Pᵀ and trilinear prolongation P;
* Dirichlet constraints masked at every level (restricted by injection).

The V-cycle runs in grid layout ``[s, z, y, x]``; only :meth:`__call__`
converts from and to flat dof vectors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

import torch

from .solid import LameParameters, LinearElasticMaterial

__all__ = ["StructuredMGPreconditioner"]


def _smooth_axis(a: torch.Tensor, axis: int) -> torch.Tensor:
    """[1/4, 1/2, 1/4] stencil along an axis with zero (Dirichlet) edges."""
    n = a.shape[axis]
    zero = torch.zeros_like(a.narrow(axis, 0, 1))
    lo = torch.cat([zero, a.narrow(axis, 0, n - 1)], dim=axis)
    hi = torch.cat([a.narrow(axis, 1, n - 1), zero], dim=axis)
    return 0.25 * lo + 0.5 * a + 0.25 * hi


def _restrict(v: torch.Tensor) -> torch.Tensor:
    """Galerkin restriction R = Pᵀ on a [s, z, y, x] node grid (fine -> coarse).

    Pᵀ of trilinear prolongation has per-axis weights [1/2, 1, 1/2]; fine
    grids have 2m + 1 nodes per axis, coarse nodes sit at even indices.
    """
    for axis in (1, 2, 3):
        v = 2.0 * _smooth_axis(v, axis)
    return v[:, ::2, ::2, ::2]


def _prolong_axis(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Linear interpolation doubling (m + 1 -> 2m + 1 nodes) along an axis."""
    n = a.shape[axis]
    left = a.narrow(axis, 0, n - 1)
    mid = 0.5 * (left + a.narrow(axis, 1, n - 1))
    # interleave: out[2i] = a[i], out[2i + 1] = mid[i]
    shape = list(a.shape)
    shape[axis] = 2 * (n - 1)
    inter = torch.stack([left, mid], dim=axis + 1).reshape(shape)
    return torch.cat([inter, a.narrow(axis, n - 1, 1)], dim=axis)


def _prolong(v: torch.Tensor) -> torch.Tensor:
    """Trilinear prolongation (coarse -> fine) on [s, z, y, x] node grids."""
    for axis in (1, 2, 3):
        v = _prolong_axis(v, axis)
    return v


@dataclass(eq=False)
class StructuredMGPreconditioner:
    """V-cycle preconditioner for a structured hyperelastic model.

    Args:
        model: a :class:`~.structured.StructuredHyperelasticModel` (grid
            geometry, Lamé parameters, Dirichlet mask, dtype and device).
        num_smooth: pre- and post-smoothing sweeps (damped Jacobi).
        omega: Jacobi damping.
        coarse_iters: Jacobi iterations at the coarsest level.
    """

    model: Any
    num_smooth: int = 2
    omega: float = 0.5
    coarse_iters: int = 40

    def __post_init__(self):
        from .structured import StructuredHyperelasticModel

        m = self.model
        params = LameParameters(mu=float(m.params.mu), lam=float(m.params.lam))
        cells = tuple(int(c) for c in m.cells)
        spacing = float(m.spacing)
        free = m.free_mask.reshape(m.node_shape + (3,))
        self.levels: List[dict] = []
        while True:
            lin = StructuredHyperelasticModel(
                cells=cells,
                spacing=spacing,
                material=LinearElasticMaterial(),
                params=params,
                dtype=m.dtype,
                device=m.device,
            )
            free_flat = free.reshape(-1)
            diag = lin.hessian_diagonal(torch.zeros(lin.num_dofs, dtype=m.dtype, device=m.device))
            diag = torch.where(free_flat, diag, 1.0)
            self.levels.append(
                dict(
                    model=lin,
                    free_grid=lin._grid(free_flat).contiguous(),
                    inv_diag_grid=lin._grid(1.0 / diag).contiguous(),
                )
            )
            if any(c % 2 or c < 4 for c in cells) or len(self.levels) >= 6:
                break
            cells = tuple(c // 2 for c in cells)
            spacing *= 2.0
            free = free[::2, ::2, ::2, :]  # injection of the constraint mask

    # -- level operations (grid layout) ---------------------------------------

    def _apply_g(self, lvl, vg):
        L = self.levels[lvl]
        vm = torch.where(L["free_grid"], vg, 0.0)
        # linear material: Hessian action == internal forces (u-independent)
        avg = L["model"]._forces_grid(vm)
        return torch.where(L["free_grid"], avg, vg)

    def _smooth_g(self, lvl, xg, bg, iters):
        L = self.levels[lvl]
        for _ in range(int(iters)):
            xg = xg + self.omega * L["inv_diag_grid"] * (bg - self._apply_g(lvl, xg))
        return xg

    def _vcycle_g(self, lvl, bg):
        xg = self._smooth_g(lvl, torch.zeros_like(bg), bg, self.num_smooth)
        if lvl == len(self.levels) - 1:
            return self._smooth_g(lvl, xg, bg, self.coarse_iters)
        rg = bg - self._apply_g(lvl, xg)
        r_c = torch.where(self.levels[lvl + 1]["free_grid"], _restrict(rg), 0.0)
        e_c = self._vcycle_g(lvl + 1, r_c)
        eg = torch.where(self.levels[lvl]["free_grid"], _prolong(e_c), 0.0)
        return self._smooth_g(lvl, xg + eg, bg, self.num_smooth)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        """Apply the V-cycle preconditioner: M^{-1} r."""
        m = self.levels[0]["model"]
        return m._ungrid(self._vcycle_g(0, m._grid(r)))
