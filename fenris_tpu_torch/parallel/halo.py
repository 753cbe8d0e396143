"""Sharded-state structured elasticity: z node-planes over the ranks, one halo plane each way.

Counterpart of ``fenris_tpu/parallel/halo.py``.  The node grid
``[3, nz, ny, nx]`` is split into ``zp = ceil(nz / world)`` node planes a
rank (z padded to ``zp * world``); every solver vector (u, residual, CG
directions, the Jacobi diagonal, external forces, the Dirichlet mask)
lives sharded, ``[3, zp, ny, nx]`` on each rank.  Rank ``d`` owns the cell
planes rooted at its node planes.  An operator application:

* takes one halo node plane from the rank above (its first plane; zeros
  on the last rank), for ``u`` and, in a Hessian action, for ``v`` in the
  same exchange;
* evaluates its cells with the model's slab functions (``_forces_local``,
  ``_hvp_local``, ``_diag_local``: the plain element math, on the card
  too), skipping padded cell planes;
* sends its partial top plane down to the rank above's plane 0.

Both exchanges are :meth:`~._Comm.neighbours`: one ``all_reduce`` of a
``[world, plane]`` buffer, where JAX takes one ``ppermute`` of a plane.
CG's inner products and norms and Newton's residual norms are scalar
``all_reduce``s (the private loops of :mod:`..sparse.cg` and
:mod:`..optimize` with the sharded ``dot`` and ``norm``), so the state
never gathers on one rank; :meth:`StructuredHaloElasticity.to_flat` gathers
it on request.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..optimize import NewtonResult, _newton_line_search
from ..sparse.cg import CgResult
from ..structured import StructuredHyperelasticModel
from . import _Comm, _jacobi_cg
from .structured import _slab_sweep

__all__ = ["StructuredHaloElasticity"]


@dataclass(eq=False)
class StructuredHaloElasticity:
    """Sharded-state z-slab view of a :class:`~..structured.StructuredHyperelasticModel`.

    Every public method takes and returns this rank's part ``[3, zp, ny,
    nx]`` of the padded node grid; :meth:`to_grid` and :meth:`to_flat`
    convert from and to the single model's flat node-major dof vectors.
    """

    model: StructuredHyperelasticModel
    mesh: DeviceMesh

    def __post_init__(self):
        m = self.model
        self._comm = _Comm(self.mesh, m.device)
        n_dev, rank = self._comm.size, self._comm.rank
        nz, ny, nx = m.node_shape
        self.n_dev = n_dev
        self.zp = -(-nz // n_dev)
        self.nz_pad = self.zp * n_dev
        self.grid_shape = (3, self.nz_pad, ny, nx)
        #: cell planes this rank sweeps (its node planes that root a real cell)
        self.cell_planes = max(0, min(self.zp, m.cells[2] - rank * self.zp))
        self.free_grid = self.to_grid(m.free_mask)
        self.f_ext_grid = self.to_grid(m._f_ext)
        self.num_dofs = m.num_dofs

    # -- layout ------------------------------------------------------------

    def to_grid(self, u_flat) -> torch.Tensor:
        """This rank's part ``[3, zp, ny, nx]`` of the padded node grid of a flat dof vector."""
        m = self.model
        g = m._grid(torch.as_tensor(u_flat, device=m.device))
        z0 = self._comm.rank * self.zp
        z1 = min(z0 + self.zp, m.node_shape[0])
        part = g.new_zeros((3, self.zp) + m.node_shape[1:])
        part[:, : max(z1 - z0, 0)] = g[:, z0:z1]
        return part

    def to_flat(self, ug) -> torch.Tensor:
        """The flat node-major dof vector of a sharded grid (gathered with one ``all_reduce``)."""
        m = self.model
        return m._ungrid(self._comm.gather_parts(ug.contiguous(), 1)[:, : m.node_shape[0]])

    def zeros(self) -> torch.Tensor:
        return torch.zeros((3, self.zp) + self.grid_shape[2:], dtype=self.model.dtype, device=self.model.device)

    # -- sharded assembly ------------------------------------------------------

    def _halo_apply(self, local_fn, *grids):
        """``local_fn(*windows [3, k + 1, ny, nx]) -> [3, k + 1, ny, nx]`` over this rank's cell planes,
        with one halo plane of each grid from above and the partial top plane sent back down."""
        zp = self.zp
        _, halos = self._comm.neighbours(torch.stack([g[:, 0] for g in grids]))
        windows = [torch.cat([g, h[:, None]], 1) for g, h in zip(grids, halos)]
        out = windows[0].new_zeros(windows[0].shape)
        _slab_sweep(self.model, local_fn, windows, 0, self.cell_planes, out)
        carry, _ = self._comm.neighbours(out[:, zp])
        owned = out[:, :zp]
        owned[:, 0] += carry
        return owned

    def internal_forces(self, ug):
        return self._halo_apply(self.model._forces_local, ug)

    def residual(self, ug):
        return torch.where(self.free_grid, self.internal_forces(ug) - self.f_ext_grid, 0.0)

    def hessian_vector_product(self, ug, vg):
        """Masked Hessian action: the closed-form tangent of the rank's cells, ``u`` and ``v`` halos together."""
        vm = torch.where(self.free_grid, vg, 0.0)
        hv = self._halo_apply(self.model._hvp_local, ug, vm)
        return torch.where(self.free_grid, hv, vg)

    def hessian_diagonal(self, ug):
        diag = self._halo_apply(self.model._diag_local, ug)
        return torch.where(self.free_grid & (diag != 0.0), diag, 1.0)

    # -- solve -----------------------------------------------------------------

    def _float_norm(self, v) -> float:
        return float(self._comm.norm(v))

    def _jacobi_cg(self, ug, fg, rel_tolerance, max_iter) -> CgResult:
        return _jacobi_cg(lambda vg: self.hessian_vector_product(ug, vg), self.hessian_diagonal(ug), fg,
                          rel_tolerance, max_iter, self._comm)

    def solve(self, u0=None, tolerance: float = 1e-6, max_newton_iterations: int = 30,
              cg_rel_tolerance: float = 1e-5, cg_max_iter: int = 1000, line_search: bool = True) -> NewtonResult:
        """Newton–Krylov solve entirely on sharded state; ``x`` of the result is this rank's grid part."""
        if u0 is None:
            u0 = self.zeros()
        return _newton_line_search(
            self.residual,
            lambda ug, fg: self._jacobi_cg(ug, fg, cg_rel_tolerance, cg_max_iter).x,
            u0, tolerance, max_newton_iterations, line_search, 1e-4, 14, None, self._comm.dot, self._float_norm,
        )

    def newton_step(self, ug, cg_rel_tolerance=1e-5, cg_max_iter=200):
        """One inexact Newton step on sharded state: ``(ug - d, ||F(ug)||)``."""
        fg = self.residual(ug)
        return ug - self._jacobi_cg(ug, fg, cg_rel_tolerance, cg_max_iter).x, self._comm.norm(fg)
