"""Multi-process structured-grid elasticity: z-slabs of cells over the ranks.

Counterpart of ``fenris_tpu/parallel/structured.py``.  The cell planes of a
:class:`~..structured.StructuredHyperelasticModel` are split into
``ceil(ncz / world)``-plane slabs, one a rank; the slab count is padded to
the world size, and a padded plane is not swept at all (a rank past the
last cell plane adds zeros).  Each rank evaluates its slab on the node
planes it spans with the model's slab functions (``_forces_local``,
``_hvp_local``, ``_diag_local``: the plain element math, on the card too)
into a full node grid, and one ``all_reduce`` sums the grids, which also
adds the shared node plane between two slabs.  The displacement state is
replicated.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..optimize import newton_line_search
from ..structured import StructuredHyperelasticModel
from . import _Comm, _jacobi_cg

__all__ = ["StructuredShardedElasticity"]


def _slab_sweep(model: StructuredHyperelasticModel, local_fn, grids, z0: int, z1: int, out: torch.Tensor):
    """``out[:, z0 : z1 + 1] += local_fn(...)`` over cell planes ``[z0, z1)``, in the model's z-chunks."""
    step = int(model.z_chunk_planes) or max(z1 - z0, 1)
    for a in range(z0, z1, step):
        b = min(a + step, z1)
        out[:, a : b + 1] += local_fn(*(g[:, a : b + 1] for g in grids))
    return out


@dataclass(eq=False)
class StructuredShardedElasticity:
    """z-slab sharded view of a :class:`~..structured.StructuredHyperelasticModel` (replicated state)."""

    model: StructuredHyperelasticModel
    mesh: DeviceMesh

    def __post_init__(self):
        m = self.model
        self._comm = _Comm(self.mesh, m.device)
        n_dev, rank = self._comm.size, self._comm.rank
        ncz = m.cells[2]
        self.ncz_pad = -(-ncz // n_dev) * n_dev
        self.slab = self.ncz_pad // n_dev
        self.z0 = min(rank * self.slab, ncz)
        self.z1 = min(self.z0 + self.slab, ncz)
        self.num_dofs = m.num_dofs

    def _sharded_grid(self, local_fn, *flat):
        """The node grid ``[3, z, y, x]`` of ``local_fn`` summed over every rank's slab."""
        m = self.model
        grids = [m._grid(v) for v in flat]
        out = grids[0].new_zeros((3,) + m.node_shape)
        return self._comm.all_reduce(_slab_sweep(m, local_fn, grids, self.z0, self.z1, out))

    def internal_forces(self, u):
        return self.model._ungrid(self._sharded_grid(self.model._forces_local, u))

    def residual(self, u):
        m = self.model
        return torch.where(m.free_mask, self.internal_forces(u) - m._f_ext, 0.0)

    def hessian_vector_product(self, u, v):
        """Masked Hessian action: the closed-form tangent of each slab, then one ``all_reduce``."""
        m = self.model
        vm = torch.where(m.free_mask, v, 0.0)
        hv = m._ungrid(self._sharded_grid(m._hvp_local, u, vm))
        return torch.where(m.free_mask, hv, v)

    def hessian_diagonal(self, u):
        m = self.model
        diag = m._ungrid(self._sharded_grid(m._diag_local, u))
        return torch.where(m.free_mask & (diag != 0.0), diag, 1.0)

    def _jacobi_cg(self, u, f, rel_tolerance, max_iter):
        return _jacobi_cg(lambda v: self.hessian_vector_product(u, v), self.hessian_diagonal(u), f, rel_tolerance,
                          max_iter)

    def newton_step(self, u, cg_rel_tolerance=1e-5, cg_max_iter=200):
        """One inexact Newton step: ``(u - d, ||F(u)||)``."""
        f = self.residual(u)
        return u - self._jacobi_cg(u, f, cg_rel_tolerance, cg_max_iter).x, torch.linalg.vector_norm(f)

    def solve(self, u0=None, tolerance=1e-6, max_newton_iterations=30, cg_rel_tolerance=1e-5, cg_max_iter=1000,
              line_search=True):
        """Newton–Krylov solve with Jacobi-preconditioned CG, every operator sharded."""
        m = self.model
        if u0 is None:
            u0 = torch.zeros(self.num_dofs, dtype=m.dtype, device=m.device)
        return newton_line_search(
            self.residual,
            lambda u, f: self._jacobi_cg(u, f, cg_rel_tolerance, cg_max_iter).x,
            u0,
            tolerance=tolerance,
            max_iterations=max_newton_iterations,
            line_search=line_search,
        )
