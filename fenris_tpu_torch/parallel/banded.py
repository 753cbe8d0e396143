"""Multi-process banded execution: runs of the banded plan's owner blocks over the ranks.

Counterpart of ``fenris_tpu/parallel/banded.py``.  A banded plan
(:mod:`..ops.banded`) sorts the elements by the owned node range of their
smallest node, which makes a ready-made 1-D domain decomposition: rank
``d`` takes the ``ceil(K / world)`` consecutive owner blocks
``[d*Kd, (d+1)*Kd)`` of the model's plan.  The JAX package slices each
device's window out of the TPU's 128-node window blocking (``a_loc``,
``b_loc``, ``na_pad``), which the port does not carry; here each rank
builds its own plan over its node window instead:

* the window is the node range from its first block's owned range,
  ``n0 = d*Kd*r_nodes``, to the last node its elements touch;
* the rank's elements, renumbered into the window, make a banded
  :class:`~..elasticity.HyperelasticModel` of their own (the model's
  material, rule, chunking and ``fused_kernels``, the plan's
  ``r_nodes``, without Dirichlet conditions or loads), whose plan is
  built over the window: its blocks are the model plan's blocks
  ``[d*Kd, (d+1)*Kd)``, holding their elements in the same order;
  per-element parameter leaves go with their elements, and the rank's
  model pads them with its blocks;
* an operator application slices the window out of the replicated state,
  runs the rank's model on it (on a CUDA f32 model the banded gather,
  fused sweeps and scatter kernels of the single model; their plain
  versions elsewhere), places the window's partial forces into the
  global vector and sums the ranks' vectors with one ``all_reduce``.

A Hessian action is the rank model's own (the fused tangent sweep, or the
jvp of its forces) on the window, then one ``all_reduce``.  The values are
the single banded model's to roundoff: a node whose elements all lie in
one rank's blocks sums its rows in the single plan's order, bit for bit;
a node on two ranks' blocks adds the two ranks' sums.
The Jacobi diagonal of :meth:`ShardedBandedElasticity.solve` is the
model's own, replicated, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..elasticity import HyperelasticModel
from ..mesh import Mesh
from ..optimize import newton_line_search
from . import _Comm, _jacobi_cg

__all__ = ["ShardedBandedElasticity"]


@dataclass(eq=False)
class ShardedBandedElasticity:
    """Owner-block sharded view of a ``HyperelasticModel(banded=True)``.

    Replicated-in, replicated-out ``internal_forces``, ``residual``,
    ``hessian_vector_product`` and ``solve``.  ``local_model`` is this
    rank's model over its node window ``[window_start, window_end)``
    (None for a rank past the last block).  ``axis`` is the mesh dimension
    the blocks are sharded over, as in the JAX package.
    """

    model: HyperelasticModel
    mesh: DeviceMesh
    axis: str = "dp"

    def __post_init__(self):
        m = self.model
        if m._plan is None:
            raise ValueError("model must be constructed with banded=True")
        plan = m._plan
        self._comm = _Comm(self.mesh, m.device, self.axis)
        self.n_dev, rank = self._comm.size, self._comm.rank
        K = plan.k_blocks
        self.Kd = -(-K // self.n_dev)
        self.K_pad = self.Kd * self.n_dev
        k0, k1 = min(rank * self.Kd, K), min((rank + 1) * self.Kd, K)
        starts = np.concatenate([[0], np.cumsum(plan.counts)])
        elements = plan.perm[starts[k0] : starts[k1]]  # mesh ids, in the plan's order
        self.num_dofs = m.space.num_dofs
        self.local_model = None
        self.window_start = self.window_end = 0
        if len(elements) == 0:
            return
        cells = m.mesh.cells[elements]
        n0, n1 = k0 * plan.r_nodes, int(cells.max()) + 1
        self.window_start, self.window_end = n0, n1
        self.local_model = HyperelasticModel(
            mesh=Mesh(m.mesh.points[n0:n1], cells - n0, m.mesh.element),
            material=m.material,
            params=m._params_at(torch.as_tensor(elements, device=m.device)),
            rule=m.rule,
            dtype=m.dtype,
            device=m.device,
            chunk_size=m.chunk_size,
            banded=True,
            banded_r_nodes=plan.r_nodes,
            fused_kernels=m.fused_kernels,
        )

    # -- the rank's window ------------------------------------------------------

    def _window(self, u):
        """The window's slice of a flat dof vector, in a fresh allocation (the kernels' alignment)."""
        s = self.model.mesh.dim
        return u[self.window_start * s : self.window_end * s].clone()

    def _place(self, f_window):
        """A window's partial vector placed into a zero global dof vector."""
        s = self.model.mesh.dim
        return F.pad(f_window, (self.window_start * s, self.num_dofs - self.window_end * s))

    def _reduce(self, local_fn, *flat):
        """``local_fn`` on this rank's window of each vector, summed over the ranks."""
        if self.local_model is None:
            part = flat[0].new_zeros(self.num_dofs)
        else:
            part = self._place(local_fn(*(self._window(v) for v in flat)))
        return self._comm.all_reduce(part.contiguous())

    # -- sharded operators -------------------------------------------------------

    def internal_forces(self, u):
        return self._reduce(lambda uw: self.local_model.internal_forces(uw), u)

    def residual(self, u):
        m = self.model
        return torch.where(m.free_mask, self.internal_forces(u) - m._f_ext, 0.0)

    def hessian_vector_product(self, u, v):
        """Masked Hessian action: the rank model's (no Dirichlet dofs there) on its window, then one ``all_reduce``."""
        m = self.model
        vm = torch.where(m.free_mask, v, 0.0)
        hv = self._reduce(lambda uw, vw: self.local_model.hessian_vector_product(uw, vw), u, vm)
        return torch.where(m.free_mask, hv, v)

    def solve(self, u0=None, tolerance: float = 1e-8, max_newton_iterations: int = 30,
              cg_rel_tolerance: float = 1e-6, cg_max_iter: int = 2000, line_search: bool = True):
        """Newton–Krylov solve: CG on the sharded Hessian action, Jacobi from the model's (replicated) diagonal."""
        m = self.model
        if u0 is None:
            u0 = torch.zeros(self.num_dofs, dtype=m.dtype, device=m.device)

        def solve_jacobian(u, f):
            return _jacobi_cg(lambda v: self.hessian_vector_product(u, v), m.hessian_diagonal(u), f,
                              cg_rel_tolerance, cg_max_iter).x

        return newton_line_search(
            self.residual, solve_jacobian, u0, tolerance=tolerance, max_iterations=max_newton_iterations,
            line_search=line_search,
        )
