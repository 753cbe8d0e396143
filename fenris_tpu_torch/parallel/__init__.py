"""Multi-process execution over ``torch.distributed``: element-sharded assembly.

Counterpart of ``fenris_tpu/parallel/__init__.py``.  A device mesh is a 1-D
``torch.distributed.device_mesh.DeviceMesh`` (its dim named ``"dp"`` unless
the caller names it otherwise) over the process group the caller has
initialised (:func:`make_device_mesh`), one rank a process; the sharded
classes run in every rank alike.

* **Elements are sharded** over the ranks (:class:`ShardedElasticity`): each
  rank sweeps its own run of elements, and the global dof vector is
  replicated.  The element count is padded to a multiple of the world size
  with masked copies of element 0, as the JAX package pads.
* **One** ``all_reduce`` **per sweep** sums the ranks' partial forces,
  diagonals or energies; the Newton and CG state stays replicated.
* **Collectives are not differentiated.**  ``torch.func.jvp`` cannot pass
  through ``all_reduce``, where JAX takes ``jax.jvp`` through ``psum``; a
  Hessian action takes the jvp of the rank's partial forces and reduces the
  tangent.  The reduction is linear, so the result is the same.
* **Only** ``all_reduce`` **is used**, also for the neighbour exchange of the
  halo and block-DIA classes (:meth:`_Comm.neighbours`): gloo takes
  CUDA tensors in ``all_reduce`` and ``broadcast`` only, and NCCL refuses
  two ranks on one card, so this form runs on gloo (CPU and CUDA tensors)
  and on NCCL alike.

Each rank computes on its model's device; the mesh's device type must be
that device's type.  Nothing falls back to the CPU, and a failed collective
raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..assembly.global_ import scatter_add_rows, scatter_plan
from ..assembly.local import (
    assemble_element_elliptic_vectors,
    compute_element_elliptic_energy,
    slice_params,
)
from ..assembly.local_em import elliptic_matrix_diagonal_em
from ..config import resolve_device
from ..elasticity import HyperelasticModel
from ..optimize import newton_line_search
from ..sparse.cg import CgResult, _dot, _norm, _pcg

__all__ = ["make_device_mesh", "ShardedElasticity"]


def make_device_mesh(num_devices: Optional[int] = None, axis: str = "dp", device_type: str = "cuda") -> DeviceMesh:
    """The 1-D mesh ``(axis,)`` over the initialised default process group.

    ``num_devices`` must be None or the world size; ``axis`` names the
    mesh's one dimension, as in the JAX package.  With ``device_type``
    ``"cuda"`` (the default) the process's current card becomes
    ``rank % device_count``, so two ranks on a one-card machine share
    ``cuda:0``; raises without a card.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh: initialise the process group first "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if num_devices not in (None, world):
        raise ValueError(f"make_device_mesh: the mesh spans the whole world of {world} ranks, not {num_devices}")
    if device_type == "cuda":
        resolve_device("cuda")
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


class _Comm:
    """The rank's view of a 1-D mesh's group (its dimension ``axis``, a name or 0): its rank, the world size
    and the reductions the sharded classes run.  With ``timed`` set, every collective waits for the card before
    and after it and adds its seconds to ``seconds`` (``calls`` counts them either way)."""

    def __init__(self, mesh: DeviceMesh, device: torch.device, axis=0):
        if mesh.ndim != 1 or mesh.device_type != device.type:
            raise ValueError(
                f"sharding a model on {device} needs a 1-D mesh of device type {device.type!r}, got {mesh}"
            )
        self.group = mesh.get_group(axis)
        self.rank = mesh.get_local_rank(axis)
        self.size = mesh.size()
        self.device = device
        self.timed = False
        self.calls = 0
        self.seconds = 0.0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place (``t`` must be contiguous)."""
        self.calls += 1
        if not self.timed:
            dist.all_reduce(t, group=self.group)
            return t
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        dist.all_reduce(t, group=self.group)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds += time.perf_counter() - t0
        return t

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The inner product of two sharded vectors (0-d)."""
        return self.all_reduce(torch.dot(a.reshape(-1), b.reshape(-1)).reshape(1))[0]

    def norm(self, v: torch.Tensor) -> torch.Tensor:
        """The 2-norm of a sharded vector (0-d)."""
        return torch.sqrt(self.dot(v, v))

    def neighbours(self, part: torch.Tensor):
        """``(part of rank - 1, part of rank + 1)``, zeros where there is no such rank (an open chain).

        One ``all_reduce`` of a zeroed ``[world, *part.shape]`` buffer in
        which each rank fills its own slot: exact, since every sum adds
        zeros, at ``world`` parts of traffic instead of one.
        """
        buf = part.new_zeros((self.size,) + tuple(part.shape))
        buf[self.rank] = part
        self.all_reduce(buf)
        zeros = torch.zeros_like(part)
        below = buf[self.rank - 1] if self.rank > 0 else zeros
        above = buf[self.rank + 1] if self.rank + 1 < self.size else zeros
        return below, above

    def gather_parts(self, part: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's equal-sized ``part`` joined along ``dim`` in rank order (replicated)."""
        k = part.shape[dim]
        shape = list(part.shape)
        shape[dim] = k * self.size
        buf = part.new_zeros(shape)
        buf.narrow(dim, self.rank * k, k).copy_(part)
        return self.all_reduce(buf)


def _jacobi_cg(hvp, diag, f, rel_tolerance, max_iter, comm: Optional[_Comm] = None) -> CgResult:
    """CG on ``hvp`` preconditioned by ``1 / diag`` from zero (no definiteness checks, as the JAX classes
    run it); with ``comm``, on sharded vectors, whose inner products and norms it reduces."""
    inv_diag = 1.0 / diag
    dot, norm = (comm.dot, comm.norm) if comm is not None else (_dot, _norm)
    return _pcg(hvp, f, lambda v: inv_diag * v, rel_tolerance, max_iter, False, None, dot, norm)


def _pad_to_multiple(E: int, multiple: int):
    """Element ids padded to a multiple of ``multiple`` with copies of element 0, and the 1/0 validity."""
    pad = (-E) % multiple
    index = np.concatenate([np.arange(E), np.zeros(pad, dtype=np.int64)])
    valid = np.concatenate([np.ones(E), np.zeros(pad)])
    return index, valid


@dataclass(eq=False)
class ShardedElasticity:
    """Element-sharded view of a :class:`~..elasticity.HyperelasticModel`.

    Replicated-in, replicated-out ``internal_forces``, ``residual``,
    ``hessian_vector_product``, ``hessian_diagonal``, ``energy``,
    ``newton_step`` and ``solve``.  Each rank holds the geometry, dof map
    and per-element parameters of its run of the padded elements and
    sweeps it in the model's chunks (the plain element sweeps); one
    ``all_reduce`` combines the ranks' partial sums.
    """

    model: HyperelasticModel
    mesh: DeviceMesh

    def __post_init__(self):
        m = self.model
        self._comm = _Comm(self.mesh, m.device)
        n_dev, rank = self._comm.size, self._comm.rank
        E = m.mesh.num_cells
        index, valid = _pad_to_multiple(E, n_dev)
        Es = len(index) // n_dev
        own = torch.as_tensor(index[rank * Es : (rank + 1) * Es], device=m.device)
        self._X = m.space.X_geo[own]
        self._dofs = m.space.dofs[own]
        self._valid = torch.as_tensor(valid[rank * Es : (rank + 1) * Es], dtype=m.dtype, device=m.device)
        self._params = slice_params(m._params, E, own)
        self._num_elements = Es
        self._scatter = scatter_plan(m._cells[own].reshape(-1))
        self.num_dofs = m.space.num_dofs

    # -- the rank's sweeps ------------------------------------------------------

    def _chunks(self):
        c = self.model.chunk_size or max(self._num_elements, 1)
        return [(e0, min(e0 + c, self._num_elements)) for e0 in range(0, self._num_elements, c)]

    def _local(self, u, e0, e1):
        m = self.model
        return u[self._dofs[e0:e1]].reshape(-1, m.mesh.element.num_nodes, m.mesh.dim)

    def _chunk_params(self, e0, e1):
        return slice_params(self._params, self._num_elements, slice(e0, e1))

    def _scatter_nodes(self, f_el):
        """Node sums of element vectors ``[Es, n*s]`` as a flat dof vector (deterministic)."""
        m = self.model
        out = f_el.new_zeros((m.mesh.num_vertices, m.mesh.dim))
        return scatter_add_rows(out, self._scatter, f_el.reshape(-1, m.mesh.dim)).reshape(-1)

    def _partial_forces(self, u):
        """This rank's share of the internal forces (no collective: ``torch.func.jvp`` passes through)."""
        m = self.model
        f_el = torch.cat(
            [
                assemble_element_elliptic_vectors(
                    self._X[e0:e1], self._local(u, e0, e1), m.operator, self._chunk_params(e0, e1), m.tab
                )
                for e0, e1 in self._chunks()
            ]
        )
        return self._scatter_nodes(f_el * self._valid[:, None])

    # -- sharded operators ------------------------------------------------------

    def internal_forces(self, u):
        return self._comm.all_reduce(self._partial_forces(u))

    def residual(self, u):
        m = self.model
        return torch.where(m.free_mask, self.internal_forces(u) - m._f_ext, 0.0)

    def hessian_vector_product(self, u, v):
        """Masked Hessian action: the jvp of this rank's partial forces, then one ``all_reduce``."""
        m = self.model
        vm = torch.where(m.free_mask, v, 0.0)
        _, hv = torch.func.jvp(self._partial_forces, (u,), (vm,))
        return torch.where(m.free_mask, self._comm.all_reduce(hv.contiguous()), v)

    def hessian_diagonal(self, u):
        m = self.model
        n, s = m.mesh.element.num_nodes, m.mesh.dim
        d_em = torch.cat(
            [
                elliptic_matrix_diagonal_em(
                    self._X[e0:e1].permute(1, 2, 0), self._local(u, e0, e1).permute(1, 2, 0), m.operator,
                    self._chunk_params(e0, e1), m.tab,
                )
                for e0, e1 in self._chunks()
            ],
            -1,
        )
        d_el = d_em.permute(2, 0, 1).reshape(-1, n * s) * self._valid[:, None]
        diag = self._comm.all_reduce(self._scatter_nodes(d_el))
        return torch.where(m.free_mask & (diag != 0.0), diag, 1.0)

    def energy(self, u):
        m = self.model
        e = sum(
            (compute_element_elliptic_energy(
                self._X[e0:e1], self._local(u, e0, e1), m.operator, self._chunk_params(e0, e1), m.tab
            ) * self._valid[e0:e1]).sum()
            for e0, e1 in self._chunks()
        )
        return self._comm.all_reduce(e.reshape(1))[0] - torch.dot(m._f_ext, u)

    # -- solve --------------------------------------------------------------------

    def _jacobi_cg(self, u, f, rel_tolerance, max_iter):
        return _jacobi_cg(lambda v: self.hessian_vector_product(u, v), self.hessian_diagonal(u), f, rel_tolerance,
                          max_iter)

    def newton_step(self, u, cg_rel_tolerance=1e-6, cg_max_iter=500):
        """One inexact Newton step: ``(u - d, ||F(u)||)``."""
        f = self.residual(u)
        return u - self._jacobi_cg(u, f, cg_rel_tolerance, cg_max_iter).x, torch.linalg.vector_norm(f)

    def solve(self, u0=None, tolerance: float = 1e-8, max_newton_iterations: int = 30,
              cg_rel_tolerance: float = 1e-6, cg_max_iter: int = 2000, line_search: bool = True):
        """Newton–Krylov solve with Jacobi-preconditioned CG, every operator sharded."""
        if u0 is None:
            u0 = torch.zeros(self.num_dofs, dtype=self.model.dtype, device=self.model.device)
        return newton_line_search(
            self.residual,
            lambda u, f: self._jacobi_cg(u, f, cg_rel_tolerance, cg_max_iter).x,
            u0,
            tolerance=tolerance,
            max_iterations=max_newton_iterations,
            line_search=line_search,
        )
