"""Finite-element spaces: the device view of a mesh.

Counterpart of ``FemSpace`` in ``fenris_tpu/fem.py`` (:36-84): the
gathered geometry nodes and the per-element dof map on the device.  The
lazily built CSR pattern is not ported yet (the assembled path never
builds one).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .assembly.global_ import element_dof_indices
from .config import DEFAULT_DTYPE, resolve_device
from .mesh import Mesh

__all__ = ["FemSpace"]


@dataclass(frozen=True)
class FemSpace:
    mesh: Mesh
    solution_dim: int
    X_geo: torch.Tensor  # [E, m, d]
    dofs: torch.Tensor  # [E, n*s] int64

    @staticmethod
    def create(mesh: Mesh, solution_dim: int = 1, dtype=DEFAULT_DTYPE, device="cuda") -> "FemSpace":
        dev = resolve_device(device)
        m = mesh.element.geometry.num_nodes
        X = torch.as_tensor(mesh.cell_points()[:, :m, :], dtype=dtype, device=dev)
        dofs = torch.as_tensor(element_dof_indices(mesh.cells, solution_dim), device=dev)
        return FemSpace(mesh=mesh, solution_dim=int(solution_dim), X_geo=X, dofs=dofs)

    @property
    def num_dofs(self) -> int:
        return self.mesh.num_vertices * self.solution_dim

    def local_dofs(self, u: torch.Tensor) -> torch.Tensor:
        """Per-element local dofs ``[E, n, s]`` gathered from a global vector."""
        return u[self.dofs].reshape(-1, self.mesh.element.num_nodes, self.solution_dim)
