"""Finite-element spaces and the Poisson workflows.

Counterpart of ``fenris_tpu/fem.py``:

* ``FemSpace`` (:36-84): the gathered geometry and full node coordinates
  and the per-element dof map on the device, and the dof-level CSR
  pattern, built on first use;
* the generalized Poisson pipeline ``-div g(∇u) = f`` (assemble or apply
  the operator, constrain the Dirichlet dofs, Jacobi-preconditioned CG,
  estimate the L² and H¹-seminorm errors) on the JAX package's three
  routes: :func:`solve_poisson` (the CSR route: element matrices scattered
  into CSR, symmetric Dirichlet elimination, CG on the CSR product),
  :func:`solve_poisson_assembled` (block-DIA bands, the band-sweep kernel
  in every CG iteration on the card) and :func:`solve_poisson_matrix_free`
  (banded gather, plain element-minor sweep, banded scatter).

Pointwise callables (``source(x, params)``, ``u_exact(x)``,
``u_exact_grad(x)``) take torch tensors and run under ``torch.func.vmap``.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .assembly import global_ as G
from .assembly.global_ import assemble_vector, element_dof_indices
from .config import DEFAULT_DTYPE, resolve_device
from .mesh import Mesh
from .sparse.csr import from_pattern

__all__ = [
    "FemSpace",
    "PoissonResult",
    "assemble_poisson_system",
    "solve_poisson",
    "solve_poisson_assembled",
    "solve_poisson_matrix_free",
]


@dataclass(frozen=True, eq=False)
class FemSpace:
    """Device-resident assembly view of a mesh.

    ``X_full [E, n, d]`` holds every node's coordinates, ``X_geo [E, m, d]``
    (contiguous) the geometry element's.  The dof-level CSR pattern
    (:func:`~.assembly.global_.csr_pattern`, on the space's device) is built
    on first access, so matrix-free and block-DIA pipelines never pay for it.
    """

    mesh: Mesh
    solution_dim: int
    X_geo: torch.Tensor  # [E, m, d]
    X_full: torch.Tensor  # [E, n, d]
    dofs: torch.Tensor  # [E, n*s] int64

    @staticmethod
    def create(mesh: Mesh, solution_dim: int = 1, dtype=DEFAULT_DTYPE, device="cuda") -> "FemSpace":
        dev = resolve_device(device)
        m = mesh.element.geometry.num_nodes
        X = torch.as_tensor(mesh.cell_points(), dtype=dtype, device=dev)
        dofs = torch.as_tensor(element_dof_indices(mesh.cells, solution_dim), device=dev)
        return FemSpace(mesh=mesh, solution_dim=int(solution_dim), X_geo=X[:, :m].contiguous(), X_full=X, dofs=dofs)

    @cached_property
    def pattern(self) -> G.CsrPattern:
        """Dof-level CSR pattern (symbolic assembly), built on first use."""
        return G.csr_pattern(self.mesh.cells, self.mesh.num_vertices, self.solution_dim, self.X_geo.device)

    @property
    def num_dofs(self) -> int:
        return self.mesh.num_vertices * self.solution_dim

    def local_dofs(self, u: torch.Tensor) -> torch.Tensor:
        """Per-element local dofs ``[E, n, s]`` gathered from a global vector."""
        return u[self.dofs].reshape(-1, self.mesh.element.num_nodes, self.solution_dim)


class PoissonResult(NamedTuple):
    u: torch.Tensor
    l2_error: Optional[float]
    h1_seminorm_error: Optional[float]
    cg_iterations: int


def _free_mask(num_nodes: int, s: int, dirichlet_nodes, device) -> torch.Tensor:
    """Dof mask, False on every component of the Dirichlet nodes."""
    mask = np.ones(num_nodes * s, dtype=bool)
    if dirichlet_nodes is not None and len(dirichlet_nodes):
        nd = np.asarray(dirichlet_nodes, dtype=np.int64)
        for i in range(s):
            mask[nd * s + i] = False
    return torch.as_tensor(mask, device=device)


def _errors(space: "FemSpace", u, error_rule, u_exact, u_exact_grad):
    """L² and H¹-seminorm errors of ``u`` by ``error_rule`` (None where no exact solution is given)."""
    from .assembly.local import tabulate
    from .error import estimate_H1_seminorm_error, estimate_L2_error

    if u_exact is None:
        return None, None
    tab_err = tabulate(space.mesh.element, error_rule)
    u_el = space.local_dofs(u)
    l2 = float(estimate_L2_error(space.X_geo, u_el, u_exact, tab_err))
    h1 = None
    if u_exact_grad is not None:
        h1 = float(estimate_H1_seminorm_error(space.X_geo, u_el, u_exact_grad, tab_err))
    return l2, h1


def _element_chunk(E: int, n: int, s: int) -> Optional[int]:
    """Elements a chunk of element matrices: bounds the contraction transients past 2**27 entries."""
    return 65536 if E * (n * s) ** 2 > 2**27 else None


def assemble_poisson_system(space: FemSpace, rule, source: Callable, operator=None, dirichlet_nodes=None):
    """The CSR system of ``-div g(∇u) = f`` with the Dirichlet dofs eliminated (``fem.py:94``).

    Element matrices of the operator (default Laplace) scattered into CSR,
    the source vector, then the symmetric homogeneous Dirichlet
    elimination.  Returns ``(CsrMatrix, b)``.
    """
    from .assembly.local import assemble_element_elliptic_matrices, assemble_element_source_vectors, tabulate
    from .operators import LaplaceOperator

    op = operator or LaplaceOperator()
    tab = tabulate(space.mesh.element, rule)
    n, s = space.mesh.element.num_nodes, op.solution_dim
    A_el = assemble_element_elliptic_matrices(space.X_geo, None, op, None, tab,
                                              chunk=_element_chunk(space.mesh.num_cells, n, s))
    values = G.assemble_csr(A_el, space.pattern)
    del A_el
    b = assemble_vector(assemble_element_source_vectors(space.X_geo, source, None, s, tab), space.dofs,
                        space.num_dofs)
    if dirichlet_nodes is not None and len(dirichlet_nodes):
        values = G.apply_homogeneous_dirichlet_bc_csr(values, space.pattern, dirichlet_nodes)
        b = G.apply_homogeneous_dirichlet_bc_rhs(b, dirichlet_nodes, space.solution_dim)
    return from_pattern(space.pattern, values), b


def solve_poisson(
    mesh: Mesh,
    rule,
    error_rule,
    source: Callable,
    u_exact: Optional[Callable] = None,
    u_exact_grad: Optional[Callable] = None,
    dirichlet_nodes=None,
    rel_tolerance: float = 1e-9,
    max_iter: int = 10000,
    dtype=DEFAULT_DTYPE,
    device="cuda",
) -> PoissonResult:
    """The CSR route, end to end (``fem.py:126``; poisson_mms_common.rs:173).

    :func:`assemble_poisson_system` on a scalar space, Jacobi from the CSR
    diagonal, CG on the CSR product (:mod:`.sparse.csr`), then the L² and
    H¹-seminorm errors by ``error_rule``.
    """
    from .sparse.cg import conjugate_gradient

    space = FemSpace.create(mesh, 1, dtype, device)
    A, b = assemble_poisson_system(space, rule, source, dirichlet_nodes=dirichlet_nodes)
    diag = A.diagonal()
    inv_diag = torch.where(diag != 0.0, 1.0 / diag, 1.0)
    res = conjugate_gradient(A, b, preconditioner=lambda v: inv_diag * v, rel_tolerance=rel_tolerance,
                             max_iter=max_iter)
    l2, h1 = _errors(space, res.x, error_rule, u_exact, u_exact_grad)
    return PoissonResult(u=res.x, l2_error=l2, h1_seminorm_error=h1, cg_iterations=int(res.num_iterations))


def solve_poisson_assembled(
    mesh: Mesh,
    rule,
    error_rule,
    source: Callable,
    u_exact: Optional[Callable] = None,
    u_exact_grad: Optional[Callable] = None,
    dirichlet_nodes=None,
    operator=None,
    rel_tolerance: float = 1e-9,
    max_iter: int = 10000,
    max_diagonals: Optional[int] = None,
    min_fill: float = 0.0,
    dtype=DEFAULT_DTYPE,
    device="cuda",
) -> PoissonResult:
    """Assembled-operator Poisson solve on block-DIA bands (``fem.py:200``).

    Full element matrices land on the bands through the flat block-DIA
    assembly (``num_chunks`` by the JAX rule, one chunk a 2**27 entries);
    CG runs on :func:`~.sparse.dia_kernel.block_dia_operator`, which takes
    the band-sweep kernel for f32 bands on the card.  Dirichlet conditions
    are dof masking (identity on constrained dofs), Jacobi reads the zero
    band.
    """
    from .assembly.local import assemble_element_elliptic_matrices, assemble_element_source_vectors, tabulate
    from .operators import LaplaceOperator
    from .sparse.block_dia import assemble_block_dia, block_dia_assembly_plan
    from .sparse.cg import conjugate_gradient
    from .sparse.dia_kernel import block_dia_operator

    op = operator or LaplaceOperator()
    s = op.solution_dim
    space = FemSpace.create(mesh, s, dtype, device)
    dev = space.X_geo.device
    tab = tabulate(mesh.element, rule)
    E, n = mesh.num_cells, mesh.element.num_nodes
    A_el = assemble_element_elliptic_matrices(space.X_geo, None, op, None, tab, chunk=_element_chunk(E, n, s))
    plan = block_dia_assembly_plan(mesh.cells, mesh.num_vertices, s, max_diagonals=max_diagonals,
                                   min_fill=min_fill, device=dev)
    num_chunks = max(1, -(-(E * (n * s) ** 2) // 2**27))
    A = assemble_block_dia(plan, A_el, num_chunks=num_chunks)
    del A_el

    b_el = assemble_element_source_vectors(space.X_geo, source, None, s, tab)
    free = _free_mask(mesh.num_vertices, s, dirichlet_nodes, dev)
    b = torch.where(free, assemble_vector(b_el, space.dofs, space.num_dofs), 0.0)
    del b_el

    d0 = A.offsets.index(0)
    diag = torch.stack([A.bands[(d0 * s + i) * s + i] for i in range(s)], 1).reshape(-1)
    inv_diag = 1.0 / torch.where(free & (diag != 0.0), diag, 1.0)
    matvec = block_dia_operator(A, layout="dof")

    def apply_A(v):
        return torch.where(free, matvec(torch.where(free, v, 0.0)), v)

    res = conjugate_gradient(apply_A, b, preconditioner=lambda v: inv_diag * v,
                             rel_tolerance=rel_tolerance, max_iter=max_iter)
    l2, h1 = _errors(space, res.x, error_rule, u_exact, u_exact_grad)
    return PoissonResult(u=res.x, l2_error=l2, h1_seminorm_error=h1, cg_iterations=int(res.num_iterations))


def solve_poisson_matrix_free(
    mesh: Mesh,
    rule,
    error_rule,
    source: Callable,
    u_exact: Optional[Callable] = None,
    u_exact_grad: Optional[Callable] = None,
    dirichlet_nodes=None,
    operator=None,
    rel_tolerance: float = 1e-9,
    max_iter: int = 10000,
    banded_r_nodes: int = 4096,
    dtype=DEFAULT_DTYPE,
    device="cuda",
) -> PoissonResult:
    """Matrix-free Poisson solve: CG on the operator action, no matrix (``fem.py:265``).

    ``v -> A v`` is the banded gather (:func:`~.ops.banded.gather`), the
    plain element-minor sweep of the operator and the banded scatter,
    in the padded row layout of a banded plan with JAX's ``r_nodes`` rule;
    the gather and scatter launch their kernels for f32 data on the card.
    Same masking, Jacobi preconditioner (from the element-matrix
    diagonals) and error estimation as :func:`solve_poisson_assembled`.
    The sweeps read ``m`` geometry and ``n`` basis nodes from the
    tabulation, so it takes every 3D element.
    """
    from .assembly import local_em as LE
    from .assembly.local import assemble_element_source_vectors, tabulate
    from .operators import LaplaceOperator
    from .ops import banded as B
    from .sparse.cg import conjugate_gradient

    op = operator or LaplaceOperator()
    s = op.solution_dim
    dev = resolve_device(device)
    tab = tabulate(mesh.element, rule)
    N, n = mesh.num_vertices, mesh.element.num_nodes
    r = min(banded_r_nodes, max(1024, -(-N // 1024) * 1024))
    plan = B.make_banded_plan(mesh.cells, N, s=s, r_nodes=r, device=dev)
    m = mesh.element.geometry.num_nodes
    cells = torch.as_tensor(mesh.cells[:, :m], dtype=torch.int64, device=dev)
    index = torch.as_tensor(plan.element_index, device=dev)
    Xg_band = torch.as_tensor(mesh.points, dtype=dtype, device=dev)[cells[index]]  # [E_pad, m, d]
    X_em = Xg_band.permute(1, 2, 0).contiguous()
    valid = torch.as_tensor(plan.valid_elements(), dtype=dtype, device=dev)
    free = _free_mask(N, s, dirichlet_nodes, dev)

    def apply_A(v):
        vm = torch.where(free, v, 0.0)
        u_em = B.gather(plan, vm.reshape(-1, s)).permute(1, 2, 0)
        f_em = LE.assemble_element_elliptic_vectors_em(X_em, u_em, op, None, tab) * valid
        av = B.scatter_add(plan, f_em.permute(2, 0, 1).contiguous()).reshape(-1)
        return torch.where(free, av, v)

    # right-hand side: source vectors over the padded layout, scattered, then masked
    b_el = assemble_element_source_vectors(Xg_band, source, None, s, tab) * valid[:, None]
    b = B.scatter_add(plan, b_el.reshape(plan.padded_elements, n, s).contiguous()).reshape(-1)
    b = torch.where(free, b, 0.0)
    del b_el, Xg_band

    # Jacobi from the element-matrix diagonals
    u0_em = X_em.new_zeros((n, s, plan.padded_elements))
    d_em = LE.elliptic_matrix_diagonal_em(X_em, u0_em, op, None, tab) * valid
    diag = B.scatter_add(plan, d_em.permute(2, 0, 1).contiguous()).reshape(-1)
    inv_diag = 1.0 / torch.where(free & (diag != 0.0), diag, 1.0)
    del u0_em, d_em

    res = conjugate_gradient(apply_A, b, preconditioner=lambda v: inv_diag * v,
                             rel_tolerance=rel_tolerance, max_iter=max_iter)
    l2, h1 = None, None
    if u_exact is not None:
        l2, h1 = _errors(FemSpace.create(mesh, s, dtype, dev), res.x, error_rule, u_exact, u_exact_grad)
    return PoissonResult(u=res.x, l2_error=l2, h1_seminorm_error=h1, cg_iterations=int(res.num_iterations))
