"""Structured-grid hyperelasticity: stencil assembly on uniform hex8 grids.

Counterpart of ``fenris_tpu/structured.py``.  On a uniform box hex mesh
(the flagship configuration, BASELINE config 5: Neo-Hookean on a
1M-element hex grid) every FEM data movement is a shifted slice:

* the per-element dof gather ``u[cells]`` is 8 shifted views of the node
  grid ``[s, z, y, x]``;
* the global scatter-add is 8 shifted slice-adds in a fixed order;
* the geometry is affine and identical for every element, so the physical
  basis gradients are one constant table ``gp [q, n, d]``.

Public layouts are the JAX package's: flat dof vectors ``[num_nodes * 3]``
numbered ``3 * node + comp`` with nodes in (z, y, x) order, and grids
``[3, nz, ny, nx]``.  For a CUDA f32 Neo-Hookean model the residual and
the Hessian action go through the hand-written stencil kernels
(:mod:`.ops.structured_stencil`); every other path is plain PyTorch.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap

from .assembly.local import tabulate
from .config import DEFAULT_DTYPE, resolve_device
from .ops.structured_stencil import (
    corner_views,
    gp_table,
    neo_hookean_hvp,
    neo_hookean_residual,
    scatter_corners,
)
from .optimize import NewtonResult, mixed_precision_newton, newton_line_search
from .quadrature import canonical_stiffness
from .reference_elements import HEX8
from .solid import HyperelasticMaterial, MaterialEllipticOperator, NeoHookeanMaterial
from .sparse.cg import conjugate_gradient

__all__ = ["StructuredHyperelasticModel"]

#: cells above which the assembly sweeps run in z-slabs; bounds the
#: [q, cells, 3, 3]-sized intermediates of the plain path (the contraction
#: tensor of ``hessian_diagonal`` is 81 values per point)
_SWEEP_CELLS = 2**20


@dataclass(eq=False)
class StructuredHyperelasticModel:
    """Hyperelastic solid on a uniform box hex grid (stencil assembly).

    Args:
        cells: (ncx, ncy, ncz) cell counts.
        spacing: uniform cell edge length h.
        material/params: a :class:`~.solid.HyperelasticMaterial` and its
            parameters (e.g. :class:`~.solid.LameParameters`).
        dirichlet_mask: boolean ``[num_nodes * 3]`` (True = constrained) or None.
        body_force: constant ``[3]`` body force density, a pointwise torch
            callable ``f(x [3], params) -> [3]`` evaluated at the quadrature
            points, or None.
        dtype/device: of every tensor the model holds and returns (the
            default device is the card; CPU callers pass ``device="cpu"``).
        z_chunk_planes: cell planes per z-slab of the plain assembly sweeps
            (0 = one sweep; None = one sweep up to 2**20 cells, slabs of
            about 2**20 cells above).
        kernel: the hand-written stencil kernels for residual and Hessian
            action: "auto" uses them for CUDA f32 Neo-Hookean models, True
            forces them (raises for other models), False disables them.
    """

    cells: Tuple[int, int, int]
    spacing: float
    material: HyperelasticMaterial
    params: Any
    dirichlet_mask: Any = None
    body_force: Any = None
    dtype: torch.dtype = DEFAULT_DTYPE
    z_chunk_planes: Optional[int] = None
    kernel: Any = "auto"
    device: Any = "cuda"  # after the JAX package's fields: its positional calls carry over

    def __post_init__(self):
        self.device = resolve_device(self.device)
        ncx, ncy, ncz = (int(c) for c in self.cells)
        self.cells = (ncx, ncy, ncz)
        if self.z_chunk_planes is None:
            E = ncx * ncy * ncz
            self.z_chunk_planes = 0 if E <= _SWEEP_CELLS else max(1, _SWEEP_CELLS // (ncx * ncy))
        self.node_shape = (ncz + 1, ncy + 1, ncx + 1)  # (z, y, x) grid
        self.num_nodes = int(np.prod(self.node_shape))
        self.num_dofs = self.num_nodes * 3
        self.operator = MaterialEllipticOperator(self.material, dim=3)

        tab = tabulate(HEX8, canonical_stiffness("hex8"))
        # float64 host tables (the kernels' constants) and their tensors
        self.gp_table, self.wdet_table = gp_table(self.spacing)
        self.gp = self._tensor(self.gp_table)  # [q, n, d]
        self.wdet = self._tensor(self.wdet_table)  # [q]
        self.phi = self._tensor(tab.phi)  # [q, n]
        self._qp_ref = tab.points  # [q, 3] in [-1, 1]^3

        if self.dirichlet_mask is not None:
            free = ~torch.as_tensor(np.asarray(self.dirichlet_mask, dtype=bool))
        else:
            free = torch.ones(self.num_dofs, dtype=torch.bool)
        self.free_mask = free.to(self.device)
        self._free_grid = self._grid(self.free_mask).contiguous()
        self._f_ext = self._external_forces()
        self._f_ext_grid = self._grid(self._f_ext).contiguous()

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    # -- layouts -------------------------------------------------------------

    def _grid(self, u):
        """[s, z, y, x] node grid (a view) from a flat dof vector."""
        return u.reshape(self.node_shape + (3,)).permute(3, 0, 1, 2)

    def _ungrid(self, g):
        """Flat dof vector from [s, z, y, x]."""
        return g.permute(1, 2, 3, 0).reshape(-1)

    def _gather_elements(self, ug):
        """[n, s, zc, yc, xc] element-local dofs via 8 shifted slices."""
        return torch.stack(corner_views(ug))

    # -- external forces and quadrature-point evaluation -----------------------

    def _qp_coords(self):
        """Physical quadrature-point coordinates [q, 3, zc, yc, xc]."""
        ncx, ncy, ncz = self.cells
        h = float(self.spacing)
        qp = self._qp_ref  # [q, 3], (x, y, z) components
        cx = (np.arange(ncx) + (qp[:, 0:1] + 1.0) / 2.0) * h
        cy = (np.arange(ncy) + (qp[:, 1:2] + 1.0) / 2.0) * h
        cz = (np.arange(ncz) + (qp[:, 2:3] + 1.0) / 2.0) * h
        X = np.zeros((qp.shape[0], 3, ncz, ncy, ncx))
        X[:, 0] = cx[:, None, None, :]
        X[:, 1] = cy[:, None, :, None]
        X[:, 2] = cz[:, :, None, None]
        return self._tensor(X)

    def _eval_at_qps(self, fn: Callable):
        """Evaluate pointwise ``fn(x [3]) -> [s]`` at all quadrature points -> [q, s, zc, yc, xc]."""
        X = self._qp_coords()
        pts = X.movedim(1, -1).reshape(-1, 3)
        vals = vmap(fn)(pts).to(self.dtype)  # [q*E, s]
        shape = (X.shape[0],) + tuple(self.cells[::-1]) + (vals.shape[-1],)
        return vals.reshape(shape).movedim(-1, 1)

    def l2_error(self, u, u_exact: Callable) -> float:
        """Quadrature L2 norm of (u_h - u_exact) over the box (error.rs:313)."""
        U = self._gather_elements(self._grid(u))
        uh_q = torch.einsum("qn,nszyx->qszyx", self.phi, U)
        d = uh_q - self._eval_at_qps(u_exact)
        return float(torch.sqrt(torch.einsum("q,qszyx->", self.wdet, d * d)))

    def _external_forces(self):
        if self.body_force is None:
            return torch.zeros(self.num_dofs, dtype=self.dtype, device=self.device)
        if callable(self.body_force):
            # f_ext[I] = sum_el sum_q w detJ phi_I(q) f(x_q)
            Fq = self._eval_at_qps(lambda x: self.body_force(x, self.params))
            f_el = torch.einsum("q,qn,qszyx->nszyx", self.wdet, self.phi, Fq)
            return self._ungrid(scatter_corners(f_el, self.node_shape))
        b = self._tensor(self.body_force)
        f_el_node = self.wdet.sum() / 8.0 * b  # [3]
        ones_el = f_el_node[None, :, None, None, None].expand(
            (8, 3) + tuple(self.cells[::-1])
        )
        return self._ungrid(scatter_corners(ones_el, self.node_shape))

    # -- plain assembly sweeps -------------------------------------------------

    def _grad_local(self, ug):
        """G [q, zc, yc, xc, d, s] at every quadrature point of a node grid's cells."""
        return torch.einsum("qnd,nszyx->qzyxds", self.gp, self._gather_elements(ug))

    def _project(self, g):
        """f_el[n, s] = sum_q w_q sum_d gp[q, n, d] g[q, ..., d, s]."""
        return torch.einsum("q,qnd,qzyxds->nszyx", self.wdet, self.gp, g)

    def _forces_local(self, ug):
        g = self.operator.g(self._grad_local(ug), self.params)
        return scatter_corners(self._project(g), ug.shape[1:])

    def _hvp_local(self, ug, vg):
        dg = self.operator.g_tangent(self._grad_local(ug), self._grad_local(vg), self.params)
        return scatter_corners(self._project(dg), ug.shape[1:])

    def _diag_local(self, ug):
        D = self.operator.contraction(self._grad_local(ug), self.params)  # [..., k, i, m, j]
        Dii = torch.diagonal(D, dim1=-3, dim2=-1)  # [..., k, m, i]
        d_el = torch.einsum("q,qnk,qzyxkmi,qnm->nizyx", self.wdet, self.gp, Dii, self.gp)
        return scatter_corners(d_el, ug.shape[1:])

    def _energy_local(self, ug):
        psi = self.operator.energy(self._grad_local(ug), self.params)  # [q, zc, yc, xc]
        return torch.einsum("q,qzyx->", self.wdet, psi)

    def _slabs(self):
        ncz = self.cells[2]
        slab = int(self.z_chunk_planes) or ncz
        return [(z0, min(z0 + slab, ncz)) for z0 in range(0, ncz, slab)]

    def _node_sweep(self, local_fn, *grids):
        """Node-grid sum of ``local_fn`` over z-slabs of cell planes."""
        slabs = self._slabs()
        if len(slabs) == 1:
            return local_fn(*grids)
        out = grids[0].new_zeros((3,) + self.node_shape)
        for z0, z1 in slabs:
            out[:, z0 : z1 + 1] += local_fn(*(g[:, z0 : z1 + 1] for g in grids))
        return out

    def _forces_grid(self, ug):
        """Internal forces [s, z, y, x] of a node grid, plain path."""
        return self._node_sweep(self._forces_local, ug)

    def internal_forces_grid(self, u):
        """Internal forces in grid layout [s, z, y, x] (flat dof input), plain path."""
        return self._forces_grid(self._grid(u))

    def internal_forces(self, u):
        """Internal forces as a flat dof vector, plain path."""
        return self._ungrid(self.internal_forces_grid(u))

    def to_mesh(self):
        """The equivalent unstructured hex8 mesh, with the same node numbering."""
        from .mesh.procedural import create_rectangular_uniform_hex_mesh

        ncx, ncy, ncz = self.cells
        return create_rectangular_uniform_hex_mesh(self.spacing, ncx, ncy, ncz, 1)

    # -- stencil-kernel path (ops/structured_stencil.py) ------------------------

    def _check_kernel(self):
        if not isinstance(self.material, NeoHookeanMaterial):
            raise NotImplementedError("the stencil kernel path is Neo-Hookean only")
        if self.dtype != torch.float32:
            # a silent downcast would corrupt solve_mixed's f64 outer residual
            raise NotImplementedError(
                "the stencil kernels are f32-only; f64 models take the plain path (kernel=False)"
            )

    def _kernel_active(self) -> bool:
        if self.kernel is True:
            self._check_kernel()
            return True
        if self.kernel != "auto":
            return False
        # Everything else runs the plain path on the card, as the JAX package
        # runs it on XLA: the f64 outer residual of solve_mixed (pallas=False
        # there) and the linear-elastic multigrid level operators.
        return (
            self.device.type == "cuda"
            and self.dtype == torch.float32
            and isinstance(self.material, NeoHookeanMaterial)
        )

    def _lame(self):
        return float(self.params.mu), float(self.params.lam)

    # -- public operators ---------------------------------------------------------

    def residual(self, u):
        if self._kernel_active():
            fg = neo_hookean_residual(
                self._grid(u).contiguous(), self.gp_table, self.wdet_table, *self._lame()
            )
        else:
            fg = self.internal_forces_grid(u)
        return self._ungrid(torch.where(self._free_grid, fg - self._f_ext_grid, 0.0))

    def hessian_vector_product(self, u, v):
        """Dirichlet-masked Hessian action; constrained rows act as the identity."""
        vg = self._grid(v)
        vm = torch.where(self._free_grid, vg, 0.0).contiguous()
        if self._kernel_active():
            hv = neo_hookean_hvp(
                self._grid(u).contiguous(), vm, self.gp_table, self.wdet_table, *self._lame()
            )
        else:
            hv = self._node_sweep(self._hvp_local, self._grid(u), vm)
        return self._ungrid(torch.where(self._free_grid, hv, vg))

    def energy(self, u):
        ug = self._grid(u)
        e = sum(self._energy_local(ug[:, z0 : z1 + 1]) for z0, z1 in self._slabs())
        return e - torch.dot(self._f_ext, u)

    def hessian_diagonal(self, u):
        """Assembled Hessian diagonal via the contraction tensor stencil."""
        dg = self._node_sweep(self._diag_local, self._grid(u))
        return self._ungrid(torch.where(self._free_grid & (dg != 0.0), dg, 1.0))

    # -- solve -----------------------------------------------------------------------

    def _preconditioner(self, preconditioner: str):
        if preconditioner == "mg":
            from .multigrid import StructuredMGPreconditioner

            return StructuredMGPreconditioner(self)
        if preconditioner != "jacobi":
            raise ValueError(f"preconditioner must be 'jacobi' or 'mg', not {preconditioner!r}")
        return None

    def _inner_cg(self, mg, u, f, rel_tolerance, max_iter):
        if mg is not None:
            prec = mg
        else:
            inv_diag = 1.0 / self.hessian_diagonal(u)
            prec = lambda v: inv_diag * v  # noqa: E731
        return conjugate_gradient(
            lambda v: self.hessian_vector_product(u, v),
            f,
            preconditioner=prec,
            rel_tolerance=rel_tolerance,
            max_iter=max_iter,
            check_definiteness=False,
        )

    def solve(
        self,
        u0=None,
        tolerance: float = 1e-6,
        max_newton_iterations: int = 30,
        cg_rel_tolerance: float = 1e-5,
        cg_max_iter: int = 1000,
        line_search: bool = True,
        preconditioner: str = "jacobi",
        callback: Optional[Callable] = None,
    ) -> NewtonResult:
        """Newton-Krylov solve; ``preconditioner`` is "jacobi" or "mg".

        ``callback(k, residual_norm, cg)``, if given, is called with the
        initial residual norm (k = 0, cg None) and after every Newton
        iteration with that iteration's :class:`~.sparse.cg.CgResult`.
        """
        if u0 is None:
            u0 = torch.zeros(self.num_dofs, dtype=self.dtype, device=self.device)
        mg = self._preconditioner(preconditioner)
        last_cg = [None]

        def solve_jacobian(u, f):
            last_cg[0] = self._inner_cg(mg, u, f, cg_rel_tolerance, cg_max_iter)
            return last_cg[0].x

        return newton_line_search(
            self.residual,
            solve_jacobian,
            u0,
            tolerance=tolerance,
            max_iterations=max_newton_iterations,
            line_search=line_search,
            callback=None if callback is None else lambda k, fn: callback(k, fn, last_cg[0] if k else None),
        )

    def solve_mixed(
        self,
        u0=None,
        tolerance: float = 1e-10,
        max_newton_iterations: int = 30,
        cg_rel_tolerance: float = 1e-4,
        cg_max_iter: int = 1000,
        preconditioner: str = "mg",
        verbose: bool = False,
        callback: Optional[Callable] = None,
    ) -> NewtonResult:
        """Mixed-precision Newton-Krylov: f64 outer residual, f32 inner CG.

        Finite-precision CG's attainable accuracy is ~eps * kappa, so a
        pure-f32 Newton stalls after about one digit at 1M+ dofs.  The
        iterate and the residual are kept in f64 and each inner Krylov
        solve runs on this (f32) model; Newton acts as iterative refinement.
        ``tolerance`` is relative to the initial residual norm.
        ``callback(k, residual_norm, cg)`` as in :meth:`solve`.
        """
        # the f64 outer residual runs the plain path (kernels are f32-only)
        model64 = replace(self, dtype=torch.float64, kernel=False)
        mg = self._preconditioner(preconditioner)
        last_cg = [None]

        def inner_solve(k, u32, f32):
            cg = self._inner_cg(mg, u32, f32, cg_rel_tolerance, cg_max_iter)
            last_cg[0] = cg
            if verbose:
                print(
                    f"[solve_mixed it {k}] cg iters={cg.num_iterations} "
                    f"status={cg.status} |r|={float(cg.residual_norm):.3e}",
                    flush=True,
                )
            return cg.x

        if u0 is None:
            u0 = torch.zeros(self.num_dofs, dtype=torch.float64, device=self.device)
        return mixed_precision_newton(
            model64.residual,
            inner_solve,
            u0,
            tolerance=tolerance,
            max_iterations=max_newton_iterations,
            verbose=verbose,
            callback=None if callback is None else lambda k, fn: callback(k, fn, last_cg[0] if k else None),
        )
