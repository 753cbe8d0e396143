"""Geometric multigrid preconditioning for hyperelastic models.

Counterpart of ``fenris_tpu/multigrid.py``.  :class:`StructuredMGPreconditioner`
is the matrix-free geometric V-cycle on the uniform hex grid, where every
transfer operator is slicing and averaging;
:class:`GeometricMGPreconditioner` the V-cycle over a uniform refinement
hierarchy of an unstructured tri3, quad4, tet4 or hex8 mesh (see its
notes).  Both share:

* levels: cell counts halved per level while even (at most 6 levels);
* level operators: rediscretized constant-coefficient linear elasticity
  (the u-independent small-strain Hessian), built once per model;
* smoother: damped Jacobi (symmetric pre/post sweeps);
* transfers: restriction R = Pᵀ and the P1/Q1 prolongation P of the refinement;
* Dirichlet constraints masked at every level (restricted by injection).

The structured V-cycle runs in grid layout ``[s, z, y, x]``; only its
:meth:`~StructuredMGPreconditioner.__call__` converts from and to flat
dof vectors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from .assembly.global_ import scatter_add_rows, scatter_plan
from .solid import LameParameters, LinearElasticMaterial

__all__ = ["StructuredMGPreconditioner", "GeometricMGPreconditioner", "rcm_refined_hierarchy"]


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


# ---------------------------------------------------------------------------
# Unstructured geometric multigrid over a refinement hierarchy
# ---------------------------------------------------------------------------


def rcm_refined_hierarchy(coarse_mesh, levels: int, device="cuda"):
    """Refine ``levels`` times, then RCM-reorder the finest mesh (the RCM runs on ``device``).

    Returns ``(fine_mesh, fine_permutation)``: the bandwidth-reduced fine
    mesh to build the (banded) model on, and the ``new -> old`` vertex
    relabeling to hand to ``GeometricMGPreconditioner(fine_permutation=...)``.
    """
    from .config import resolve_device
    from .mesh.refinement import refine_uniformly_repeat
    from .mesh.reorder import reorder_mesh

    dev = resolve_device(device)
    fine = refine_uniformly_repeat(coarse_mesh, levels)
    return reorder_mesh(fine, device=dev)


def _prolong_unstructured(parents, weights, u_c):
    """Apply P: coarse nodal field ``[Nc, s]`` -> fine ``[Nf, s]``."""
    return (weights[:, :, None] * u_c[parents]).sum(1)


def _restrict_unstructured(plan: "_RestrictPlan", r_f, num_coarse: int):
    """Apply Pᵀ: fine nodal field ``[Nf, s]`` -> coarse ``[Nc, s]``.

    ``plan`` scatters the nonzero (fine node, slot) entries of the
    prolongation, in row order, to their coarse parents (the JAX
    package's ``segment_sum``), deterministically: no float atomics.
    """
    rows = plan.weights[:, None] * r_f[plan.row_of]
    return scatter_add_rows(r_f.new_zeros((num_coarse, r_f.shape[-1])), plan.scatter, rows)


class _RestrictPlan:
    """The nonzero entries of a prolongation, ready for the restriction's scatter."""

    def __init__(self, parents: np.ndarray, weights: np.ndarray, dtype, device):
        fine, slot = np.nonzero(weights)
        self.row_of = torch.as_tensor(fine, device=device)
        self.scatter = scatter_plan(torch.as_tensor(parents[fine, slot].astype(np.int64), device=device))
        self.weights = torch.as_tensor(weights[fine, slot], dtype=dtype, device=device)


@dataclass(eq=False)
class GeometricMGPreconditioner:
    """Matrix-free geometric V-cycle for unstructured hyperelastic models.

    The caller supplies the coarse mesh whose ``levels``-fold uniform
    refinement (:func:`~.mesh.refinement.refine_uniformly_repeat`) produced
    the model's mesh.  Transfers come from the refinement's sparse
    prolongation (:func:`~.mesh.refinement.prolongation_for_refinement`,
    restriction its transpose); every level's operator is a rediscretized
    constant-coefficient linear-elastic Hessian (a
    :class:`~.elasticity.HyperelasticModel` with
    :class:`~.solid.LinearElasticMaterial` and the mean Lamé parameters,
    built on the model's device), so the preconditioner is u-independent
    and built once per model.

    ``fine_permutation`` is the ``new -> old`` vertex relabeling that
    produced ``model.mesh`` from the refinement (see
    :func:`rcm_refined_hierarchy`): transfers and Dirichlet sets are
    relabeled into the model's ordering, so the V-cycle runs on the RCM
    mesh with no permutation in the hot path.  ``banded=True`` RCM-reorders
    the intermediate levels too (on the model's device) and gives every
    level the banded gather/scatter (the gather and scatter kernels for f32
    levels on the card; the element math is the plain sweep, as in the JAX
    package, though the fused kernels would take the levels' linear-elastic
    operators: running them there is a later performance change).
    Smoothing is unrolled damped Jacobi.
    """

    model: Any  # HyperelasticModel on the fine mesh
    coarse_mesh: Any  # Mesh whose `levels`-fold refinement is model.mesh
    levels: int
    num_smooth: int = 2
    omega: float = 0.5
    coarse_iters: int = 40
    #: new -> old vertex relabeling of the finest mesh (None: refinement ordering)
    fine_permutation: Optional[Any] = None
    #: per-level banded gather/scatter (requires ``fine_permutation``)
    banded: bool = False

    def __post_init__(self):
        from .elasticity import HyperelasticModel
        from .mesh.refinement import prolongation_for_refinement, refine_uniformly
        from .mesh.reorder import reorder_mesh

        m = self.model
        s = m.mesh.dim
        dtype, dev = m.dtype, m.device
        # scalar Lamé parameters for the rediscretized levels (the port's models take scalars only)
        mu, lam = float(np.mean(np.asarray(m.params.mu))), float(np.mean(np.asarray(m.params.lam)))
        dirichlet_f = (np.asarray(m.dirichlet_nodes, dtype=np.int64) if m.dirichlet_nodes is not None
                       else np.zeros(0, dtype=np.int64))

        meshes = [self.coarse_mesh]
        transfers = []  # per refinement step: (parents, weights)
        for _ in range(self.levels):
            transfers.append(prolongation_for_refinement(meshes[-1]))
            meshes.append(refine_uniformly(meshes[-1]))
        if meshes[-1].num_vertices != m.mesh.num_vertices:
            raise ValueError(
                "coarse_mesh refined `levels` times does not match the model mesh "
                f"({meshes[-1].num_vertices} vs {m.mesh.num_vertices} vertices)"
            )
        if self.banded and self.fine_permutation is None:
            raise ValueError("banded=True needs fine_permutation: refinement ordering is not "
                             "bandwidth-reduced (use rcm_refined_hierarchy)")

        # per-level relabelings new -> old (None = identity); in the old
        # labels (refinement order) coarse nodes are a prefix of fine nodes
        perms: List[Any] = [None] * (self.levels + 1)
        if self.fine_permutation is not None:
            pf = np.asarray(self.fine_permutation, dtype=np.int64)
            if pf.shape != (m.mesh.num_vertices,):
                raise ValueError("fine_permutation must be a [num_vertices] new->old map")
            perms[self.levels] = pf
            meshes[self.levels] = m.mesh
            if self.banded:
                # intermediate levels get their own RCM (the coarse level keeps the caller's order)
                for li in range(1, self.levels):
                    meshes[li], perms[li] = reorder_mesh(meshes[li], device=dev)

        def inv_of(p):
            if p is None:
                return None
            inv = np.empty(len(p), dtype=np.int64)
            inv[p] = np.arange(len(p), dtype=np.int64)
            return inv

        invs = [inv_of(p) for p in perms]
        # transfers in the level orderings: rows follow the fine level's new
        # order, entries map through the coarse level's old -> new relabeling
        rel_transfers = []
        for li in range(self.levels):
            par, wts = transfers[li]
            par, wts = np.asarray(par, dtype=np.int64), np.asarray(wts)
            if perms[li + 1] is not None:
                par, wts = par[perms[li + 1]], wts[perms[li + 1]]
            if invs[li] is not None:
                par = invs[li][par]
            rel_transfers.append((par, wts))

        # Dirichlet nodes of the finest mesh in refinement (old) labels
        dir_old = perms[self.levels][dirichlet_f] if perms[self.levels] is not None else dirichlet_f

        # fine -> coarse (levels_data[0] = finest)
        self.levels_data: List[dict] = []
        for li in range(self.levels, -1, -1):
            mesh_l = meshes[li]
            # refinement appends vertices: constraints restrict by injection
            dirichlet_l = dir_old[dir_old < mesh_l.num_vertices]
            if invs[li] is not None:
                dirichlet_l = invs[li][dirichlet_l]
            lin = HyperelasticModel(
                mesh=mesh_l,
                material=LinearElasticMaterial(),
                params=LameParameters(mu=mu, lam=lam),
                dirichlet_nodes=dirichlet_l,
                dtype=dtype,
                device=dev,
                banded=self.banded,
            )
            u0 = torch.zeros(lin.space.num_dofs, dtype=dtype, device=dev)
            entry = dict(model=lin, free=lin.free_mask, inv_diag=1.0 / lin.hessian_diagonal(u0),
                         num_vertices=mesh_l.num_vertices, s=s)
            if li > 0:
                par, wts = rel_transfers[li - 1]
                entry["parents"] = torch.as_tensor(par, device=dev)
                entry["weights"] = torch.as_tensor(wts, dtype=dtype, device=dev)
                entry["restrict"] = _RestrictPlan(par, wts, dtype, dev)
            self.levels_data.append(entry)

    def _apply(self, lvl, v):
        L = self.levels_data[lvl]
        vm = torch.where(L["free"], v, 0.0)
        # linear material: Hessian action == internal forces (u-independent)
        return torch.where(L["free"], L["model"].internal_forces(vm), v)

    def _smooth(self, lvl, x, b, iters):
        L = self.levels_data[lvl]
        for _ in range(int(iters)):
            x = x + self.omega * L["inv_diag"] * (b - self._apply(lvl, x))
        return x

    def _vcycle(self, lvl, b):
        x = self._smooth(lvl, torch.zeros_like(b), b, self.num_smooth)
        if lvl == len(self.levels_data) - 1:
            return self._smooth(lvl, x, b, self.coarse_iters)
        L, Lc = self.levels_data[lvl], self.levels_data[lvl + 1]
        s = L["s"]
        r = (b - self._apply(lvl, x)).reshape(-1, s)
        r_c = _restrict_unstructured(L["restrict"], r, Lc["num_vertices"]).reshape(-1)
        e_c = self._vcycle(lvl + 1, torch.where(Lc["free"], r_c, 0.0))
        e = _prolong_unstructured(L["parents"], L["weights"], e_c.reshape(-1, s)).reshape(-1)
        x = x + torch.where(L["free"], e, 0.0)
        return self._smooth(lvl, x, b, self.num_smooth)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        """Apply the V-cycle preconditioner: M^{-1} r."""
        return self._vcycle(0, r)
