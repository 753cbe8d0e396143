"""Unstructured hyperelasticity: residual, Hessian and the Newton–Krylov solves.

Counterpart of ``HyperelasticModel`` in ``fenris_tpu/elasticity.py``.  Two
inner solvers:

* **matrix-free** (the default): CG on the Hessian action, preconditioned
  by Jacobi from :meth:`HyperelasticModel.hessian_diagonal`.  With
  ``banded=True`` the element data moves through the banded gather and
  scatter (:mod:`.ops.banded`) in the padded row layout; with
  ``fused_kernels=True`` as well, the element math of the internal forces
  and of the Hessian action runs in the fused element-sweep kernels
  (:mod:`.ops.em_sweep`), which read the node vectors through the plan
  themselves, on a CUDA f32 model, and in their plain versions on the CPU;
* **assembled** (``assembled=True``): each Newton step assembles the
  tangent stiffness into the block-DIA layout (:mod:`.sparse.block_dia`)
  and CG runs on the band sweep (:mod:`.sparse.dia_kernel`), preconditioned
  by Jacobi read off the zero band.

Dirichlet conditions are dof masking, as in the JAX package: constrained
residual entries are zero and the Hessian action is ``mask ∘ H ∘ mask +
(I - mask)``.  Element sweeps run in chunks of ``chunk_size`` elements
(on the banded path, of whole blocks); every global sum is taken in a
fixed order (the layered scatter of :mod:`.assembly.global_` or the banded
scatter), so results are bitwise reproducible on the card.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .assembly.global_ import apply_homogeneous_dirichlet_bc_csr, assemble_csr, scatter_add_rows, scatter_plan
from .assembly.local import (
    _is_array,
    assemble_element_elliptic_matrices,
    assemble_element_elliptic_matrices_pairs,
    assemble_element_elliptic_vectors,
    assemble_element_source_vectors,
    compute_element_elliptic_energy,
    slice_params,
    tabulate,
)
from .assembly.local_em import (
    assemble_element_elliptic_vectors_em,
    compute_element_elliptic_energy_em,
    elliptic_matrix_diagonal_em,
)
from .config import DEFAULT_DTYPE, resolve_device
from .fem import FemSpace
from .mesh import Mesh
from .ops import em_sweep
from .ops.banded import gather, make_banded_plan, scatter_add
from .optimize import NewtonResult, mixed_precision_newton, newton_line_search
from .quadrature import canonical_stiffness
from .solid import HyperelasticMaterial, MaterialEllipticOperator
from .sparse.block_dia import (
    BlockDiaMatrix,
    _scatter_dia,
    assemble_block_dia,
    band_expand_plan,
    block_dia_assembly_plan,
    expand_rows_pairs_masked,
)
from .sparse.block_ell import BlockEllMatrix
from .sparse.cg import conjugate_gradient
from .sparse.dia_kernel import block_dia_operator

__all__ = ["HyperelasticModel"]

# streamed band assembly: budget of the per-chunk [n*chunk, R] expansion
# transient and the chunk floor (module-level so tests can reach the
# capped branch at toy sizes)
_STREAM_EXPAND_BUDGET_BYTES = 6e8
_STREAM_CHUNK_FLOOR = 8192


@dataclass(eq=False)
class HyperelasticModel:
    """A hyperelastic solid on an unstructured mesh.

    Args:
        mesh: volumetric mesh of any 2D or 3D element (solution dim = geometry dim).
        material: a :class:`~.solid.HyperelasticMaterial`.
        params: material parameters (e.g. :class:`~.solid.LameParameters`):
            scalars, per-element ``[E]`` leaves (in the mesh's element order),
            per-point ``[E, q]`` leaves (not with ``banded=True``, which raises
            ``ValueError``) or constants, by the JAX package's leaf rules
            (:mod:`.assembly.local`).  Array leaves are converted once to the
            model's dtype and device, and 0-d ones to numbers; the JAX package
            keeps their dtype (an f64 leaf in an f32 model's ``solve_mixed``
            raises a ``TypeError`` there).
        rule: quadrature rule (default: the canonical stiffness rule).
        dirichlet_nodes: nodes with homogeneous Dirichlet conditions.
        body_force: constant ``[d]`` body force, a pointwise torch callable
            ``f(x [d], params) -> [d]`` (called with ``params=None``, as the
            JAX package calls it), or None.
        dtype/device: of every tensor the model holds and returns (the
            default device is the card; CPU callers pass ``device="cpu"``).
        chunk_size: elements per sweep chunk (None: automatic, as in JAX).
        banded: move element data through the banded gather/scatter
            (:mod:`.ops.banded`); needs a bandwidth-reduced node numbering
            (:func:`.mesh.reorder.reorder_mesh`).
        banded_r_nodes: owned node range per banded block (a multiple of 1024).
        fused_kernels: run the element math of the internal forces and the
            Hessian action in the fused element-sweep kernels
            (:mod:`.ops.em_sweep`); needs ``banded=True``.  The kernels take
            f32 Neo-Hookean, StVK and linear-elastic models with scalar or
            per-element ``[E]`` Lamé parameters on tet4, tet10, tet20, hex8,
            hex20, hex27, quad4, quad8, quad9, tri3 and tri6; a CUDA model
            they do not take (f64, another material, another dimension or
            element) raises ``NotImplementedError``; on the CPU the
            kernels' plain versions run.
    """

    mesh: Mesh
    material: HyperelasticMaterial
    params: Any
    rule: Any = None
    dirichlet_nodes: Any = None
    body_force: Any = None
    dtype: torch.dtype = DEFAULT_DTYPE
    chunk_size: Optional[int] = None
    banded: bool = False
    banded_r_nodes: int = 4096
    fused_kernels: bool = False
    device: Any = "cuda"  # after the JAX package's fields: its positional calls carry over

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.fused_kernels and not self.banded:
            raise ValueError("fused_kernels=True runs the element sweeps of the banded path: pass banded=True")
        d = self.mesh.dim
        self.operator = MaterialEllipticOperator(self.material, dim=d)
        rule = self.rule if self.rule is not None else canonical_stiffness(self.mesh.element.name)
        self.tab = tabulate(self.mesh.element, rule)
        E = self.mesh.num_cells
        self._params = pytree.tree_map(self._param_leaf, self.params)
        if self.banded and any(
            _is_array(x) and x.shape[0] == E and x.ndim >= 2 and x.shape[1] == self.tab.num_points
            for x in pytree.tree_leaves(self._params)
        ):
            raise ValueError(
                "per-quadrature-point parameter leaves ([E, q, ...]) are not supported on the banded path; "
                "use banded=False or per-element ([E] / [E, k]) params"
            )
        if self.fused_kernels and self.device.type == "cuda":
            missing = em_sweep.refusal(self.operator, self._params, self.tab, self.dtype, E)
            if missing is not None:
                raise NotImplementedError(f"fused_kernels=True on the card: the element-sweep kernels need {missing}")
        if self.chunk_size is None:
            # keep the (element, qp, d^4)-sized intermediates ~1 GB class
            budget = 2**28
            per_el = self.tab.num_points * (d**4 + 2 * self.mesh.element.num_nodes * d)
            max_els = max(4096, budget // max(per_el, 1))
            if self.mesh.num_cells > max_els:
                self.chunk_size = int(max_els)
        self.space = FemSpace.create(self.mesh, d, self.dtype, self.device)
        mask = np.ones(self.space.num_dofs, dtype=bool)
        if self.dirichlet_nodes is not None and len(self.dirichlet_nodes):
            nd = np.asarray(self.dirichlet_nodes, dtype=np.int64)
            for i in range(d):
                mask[nd * d + i] = False
        self.free_mask = torch.as_tensor(mask, device=self.device)
        self._cells = torch.as_tensor(self.mesh.cells, dtype=torch.int64, device=self.device)
        self._plan = None
        if self.banded:
            self._setup_banded()
        else:
            # element rows e-major -> node rows, in collision-free layers
            self._node_scatter = scatter_plan(self._cells.reshape(-1))
        self._dia_plans = {}
        self._dia_expand_plans = {}
        self._f_ext = self._assemble_external_forces()

    def _param_leaf(self, x):
        """A parameter leaf as the model holds it: arrays on its device in its dtype, 0-d ones as numbers."""
        if isinstance(x, (torch.Tensor, np.ndarray, np.number)):
            if np.ndim(x) == 0:
                return float(x)
            return torch.as_tensor(x, dtype=self.dtype, device=self.device).contiguous()
        return x

    def _params_at(self, index):
        """The parameters of the elements ``index`` (a slice or index tensor) in mesh order."""
        return slice_params(self._params, self.mesh.num_cells, index)

    # -- banded path ----------------------------------------------------------------

    def _setup_banded(self):
        """The banded plan, padded geometry ``[m, d, E_pad]``, chunking in whole blocks and,
        with ``fused_kernels``, the element-sweep kernels' tables on the model's device."""
        N = self.mesh.num_vertices
        r = min(self.banded_r_nodes, max(1024, -(-N // 1024) * 1024))
        plan = make_banded_plan(self.mesh.cells, N, s=self.mesh.dim, r_nodes=r, device=self.device)
        self._plan = plan
        index = torch.as_tensor(plan.element_index, device=self.device)
        self._X_band = self.space.X_geo[index].permute(1, 2, 0).contiguous()  # [m, d, E_pad]
        # per-element leaves in the padded order: a padding element takes its filler's values
        self._params_band = self._params_at(index)
        self._valid_el = torch.as_tensor(plan.valid_elements(), dtype=self.dtype, device=self.device)
        bp = plan.elements_per_block
        g = max(1, self.chunk_size // bp) if self.chunk_size is not None else plan.k_blocks
        self._band_chunk = min(g, plan.k_blocks) * bp
        self._em_tables = em_sweep.device_tables(self.tab, self.device) if self.fused_kernels else None

    def _banded_sweep(self, assemble, *els):
        """``assemble(X [m, d, c], *els [n, s, c], params) -> [..., c]`` over chunks of whole blocks.

        ``els`` are element-minor views of gathered rows, ``params`` the
        chunk's parameters; the chunk results are joined along the element
        axis (``[..., E_pad]``).
        """
        pe = self._plan.padded_elements
        X, c = self._X_band, self._band_chunk
        parts = [
            assemble(X[..., e0 : e0 + c], *(a[..., e0 : e0 + c] for a in els),
                     slice_params(self._params_band, pe, slice(e0, e0 + c)))
            for e0 in range(0, pe, c)
        ]
        return parts[0] if len(parts) == 1 else torch.cat(parts, -1)

    def _gather_em(self, u):
        """Element-minor view ``[n, s, E_pad]`` of the banded gather of ``u``."""
        return gather(self._plan, u.reshape(-1, self.mesh.dim)).permute(1, 2, 0)

    def _scatter_em(self, f_em):
        """Global dof vector from element-minor ``[n, s, E_pad]`` element vectors."""
        return scatter_add(self._plan, f_em.permute(2, 0, 1).contiguous()).reshape(-1)

    def _tangent_sweep(self, u, v):
        """Fused Hessian action: :func:`~.ops.em_sweep.banded_tangent_sweep` -> banded scatter.

        The material's closed-form ``g_tangent`` in place of forward-mode AD
        over the internal forces: no primal force computation.  One sweep
        reads ``u`` and ``v`` through the banded plan (no gathered rows) and
        writes the element-major rows the scatter reads.
        """
        d = self.mesh.dim
        rows = em_sweep.banded_tangent_sweep(
            self._plan, self._X_band, u.reshape(-1, d), v.reshape(-1, d),
            self.operator, self._params_band, self.tab, self._em_tables,
        )
        return scatter_add(self._plan, rows).reshape(-1)

    # -- element sweeps -----------------------------------------------------------

    def _chunks(self):
        """Element ranges of the sweeps (one range when unchunked)."""
        E = self.mesh.num_cells
        c = self.chunk_size or max(E, 1)
        return [(e0, min(e0 + c, E)) for e0 in range(0, E, c)]

    def _local(self, u, e0=0, e1=None):
        n, s = self.mesh.element.num_nodes, self.mesh.dim
        return u[self.space.dofs[e0:e1]].reshape(-1, n, s)

    def _scatter_nodes(self, f_el):
        """Global dof vector from element vectors ``[E, n*s]`` (deterministic)."""
        s = self.mesh.dim
        out = f_el.new_zeros((self.mesh.num_vertices, s))
        return scatter_add_rows(out, self._node_scatter, f_el.reshape(-1, s)).reshape(-1)

    def _sweep_vector(self, u):
        """Internal forces: element vectors chunk by chunk, then one scatter.

        The fused path runs :func:`~.ops.em_sweep.banded_vector_sweep`, which
        reads ``u`` through the banded plan (no gather) and writes the
        element-major rows the scatter reads.
        """
        op, tab = self.operator, self.tab
        if self.fused_kernels:
            rows = em_sweep.banded_vector_sweep(
                self._plan, self._X_band, u.reshape(-1, self.mesh.dim), op, self._params_band, tab, self._em_tables
            )
            return scatter_add(self._plan, rows).reshape(-1)
        if self._plan is not None:
            f = self._banded_sweep(
                lambda X, ue, p: assemble_element_elliptic_vectors_em(X, ue, op, p, tab), self._gather_em(u)
            )
            return self._scatter_em(f)
        X = self.space.X_geo
        f_el = torch.cat(
            [
                assemble_element_elliptic_vectors(X[e0:e1], self._local(u, e0, e1), op, self._params_at(slice(e0, e1)), tab)
                for e0, e1 in self._chunks()
            ]
        )
        return self._scatter_nodes(f_el)

    def _assemble_external_forces(self):
        if self.body_force is None:
            return torch.zeros(self.space.num_dofs, dtype=self.dtype, device=self.device)
        s = self.mesh.dim
        if self._plan is not None:
            n = self.mesh.element.num_nodes

            def source(Xc, _):
                b = assemble_element_source_vectors(Xc.permute(2, 0, 1), self.body_force, None, s, self.tab)
                return b.to(self.dtype).reshape(-1, n, s).permute(1, 2, 0)

            return self._scatter_em(self._banded_sweep(source))
        X = self.space.X_geo
        b_el = torch.cat(
            [assemble_element_source_vectors(X[e0:e1], self.body_force, None, s, self.tab) for e0, e1 in self._chunks()]
        )
        return self._scatter_nodes(b_el.to(self.dtype))

    def energy(self, u):
        """Total potential energy E(u) = ∫ψ(∇u) − f_ext·u."""
        op, tab = self.operator, self.tab
        if self._plan is not None:
            e = self._banded_sweep(
                lambda X, ue, p: compute_element_elliptic_energy_em(X, ue, op, p, tab), self._gather_em(u)
            )
            return (e * self._valid_el).sum() - torch.dot(self._f_ext, u)
        X = self.space.X_geo
        e = sum(
            compute_element_elliptic_energy(X[e0:e1], self._local(u, e0, e1), op, self._params_at(slice(e0, e1)), tab).sum()
            for e0, e1 in self._chunks()
        )
        return e - torch.dot(self._f_ext, u)

    def internal_forces(self, u):
        return self._sweep_vector(u)

    def residual(self, u):
        """Masked residual ∇E(u): Dirichlet dofs are zero."""
        return torch.where(self.free_mask, self.internal_forces(u) - self._f_ext, 0.0)

    def hessian_vector_product(self, u, v):
        """Exact Hessian action, masked.

        The fused path takes the closed-form tangent sweep; every other
        path forward-mode AD (``torch.func.jvp``) of the internal forces.
        """
        vm = torch.where(self.free_mask, v, 0.0)
        if self.fused_kernels:
            hv = self._tangent_sweep(u, vm)
        else:
            _, hv = torch.func.jvp(self.internal_forces, (u,), (vm,))
        return torch.where(self.free_mask, hv, v)

    def hessian_operator(self, u):
        """Hessian action ``v -> H(u) v`` for repeated use at one ``u`` (the CG operator).

        The fused path applies the closed-form tangent sweep; every other
        path forward-mode AD per application, where the JAX package traces
        a linearization once.  ``torch.func.linearize`` traces each
        elementwise op through ``make_fx``: for the unfused banded model at
        250,047 cells its one trace costs more than it saves at the CG
        iterations a Newton step that solve takes (``chip_smoke.py`` path C3
        times both on the card; PERF.md section 6 keeps the numbers under
        "jvp against linearize at C3").
        """
        return lambda v: self.hessian_vector_product(u, v)

    def hessian_diagonal(self, u):
        """Assembled Hessian diagonal (the Jacobi preconditioner), 1 on constrained dofs."""
        n, s = self.mesh.element.num_nodes, self.mesh.dim
        op, tab = self.operator, self.tab
        if self._plan is not None:
            d = self._banded_sweep(
                lambda X, ue, p: elliptic_matrix_diagonal_em(X, ue, op, p, tab), self._gather_em(u)
            )
            diag = self._scatter_em(d)
        elif self.chunk_size is None:
            diag = self._scatter_nodes(torch.diagonal(self.assemble_hessian_matrices(u), dim1=1, dim2=2))
        else:
            X = self.space.X_geo
            d_em = torch.cat(
                [
                    elliptic_matrix_diagonal_em(
                        X[e0:e1].permute(1, 2, 0), self._local(u, e0, e1).permute(1, 2, 0), op,
                        self._params_at(slice(e0, e1)), tab,
                    )
                    for e0, e1 in self._chunks()
                ],
                -1,
            )
            diag = self._scatter_nodes(d_em.permute(2, 0, 1).reshape(-1, n * s))
        return torch.where(self.free_mask & (diag != 0.0), diag, 1.0)

    def assemble_hessian_matrices(self, u, chunk: Optional[int] = None):
        """Element Hessian blocks ``[E, n*s, n*s]``."""
        return assemble_element_elliptic_matrices(
            self.space.X_geo, self._local(u), self.operator, self._params, self.tab, chunk=chunk
        )

    def assemble_hessian_csr(self, u) -> torch.Tensor:
        """CSR values of the Hessian on ``space.pattern``, the Dirichlet dofs eliminated (``elasticity.py:660``)."""
        values = assemble_csr(self.assemble_hessian_matrices(u), self.space.pattern)
        if self.dirichlet_nodes is not None and len(self.dirichlet_nodes):
            values = apply_homogeneous_dirichlet_bc_csr(values, self.space.pattern, self.dirichlet_nodes)
        return values

    # -- block-DIA assembly -------------------------------------------------------

    def block_dia_plan(self, max_diagonals=None, min_fill: float = 0.0):
        """Cached element→block-DIA assembly plan, built on the model's device."""
        key = (max_diagonals, float(min_fill))
        if key not in self._dia_plans:
            plan = block_dia_assembly_plan(
                self._cells, self.mesh.num_vertices, self.mesh.dim,
                max_diagonals=max_diagonals, min_fill=min_fill, device=self.device,
            )
            band_bytes = (plan.num_diagonals + plan.rem_k) * plan.solution_dim**2 * plan.num_nodes * self.space.X_geo.element_size()
            if plan.num_diagonals > 512 or band_bytes > 2**33:
                # a band costs s*s*N values whatever its population
                warnings.warn(
                    f"block-DIA plan keeps {plan.num_diagonals} diagonals (~{band_bytes / 2**30:.1f} GiB "
                    f"of bands, fill {plan.fill:.3f}): the node ordering is not locality-preserving; "
                    "reorder the mesh or pass min_fill/max_diagonals",
                    stacklevel=2,
                )
            self._dia_plans[key] = plan
        return self._dia_plans[key]

    def block_dia_expand_plan(self, max_diagonals=None, min_fill: float = 0.0):
        """Cached class-static band expansion plan (or None for irregular meshes)."""
        key = (max_diagonals, float(min_fill))
        if key not in self._dia_expand_plans:
            self._dia_expand_plans[key] = band_expand_plan(
                self._cells, self.block_dia_plan(*key), device=self.device
            )
        return self._dia_expand_plans[key]

    def assemble_hessian_block_dia(self, u, max_diagonals=None, min_fill: float = 0.0) -> BlockDiaMatrix:
        """Tangent stiffness in the block-DIA layout (no Dirichlet conditions).

        ``where(free, A @ where(free, v, 0), v)`` equals
        :meth:`hessian_vector_product` to assembly-order roundoff.
        """
        plan = self.block_dia_plan(max_diagonals, min_fill)
        expand = self.block_dia_expand_plan(max_diagonals, min_fill)
        E = self.mesh.num_cells
        nd = self.mesh.element.num_nodes * self.mesh.dim
        if expand is not None and self.chunk_size is not None and E > self.chunk_size:
            # streamed: the full [E, nd, nd] buffer never materializes
            return self._assemble_block_dia_streamed(u, plan, expand)
        mat_chunk = self.chunk_size
        if mat_chunk is None and E * nd * nd > 2**27:
            mat_chunk = 8192  # bound the contraction transients
        A_el = self.assemble_hessian_matrices(u, chunk=mat_chunk)
        num_chunks = -(-(E * nd * nd) // 2**27)
        return assemble_block_dia(plan, A_el, num_chunks=num_chunks, expand=expand)

    def _stream_chunk(self, expand) -> int:
        """Stream chunk: the model's chunk, capped so the expansion transient stays ~0.6 GB."""
        n = self.mesh.element.num_nodes
        R = int(expand.src.shape[-1])
        cap = max(_STREAM_CHUNK_FLOOR, int(_STREAM_EXPAND_BUDGET_BYTES // (n * R * self.space.X_geo.element_size())))
        return min(self.chunk_size, cap)

    def _assemble_block_dia_streamed(self, u, plan, expand) -> BlockDiaMatrix:
        """Chunked pairs-layout element matrices expanded and scattered into bands.

        Equal to ``assemble_block_dia(plan, assemble_hessian_matrices(u),
        expand=expand)`` to summation-order roundoff, with one ``[N, R]``
        accumulator plus one chunk's transients in memory.
        """
        n, s = self.mesh.element.num_nodes, self.mesh.dim
        N, D, kr = plan.num_nodes, plan.num_diagonals, plan.rem_k
        E = self.mesh.num_cells
        R = int(expand.src.shape[-1])
        X = self.space.X_geo
        u2 = u.to(self.dtype)
        mask = expand.class_mask.to(self.dtype)
        c = self._stream_chunk(expand)
        acc = X.new_zeros((N, R))
        for e0 in range(0, E, c):
            e1 = min(e0 + c, E)
            vals = assemble_element_elliptic_matrices_pairs(
                X[e0:e1], self._local(u2, e0, e1), self.operator, self._params_at(slice(e0, e1)), self.tab
            )
            rows, ids = expand_rows_pairs_masked(vals, expand.cols[e0:e1], mask[:, e0:e1], expand.src)
            del vals
            scatter_add_rows(acc, scatter_plan(ids), rows, inplace=True)
            del rows
        bands = acc.T.contiguous()
        del acc
        total = (D + kr) * s * s * N
        rem_blocks = X.new_zeros((kr * s * s, N)) if kr else None
        if expand.slow_idx is not None:
            # the slow subset can be O(E/2): bounded chunks of element matrices
            flat = X.new_zeros(total)
            slow = expand.slow_idx
            for lo in range(0, len(slow), 8192):
                idx = slow[lo : lo + 8192]
                u_el = u2[self.space.dofs[idx]].reshape(-1, n, s)
                A_s = assemble_element_elliptic_matrices(X[idx], u_el, self.operator, self._params_at(idx), self.tab)
                _scatter_dia(A_s, plan.base[idx], flat, s, N)
            bands = bands + flat[: D * s * s * N].reshape(D * s * s, N)
            if kr:
                rem_blocks = flat[D * s * s * N :].reshape(kr * s * s, N)
        remainder = None
        if kr:
            remainder = BlockEllMatrix(neighbors=plan.rem_neighbors, blocks=rem_blocks, num_nodes=N, solution_dim=s)
        return BlockDiaMatrix(offsets=plan.offsets, bands=bands, num_nodes=N, solution_dim=s, remainder=remainder)

    def assembled_hessian_operator(self, u, max_diagonals=None, min_fill: float = 0.0,
                                   layout: str = "dof", kernel="auto"):
        """``(hvp, inv_diag)`` from one assembled block-DIA Hessian.

        The Jacobi diagonal is read off the zero-offset band.
        ``layout="component"``: the operator acts on ``[s, N]`` arrays, the
        form CG iterates on; ``"dof"``: node-major flat vectors.
        ``kernel`` as in :func:`~.sparse.dia_kernel.block_dia_operator`.
        """
        m = self.assemble_hessian_block_dia(u, max_diagonals, min_fill)
        s, N = m.solution_dim, m.num_nodes
        d0 = m.offsets.index(0)
        mv = block_dia_operator(m, layout=layout, kernel=kernel)
        if layout == "component":
            diag2 = torch.stack([m.bands[(d0 * s + i) * s + i] for i in range(s)], 0)  # [s, N]
            free2 = self.free_mask.reshape(N, s).T.contiguous()
            inv_diag2 = 1.0 / torch.where(free2 & (diag2 != 0.0), diag2, 1.0)

            def hvp_cm(v2):
                return torch.where(free2, mv(torch.where(free2, v2, 0.0)), v2)

            return hvp_cm, inv_diag2
        diag = torch.stack([m.bands[(d0 * s + i) * s + i] for i in range(s)], 1).reshape(-1)
        free = self.free_mask
        inv_diag = 1.0 / torch.where(free & (diag != 0.0), diag, 1.0)

        def hvp(v):
            return torch.where(free, mv(torch.where(free, v, 0.0)), v)

        return hvp, inv_diag

    # -- solve ----------------------------------------------------------------------

    def _matrix_free_cg(self, u, f, preconditioner, rel_tolerance, max_iter):
        """One matrix-free inner solve: Jacobi from :meth:`hessian_diagonal` unless given."""
        hvp = self.hessian_operator(u)
        if preconditioner is None:
            inv_diag = 1.0 / self.hessian_diagonal(u)
            preconditioner = lambda v: inv_diag * v  # noqa: E731
        return conjugate_gradient(
            hvp, f, preconditioner=preconditioner,
            rel_tolerance=rel_tolerance, max_iter=max_iter, check_definiteness=False,
        )

    def _inner_cg(self, u, f, preconditioner, assembled, max_diagonals, min_fill, rel_tolerance, max_iter):
        if assembled:
            return self._assembled_cg(u, f, preconditioner, max_diagonals, min_fill, rel_tolerance, max_iter)
        return self._matrix_free_cg(u, f, preconditioner, rel_tolerance, max_iter)

    def _assembled_cg(self, u, f, preconditioner, max_diagonals, min_fill, rel_tolerance, max_iter):
        """One assembled inner solve; component-major CG when Jacobi preconditions."""
        if preconditioner is None:
            s = self.mesh.dim
            hvp2, inv_diag2 = self.assembled_hessian_operator(u, max_diagonals, min_fill, layout="component")
            f2 = f.reshape(-1, s).T.contiguous()
            cg = conjugate_gradient(
                hvp2, f2, preconditioner=lambda v: inv_diag2 * v,
                rel_tolerance=rel_tolerance, max_iter=max_iter, check_definiteness=False,
            )
            return cg._replace(x=cg.x.T.reshape(-1))
        hvp, _ = self.assembled_hessian_operator(u, max_diagonals, min_fill)
        return conjugate_gradient(
            hvp, f, preconditioner=preconditioner,
            rel_tolerance=rel_tolerance, max_iter=max_iter, check_definiteness=False,
        )

    def solve(
        self,
        u0=None,
        tolerance: float = 1e-8,
        max_newton_iterations: int = 30,
        cg_rel_tolerance: float = 1e-6,
        cg_max_iter: int = 2000,
        line_search: bool = True,
        preconditioner: Optional[Callable] = None,
        assembled: bool = False,
        dia_max_diagonals: Optional[int] = None,
        dia_min_fill: float = 0.0,
        callback: Optional[Callable] = None,
    ) -> NewtonResult:
        """Newton–Krylov solve of ∇E(u) = 0.

        Inner solve: CG on the matrix-free Hessian action
        (:meth:`hessian_operator`), with Jacobi from
        :meth:`hessian_diagonal` or a u-independent ``preconditioner``
        callable.  ``assembled=True`` assembles the tangent into block-DIA
        each Newton step and runs CG on it, component-major with Jacobi
        from the zero band (the default) or node-major with
        ``preconditioner``.  ``callback(k, residual_norm, cg)`` as in
        :meth:`~.structured.StructuredHyperelasticModel.solve`.
        """
        if u0 is None:
            u0 = torch.zeros(self.space.num_dofs, dtype=self.dtype, device=self.device)
        last_cg = [None]

        def solve_jacobian(u, f):
            last_cg[0] = self._inner_cg(
                u, f, preconditioner, assembled, dia_max_diagonals, dia_min_fill, cg_rel_tolerance, cg_max_iter
            )
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
        cg_max_iter: int = 2000,
        preconditioner: Optional[Callable] = None,
        assembled: bool = False,
        dia_max_diagonals: Optional[int] = None,
        dia_min_fill: float = 0.0,
        verbose: bool = False,
        callback: Optional[Callable] = None,
    ) -> NewtonResult:
        """Mixed-precision Newton–Krylov: f64 outer residual, f32 inner CG.

        The outer residual and line search run on an f64 twin of this
        model on the plain sweeps (``banded`` and ``fused_kernels`` off,
        chunked at most 32768 elements); each inner solve runs on this (f32)
        model, matrix-free or assembled as in :meth:`solve`.  ``tolerance``
        is relative to the initial residual norm.  ``callback(k,
        residual_norm, cg)`` as in :meth:`solve`.
        """
        if self.dtype != torch.float32:
            raise ValueError("solve_mixed runs the inner CG on the f32 path; build the model in float32")
        chunk64 = self.chunk_size
        if self.mesh.num_cells > 32768:
            chunk64 = min(chunk64 or 32768, 32768)
        model64 = replace(self, dtype=torch.float64, banded=False, fused_kernels=False, chunk_size=chunk64)
        last_cg = [None]

        def inner_solve(k, u32, f32):
            cg = self._inner_cg(
                u32, f32, preconditioner, assembled, dia_max_diagonals, dia_min_fill, cg_rel_tolerance, cg_max_iter
            )
            last_cg[0] = cg
            if verbose:
                print(
                    f"[solve_mixed it {k}] cg iters={cg.num_iterations} status={cg.status} "
                    f"|r|={float(cg.residual_norm):.3e}",
                    flush=True,
                )
            return cg.x

        if u0 is None:
            u0 = torch.zeros(self.space.num_dofs, dtype=torch.float64, device=self.device)
        return mixed_precision_newton(
            model64.residual,
            inner_solve,
            u0,
            tolerance=tolerance,
            max_iterations=max_newton_iterations,
            verbose=verbose,
            callback=None if callback is None else lambda k, fn: callback(k, fn, last_cg[0] if k else None),
        )
