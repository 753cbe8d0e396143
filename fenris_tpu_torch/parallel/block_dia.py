"""Sharded block-DIA products and CG: node chunks over the ranks.

Counterpart of ``fenris_tpu/parallel/block_dia.py``.  The node axis of a
:class:`~..sparse.block_dia.BlockDiaMatrix` is split into
``chunk = ceil(N / world)`` nodes a rank (padded to ``chunk * world``), and
every band row splits with it: an offset-``o`` band of rank ``d`` reads
``x`` only on nodes ``[d*chunk - h_l, (d+1)*chunk + h_r)``, ``h_l``/``h_r``
the largest negative/positive offsets, which a bandwidth-reducing order
keeps small.  A product:

* takes the ``h_l`` last node rows of the rank below and the ``h_r`` first
  of the rank above in one exchange (:meth:`~._Comm.neighbours`; the
  ends of the chain get zeros, the zero padding of the single product);
* runs the band sweep on the rank's window: its bands are stored over the
  ``h_l + chunk + h_r`` window nodes, zero on the halo columns, so the
  band-sweep kernel (:mod:`..ops.dia_sweep`) takes them as they are on a
  CUDA f32 matrix, and its plain version runs elsewhere.

Vectors are sharded ``[chunk, s]`` node blocks; CG's inner products and
norms are scalar ``all_reduce``s.  A matrix with a block-ELL remainder, or
a halo wider than a chunk, is refused with the JAX package's errors.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..sparse.block_dia import BlockDiaMatrix
from ..sparse.cg import CgResult, _pcg
from ..sparse.dia_kernel import block_dia_operator
from . import _Comm

__all__ = ["ShardedBlockDia"]


@dataclass(eq=False)
class ShardedBlockDia:
    """Node-chunk sharded view of a :class:`~..sparse.block_dia.BlockDiaMatrix`.

    ``matvec``/``@``, ``jacobi_inverse_diagonal`` and ``cg`` take and
    return this rank's ``[chunk, s]`` block of padded node vectors;
    :meth:`to_sharded` and :meth:`to_flat` convert from and to the single
    matrix's flat node-major dof vectors.
    """

    matrix: BlockDiaMatrix
    mesh: DeviceMesh

    def __post_init__(self):
        m = self.matrix
        if m.remainder is not None:
            raise ValueError(
                "sharded block-DIA requires an exact-DIA matrix (no block-ELL "
                "remainder); rebuild the plan with min_fill=0/max_diagonals=None"
            )
        self._comm = _Comm(self.mesh, m.bands.device)
        self.n_dev = self._comm.size
        N, s = m.num_nodes, m.solution_dim
        self.chunk = -(-N // self.n_dev)
        self.N_pad = self.chunk * self.n_dev
        offs = m.offsets
        self.h_l = max(0, -min(offs)) if offs else 0
        self.h_r = max(0, max(offs)) if offs else 0
        if max(self.h_l, self.h_r) > self.chunk:
            raise ValueError(
                f"halo ({self.h_l}/{self.h_r} nodes) exceeds the per-device "
                f"chunk ({self.chunk}); use fewer devices or reorder the mesh "
                "to reduce bandwidth (RCM)"
            )
        c0 = self._comm.rank * self.chunk
        own = m.bands[:, c0 : min(c0 + self.chunk, N)]
        # this rank's bands over its window: zero on the halo columns and on padded nodes
        window = F.pad(own, (self.h_l, self.h_r + self.chunk - own.shape[1]))
        self.bands = window.contiguous()
        self._local = BlockDiaMatrix(offsets=m.offsets, bands=self.bands, num_nodes=window.shape[1],
                                     solution_dim=s, remainder=None)
        self._sweep = block_dia_operator(self._local, layout="component")

    # -- layout ------------------------------------------------------------

    def to_sharded(self, v_flat) -> torch.Tensor:
        """This rank's ``[chunk, s]`` block of a flat node-major dof vector (padded with zeros)."""
        m = self.matrix
        vb = torch.as_tensor(v_flat, device=m.bands.device).reshape(m.num_nodes, m.solution_dim)
        c0 = self._comm.rank * self.chunk
        part = vb.new_zeros((self.chunk, m.solution_dim))
        own = vb[c0 : c0 + self.chunk]
        part[: own.shape[0]] = own
        return part

    def to_flat(self, vb) -> torch.Tensor:
        """The flat node-major dof vector of sharded blocks (gathered with one ``all_reduce``)."""
        m = self.matrix
        return self._comm.gather_parts(vb.contiguous(), 0)[: m.num_nodes].reshape(-1)

    def zeros(self) -> torch.Tensor:
        return self.bands.new_zeros((self.chunk, self.matrix.solution_dim))

    # -- sharded product ------------------------------------------------------

    def matvec(self, vb) -> torch.Tensor:
        """``y = A x`` on sharded node blocks: one halo exchange, then the band sweep on the window."""
        h_l, h_r, c = self.h_l, self.h_r, self.chunk
        below, above = self._comm.neighbours(torch.cat([vb[c - h_l :], vb[:h_r]]))
        # the rank below's last h_l rows, this rank's block, the rank above's first h_r rows
        window = torch.cat([below[:h_l], vb, above[h_l:]])
        y2 = self._sweep(window.T.contiguous())
        return y2[:, h_l : h_l + c].T.contiguous()

    def __matmul__(self, vb):
        return self.matvec(vb)

    # -- solve ---------------------------------------------------------------

    def jacobi_inverse_diagonal(self, free_blocks=None) -> torch.Tensor:
        """This rank's ``[chunk, s]`` inverse Jacobi diagonal off the zero band (1 where masked or zero)."""
        m = self.matrix
        s = m.solution_dim
        d0 = m.offsets.index(0)
        diag = torch.stack([self.bands[(d0 * s + i) * s + i, self.h_l : self.h_l + self.chunk] for i in range(s)], 1)
        ok = diag != 0.0
        if free_blocks is not None:
            ok = free_blocks & ok
        return 1.0 / torch.where(ok, diag, 1.0)

    def cg(self, b, free_blocks=None, x0=None, rel_tolerance: float = 1e-6, max_iter: int = 1000,
           preconditioner=None, check_definiteness: bool = True) -> CgResult:
        """Jacobi-PCG on the sharded operator; every vector stays sharded.

        ``b``, ``free_blocks`` (boolean) and ``x0`` are this rank's
        ``[chunk, s]`` blocks; constrained dofs pass through as the
        identity, as in the single-device Dirichlet treatment.
        """
        if free_blocks is None:
            free_blocks = torch.ones((self.chunk, self.matrix.solution_dim), dtype=torch.bool, device=b.device)
        if preconditioner is None:
            inv_diag = self.jacobi_inverse_diagonal(free_blocks)
            preconditioner = lambda vb: inv_diag * vb  # noqa: E731

        def op(vb):
            return torch.where(free_blocks, self.matvec(torch.where(free_blocks, vb, 0.0)), vb)

        bm = torch.where(free_blocks, b, 0.0)
        return _pcg(op, bm, preconditioner, rel_tolerance, max_iter, check_definiteness, x0,
                    self._comm.dot, self._comm.norm)
