"""Block-ELL sparse matrices in node-minor layout (plain PyTorch).

Counterpart of ``BlockEllMatrix``, ``block_ell_matvec_cm`` and
``block_ell_matvec`` in ``fenris_tpu/sparse/block_ell.py`` (:46, :109,
:129).  Here it holds the remainder of a block-DIA operator whose
diagonal selection left some node deltas out: ``neighbors [K, N]``
(padded with N) and ``blocks [K*s*s, N]``, row ``(k*s + i)*s + j``.  The
JAX package computes it in XLA, so it stays plain PyTorch here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["BlockEllMatrix", "block_ell_matvec", "block_ell_matvec_cm"]


class BlockEllMatrix(NamedTuple):
    neighbors: torch.Tensor  # [K, N] int32, padded with N
    blocks: torch.Tensor  # [K*s*s, N], row (k, i, j) = (k*s + i)*s + j
    num_nodes: int
    solution_dim: int

    @property
    def shape(self):
        n = self.num_nodes * self.solution_dim
        return (n, n)

    def __matmul__(self, v):
        return block_ell_matvec(self, v)


def block_ell_matvec_cm(m: BlockEllMatrix, x2: torch.Tensor) -> torch.Tensor:
    """Component-major ``y2 [s, N] = A x2 [s, N]``: s*K gathers and K*s*s multiply-adds."""
    s, N, K = m.solution_dim, m.num_nodes, m.neighbors.shape[0]
    x_pad = F.pad(x2, (0, 1))  # index N -> zero slot
    y = [x2.new_zeros(N) for _ in range(s)]
    for k in range(K):
        nb = m.neighbors[k].long()
        for j in range(s):
            xg = x_pad[j][nb]
            for i in range(s):
                y[i] = y[i] + m.blocks[(k * s + i) * s + j] * xg
    return torch.stack(y, 0)


def block_ell_matvec(m: BlockEllMatrix, v: torch.Tensor) -> torch.Tensor:
    """Node-major ``y = A v`` on flat ``[N*s]`` vectors (same sums as the cm form)."""
    s, N = m.solution_dim, m.num_nodes
    return block_ell_matvec_cm(m, v.reshape(N, s).T).T.reshape(-1)
