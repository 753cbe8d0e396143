"""Block-ELL sparse matrices in node-minor layout (plain PyTorch).

Counterpart of ``fenris_tpu/sparse/block_ell.py``: ``BlockEllMatrix``,
``block_ell_from_csr`` (:61), ``block_ell_matvec_cm`` and
``block_ell_matvec`` (:109, :129).  It holds a whole operator converted
from CSR, or the remainder of a block-DIA operator whose diagonal
selection left some node deltas out: ``neighbors [K, N]`` (padded with
N) and ``blocks [K*s*s, N]``, row ``(k*s + i)*s + j``.  The JAX package
computes it in XLA, so it stays plain PyTorch here.  The conversion's
index maps are built on the pattern's device with the JAX package's
(host numpy) arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["BlockEllMatrix", "block_ell_from_csr", "block_ell_matvec", "block_ell_matvec_cm"]


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


def node_adjacency(pattern):
    """Node-level adjacency of a dof-level CSR pattern (node-major dofs, sorted columns).

    Returns ``(N, s, K, nk_n, nk_k, nbr, pos)``: the valid (node, slot)
    pairs in row-major order as ``nk_n [M]``, ``nk_k [M]`` with neighbour
    node ``nbr [M]``, their value positions ``pos [M, s, s]`` and the largest
    neighbour count ``K``, as tensors on the pattern's device
    (``_node_adjacency`` of ``fenris_tpu/sparse/block_dia.py``).
    """
    s = int(pattern.solution_dim)
    N = pattern.num_rows // s
    row_ptr = pattern.row_ptr.long()
    dev = row_ptr.device
    nodes = torch.arange(N, device=dev)
    row0 = row_ptr[nodes * s]
    counts = (row_ptr[nodes * s + 1] - row0) // s
    K = int(counts.max()) if N else 0
    nk_n = torch.repeat_interleave(nodes, counts)
    starts = torch.cumsum(counts, 0) - counts
    nk_k = torch.arange(nk_n.numel(), device=dev) - starts[nk_n]
    cols = pattern.col_indices.long()
    nbr = cols[row0[nk_n] + nk_k * s] // s
    c_idx = torch.arange(s, device=dev)
    base = row_ptr[nk_n[:, None] * s + c_idx][..., None]  # [M, s, 1]
    pos = base + (nk_k[:, None, None] * s + c_idx[None, None, :])
    return N, s, K, nk_n, nk_k, nbr, pos


def gather_values(values: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    """``values`` gathered at ``idx`` (index ``nnz`` reads a zero), reshaped to ``shape``."""
    padded = torch.cat([values, values.new_zeros(1)])
    return padded[idx.reshape(-1)].reshape(shape)


def block_ell_from_csr(pattern, values: torch.Tensor) -> BlockEllMatrix:
    """Convert assembled CSR values into node-minor block-ELL (``block_ell.py:61``).

    ``pattern`` is an assembly :class:`~..assembly.global_.CsrPattern`,
    ``values`` its ``[nnz]`` values on the same device.  Entry ``(n, k, c,
    cc)`` lives at ``row_ptr[s n + c] + k s + cc``; pads read a zero.
    """
    N, s, K, nk_n, nk_k, nbr, pos = node_adjacency(pattern)
    dev = pattern.row_ptr.device
    neighbors = torch.full((N, K), N, dtype=torch.int32, device=dev)
    neighbors[nk_n, nk_k] = nbr.to(torch.int32)
    idx = torch.full((N, K, s, s), pattern.nnz, dtype=torch.int64, device=dev)
    idx[nk_n, nk_k] = pos
    blocks = gather_values(values, idx.permute(1, 2, 3, 0).contiguous(), (K * s * s, N))
    return BlockEllMatrix(neighbors=neighbors.T.contiguous(), blocks=blocks, num_nodes=N, solution_dim=s)


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
