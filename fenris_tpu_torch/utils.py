"""Numerical utilities: rotations, polar decompositions, eigenvalues and MatrixMarket dumps.

Counterpart of ``fenris_tpu/utils.py`` (reference: src/util.rs):
``rotation_svd`` (:125, SVD with proper-rotation factors), ``apd`` (:172,
the analytic polar decomposition's quaternion iteration), the eigenvalue
and condition-number helpers (:409-482) and ``save_matrix_market`` (:387).

The decompositions are batched over leading axes and run on the tensor's
device (``torch.linalg.svd``, ``det`` and ``eigvalsh``); an input that is
not a tensor is put on the card.  ``hoist_closure`` and ``log1p_accurate``
are TPU workarounds and are not carried over: the port calls
``torch.log1p``, and its kernels libdevice ``log1p``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .config import resolve_device

__all__ = [
    "rotation_svd",
    "polar_decomposition",
    "apd",
    "sym_eigenvalues",
    "extremal_eigenvalues",
    "condition_number_sym",
    "save_matrix_market",
]


def _tensor(x) -> torch.Tensor:
    """``x`` itself if it is a tensor, else ``x`` on the card."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, device=resolve_device("cuda"))


def _last_column_scaled(A: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``A`` with its last column multiplied by ``scale`` (one value per matrix)."""
    return torch.cat([A[..., :-1], A[..., -1:] * scale[..., None, None]], dim=-1)


def rotation_svd(M):
    """SVD ``M = U diag(s) Vᵀ`` with ``U, V`` proper rotations (det = +1): ``(U, s, V)``.

    Sign conventions of util.rs:125: a reflection is absorbed by negating
    the last column of U or V and the last singular value, which may
    therefore be negative.
    """
    M = _tensor(M)
    U, s, Vt = torch.linalg.svd(M, full_matrices=True)
    V = Vt.transpose(-1, -2)
    one = torch.ones((), dtype=M.dtype, device=M.device)
    sign_u = torch.where(torch.linalg.det(U) < 0, -one, one)
    sign_v = torch.where(torch.linalg.det(V) < 0, -one, one)
    U = _last_column_scaled(U, sign_u)
    V = _last_column_scaled(V, sign_v)
    s = torch.cat([s[..., :-1], s[..., -1:] * (sign_u * sign_v)[..., None]], dim=-1)
    return U, s, V


def polar_decomposition(F):
    """Polar decomposition ``F = R S`` with R a proper rotation (through :func:`rotation_svd`): ``(R, S)``."""
    U, s, V = rotation_svd(F)
    Vt = V.transpose(-1, -2)
    return U @ Vt, V @ (s[..., :, None] * Vt)


def _quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


def apd(F, num_iterations: int = 30):
    """Rotation R of ``F = R S`` for 3x3 ``F`` by the analytic polar decomposition (util.rs:172).

    The quaternion fixed point of Kugelstadt et al. (2018), ``num_iterations``
    steps of a plain loop from the identity: no SVD, no branches, batched.
    """
    F = _tensor(F)
    q = torch.zeros(F.shape[:-2] + (4,), dtype=F.dtype, device=F.device)
    q[..., 0] = 1.0
    cols_F = F.transpose(-1, -2)
    for _ in range(num_iterations):
        cols_R = _quat_to_rot(q).transpose(-1, -2)
        # the rotation misalignment's gradient: omega = sum_i r_i x f_i / |sum_i r_i . f_i|
        cross = torch.linalg.cross(cols_R, cols_F, dim=-1).sum(-2)
        denom = (cols_R * cols_F).sum((-1, -2)).abs() + 1e-9
        omega = cross / denom[..., None]
        angle = torch.linalg.vector_norm(omega, dim=-1, keepdim=True)
        axis = omega / torch.clamp(angle, min=1e-30)
        half = 0.5 * angle
        dq = torch.cat([torch.cos(half), torch.sin(half) * axis], -1)
        # the quaternion product dq * q
        w1, v1 = dq[..., :1], dq[..., 1:]
        w2, v2 = q[..., :1], q[..., 1:]
        w = w1 * w2 - (v1 * v2).sum(-1, keepdim=True)
        v = w1 * v2 + w2 * v1 + torch.linalg.cross(v1, v2, dim=-1)
        q = torch.cat([w, v], -1)
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return _quat_to_rot(q)


#: matrices per batched eigenvalue call on the card: cuSOLVER's batched ``Xsyev`` refused 32,768 3x3
#: matrices at once (CUSOLVER_STATUS_INVALID_VALUE from its workspace query; 256 passed) on an H100 80GB
#: HBM3 at 700 W with torch 2.11 and CUDA 12.8
_EIG_BATCH = 1024


def sym_eigenvalues(A):
    """Eigenvalues of symmetric matrices, ascending (batched; on the card in batches of ``_EIG_BATCH``)."""
    A = _tensor(A)
    if A.device.type != "cuda" or A[..., 0, 0].numel() <= _EIG_BATCH:
        return torch.linalg.eigvalsh(A)
    flat = A.reshape((-1,) + A.shape[-2:])
    parts = [torch.linalg.eigvalsh(flat[i : i + _EIG_BATCH]) for i in range(0, flat.shape[0], _EIG_BATCH)]
    return torch.cat(parts).reshape(A.shape[:-1])


def extremal_eigenvalues(A):
    """``(min, max)`` eigenvalues of symmetric matrices (util.rs:409)."""
    ev = sym_eigenvalues(A)
    return ev[..., 0], ev[..., -1]


def condition_number_sym(A):
    """Spectral condition number of symmetric matrices (util.rs:460)."""
    lo, hi = extremal_eigenvalues(A)
    return hi.abs() / lo.abs()


def save_matrix_market(path, matrix) -> None:
    """Write a :class:`~.sparse.csr.CsrMatrix` or a dense matrix in MatrixMarket coordinate format (util.rs:387).

    The text is the JAX package's for the same entries: 1-based indices and
    ``.17g`` values, a CSR matrix in its stored order, a dense one row by
    row over its nonzeros.
    """
    from .sparse.csr import CsrMatrix

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(matrix, CsrMatrix):
        rows = np.searchsorted(matrix.row_ptr.cpu().numpy()[1:], np.arange(matrix.nnz), side="right")
        cols = matrix.col_indices.cpu().numpy()
        vals = matrix.values.detach().cpu().numpy()
        nr, nc = matrix.shape
    else:
        m = matrix.detach().cpu().numpy() if isinstance(matrix, torch.Tensor) else np.asarray(matrix)
        rows, cols = np.nonzero(m)
        vals = m[rows, cols]
        nr, nc = m.shape
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{nr} {nc} {len(vals)}\n")
        for r, c, v in zip(rows, cols, vals):
            f.write(f"{r + 1} {c + 1} {v:.17g}\n")
