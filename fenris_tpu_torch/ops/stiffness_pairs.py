"""Constant-contraction element stiffness (pairs layout): wrapper and plain version.

Counterpart of ``fenris_tpu/ops/stiffness_kernel.py``
(``stiffness_pairs_pallas``): element matrices ``[s², n², E]`` of an
operator whose contraction tensor is independent of ∇u, position and
element (Laplace, linear elasticity with scalar parameters), entry
``[i·s + j, a·n + b, e]`` = ``A_e((a, i), (b, j))``; the mirrored blocks
of a symmetric operator are node transposes of the upper blocks.

On a CUDA tensor :func:`stiffness_pairs` launches the hand-written kernel
(``csrc/stiffness_pairs.cu``; f32, ``X_geo [E, m, d]`` contiguous, d in
{2, 3}, s ≤ 3) or raises; on a CPU tensor it runs
:func:`stiffness_pairs_plain`.  The kernel forms the blocks directly from
the physical gradients ``G_q`` of each quadrature point, ``C^{ij} : M_ab``
with ``M_ab = Σ_q w|det| G_q[a] G_q[b]ᵀ`` per node pair; the plain version
multiplies by the reference projector.  Elements whose per-point
gradient table does not fit a block (hex20, hex27) take their points in
chunks (:func:`_chunk_points`).  The kernel's output rows are
padded to a multiple of 32 elements (whole 128-byte lines for every warp
store), so on the card the result is the view of their first E columns,
not a contiguous tensor.  Launches are counted in
``stiffness_pairs.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..assembly.local import has_mapped_params
from ._build import check, load_library

__all__ = ["stiffness_pairs", "stiffness_pairs_plain", "supports_stiffness_kernel"]

_MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90
_CHUNK_SMEM = 115712  # a block of the chunked form: two blocks an SM (csrc/stiffness_pairs.cu kChunkSmem)
_LANES = 32  # elements per block (csrc/stiffness_pairs.cu kLanes)
_WARPS = 9  # warps a block (kWarps)
_CHUNK_TASKS = 4  # node pairs a thread keeps across point chunks (kChunkTasks)
_PAIR_COUNTS = (1, 3, 4, 6, 9)  # pair counts the kernel is instantiated for


def stiffness_pairs_plain(X_geo, op, params, tab) -> torch.Tensor:
    """Plain PyTorch version: the projector formulation of ``assemble_element_elliptic_matrices_pairs``."""
    from ..assembly.local import _elliptic_matrices_pairs

    if not getattr(op, "constant_contraction", False):
        raise ValueError("stiffness_pairs: the operator's contraction must be constant")
    return _elliptic_matrices_pairs(X_geo, None, op, params, tab)


def _constants(op, params, tab):
    """The kernel's inputs besides ``X``, in float64: ``(tables, C, meta)``.

    ``tables = [gd (q·m·d) | dphi (q·n·d) | w (q)]``; ``C [P, d, d]`` holds,
    per computed pair (i, j) in row-major order (``i <= j`` only for
    symmetric operators), ``0.5·(D[k,i,m,j] + D[m,j,k,i])`` for symmetric
    operators, else ``D[k,i,m,j]``.
    """
    gd = np.asarray(tab.geo_dphi, np.float64)  # [q, m, d]
    q, m, d = gd.shape
    n = tab.dphi.shape[1]
    s = op.solution_dim
    sym = bool(op.symmetric)
    D = op.contraction(torch.zeros((d, s), dtype=torch.float64), params).numpy()
    pairs = [(i, j) for i in range(s) for j in range(s) if (not sym) or i <= j]
    C = np.stack([0.5 * (D[:, i, :, j] + D[:, j, :, i].T) if sym else D[:, i, :, j] for i, j in pairs])
    tables = np.concatenate([gd.reshape(-1), np.asarray(tab.dphi, np.float64).reshape(-1), tab.weights])
    return tables, C, dict(m=m, n=n, q=q, d=d, s=s, sym=int(sym))


def _smem_floats(m: int, n: int, q: int, qc: int, d: int) -> int:
    """Shared floats a block (csrc/stiffness_pairs.cu smem_floats): ``qc`` points' gradients."""
    return qc * n * _LANES * 4 + m * d * _LANES + q * (m + n) * d + q


def _chunk_points(m: int, n: int, q: int, d: int) -> int:
    """Points a chunk (csrc/stiffness_pairs.cu chunk_points): ``q`` when the whole gradient table
    fits a block, else the fewest balanced chunks of at most ``_CHUNK_SMEM`` bytes (d = 3);
    0 when not even one point fits."""
    if 4 * _smem_floats(m, n, q, q, d) <= _MAX_SMEM:
        return q
    per_point, fixed = 4 * n * _LANES * 4, 4 * _smem_floats(m, n, q, 0, d)
    if d != 3 or fixed + per_point > _CHUNK_SMEM:
        return 0
    chunks = -(-q // ((_CHUNK_SMEM - fixed) // per_point))
    return -(-q // chunks)


def _smem_bytes(m: int, n: int, q: int, d: int) -> int:
    """Shared memory a block of the launch for this element (0: the kernel does not take it)."""
    qc = _chunk_points(m, n, q, d)
    return 4 * _smem_floats(m, n, q, qc, d) if qc else 0


def _fits(op, tab) -> bool:
    """Whether the kernel takes this element and operator: d, pair count and shared memory."""
    q, m, d = tab.geo_dphi.shape
    s = op.solution_dim
    pairs = s * (s + 1) // 2 if op.symmetric else s * s
    return d in (2, 3) and pairs in _PAIR_COUNTS and _chunk_points(m, tab.dphi.shape[1], q, d) > 0


def supports_stiffness_kernel(op, params, tab, X_geo) -> bool:
    """The kernel covers constant-contraction f32 CUDA inputs it is instantiated for, with constant
    parameters.

    The JAX gate (``supports_stiffness_pallas``) without its TPU block-size
    clause: per-element and per-point parameters are refused, as there.
    """
    return (
        X_geo.device.type == "cuda"
        and X_geo.dtype == torch.float32
        and bool(getattr(op, "constant_contraction", False))
        and not has_mapped_params(params, X_geo.shape[0], tab.num_points)
        and _fits(op, tab)
    )


_table_cache: dict = {}


def device_tables(tables: np.ndarray, device) -> torch.Tensor:
    """The kernel's f32 tables on ``device``, copied once per content (callers pass the same tabulation
    every call), so a launch does no host-to-device copy."""
    key = (tables.tobytes(), str(device))
    t = _table_cache.get(key)
    if t is None:
        if len(_table_cache) > 16:
            _table_cache.clear()
        t = _table_cache[key] = torch.from_numpy(tables.astype(np.float32)).to(device)
    return t


def stiffness_pairs(X_geo: torch.Tensor, op, params, tab) -> torch.Tensor:
    """Constant-contraction element matrices in the pairs layout ``[s², n², E]``, constant parameters."""
    if has_mapped_params(params, X_geo.shape[0], tab.num_points):
        raise ValueError("stiffness_pairs: the kernel takes constant parameters, not per-element or per-point ones")
    if X_geo.device.type == "cpu":
        return stiffness_pairs_plain(X_geo, op, params, tab)
    if X_geo.device.type != "cuda":
        raise ValueError(f"stiffness_pairs: X_geo must be a CUDA or CPU tensor, not on {X_geo.device}")
    if X_geo.dtype != torch.float32:
        raise TypeError(f"stiffness_pairs: the kernel is f32-only, got {X_geo.dtype}")
    if not getattr(op, "constant_contraction", False):
        raise ValueError("stiffness_pairs: the operator's contraction must be constant")
    if has_mapped_params(params, X_geo.shape[0], tab.num_points):
        raise ValueError("stiffness_pairs: the kernel takes constant parameters, not per-element or per-point ones")
    if not _fits(op, tab):
        raise ValueError("stiffness_pairs: the kernel takes d in (2, 3), s <= 3 and elements of which "
                         "one quadrature point's gradients fit in shared memory")
    tables, C, meta = _constants(op, params, tab)
    m, n, d, s = meta["m"], meta["n"], meta["d"], meta["s"]
    if X_geo.dim() != 3 or tuple(X_geo.shape[1:]) != (m, d) or not X_geo.is_contiguous():
        raise ValueError(f"stiffness_pairs: X_geo must be contiguous [E, {m}, {d}]")
    E = X_geo.shape[0]
    ld = -(-E // _LANES) * _LANES  # row stride: 128-byte aligned rows
    tables_d = device_tables(tables, X_geo.device)
    cf = np.ascontiguousarray(C, dtype=np.float32)  # read by the launcher on the host
    out = torch.empty((s * s, n * n, ld), dtype=torch.float32, device=X_geo.device)
    lib = load_library()
    with torch.cuda.device(X_geo.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fenris_stiffness_pairs(
            X_geo.data_ptr(), tables_d.data_ptr(), cf.ctypes.data, out.data_ptr(), E, ld, m, n, meta["q"], d, s,
            meta["sym"], stream,
        )
    check(lib, code, "stiffness_pairs")
    stiffness_pairs.launches += 1
    return out[..., :E]


stiffness_pairs.launches = 0
