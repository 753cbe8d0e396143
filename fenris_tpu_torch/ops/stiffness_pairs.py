"""Constant-contraction element stiffness (pairs layout): wrapper and plain version.

Counterpart of ``fenris_tpu/ops/stiffness_kernel.py``
(``stiffness_pairs_pallas``): element matrices ``[s², n², E]`` of an
operator whose contraction tensor is independent of ∇u, position and
element (Laplace, linear elasticity with scalar parameters), entry
``[i·s + j, a·n + b, e]`` = ``A_e((a, i), (b, j))``; the mirrored blocks
of a symmetric operator are node transposes of the upper blocks.

On a CUDA tensor :func:`stiffness_pairs` launches the hand-written kernel
(``csrc/stiffness_pairs.cu``; f32, ``X_geo [E, m, d]`` contiguous, d in
{2, 3}) or raises; on a CPU tensor it runs :func:`stiffness_pairs_plain`.
Launches are counted in ``stiffness_pairs.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import check, load_library

__all__ = ["stiffness_pairs", "stiffness_pairs_plain", "supports_stiffness_kernel"]

_MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90
_THREADS = 64  # elements per block (csrc/stiffness_pairs.cu kThreads)


def stiffness_pairs_plain(X_geo, op, params, tab) -> torch.Tensor:
    """Plain PyTorch version: the projector formulation of ``assemble_element_elliptic_matrices_pairs``."""
    from ..assembly.local import _elliptic_matrices_pairs

    if not getattr(op, "constant_contraction", False):
        raise ValueError("stiffness_pairs: the operator's contraction must be constant")
    return _elliptic_matrices_pairs(X_geo, None, op, params, tab)


def _constants(op, params, tab):
    """The kernel's constant buffer and its layout.

    ``[gd (q·m·d) | w (q) | C (P·d·d) | Wc (d·d·q · n·n)]`` with ``Wc``
    starting at a multiple of 4 floats; C holds, per upper pair (i, j),
    ``0.5·(D[k,i,m,j] + D[m,j,k,i])`` for symmetric operators, else
    ``D[k,i,m,j]`` for every pair.
    """
    gd = np.asarray(tab.geo_dphi, np.float64)  # [q, m, d]
    q, m, d = gd.shape
    n = tab.dphi.shape[1]
    s = op.solution_dim
    sym = bool(op.symmetric)
    D = op.contraction(torch.zeros((d, s), dtype=torch.float64), params).numpy()
    pairs = [(i, j) for i in range(s) for j in range(s) if (not sym) or i <= j]
    C = np.stack([0.5 * (D[:, i, :, j] + D[:, j, :, i].T) if sym else D[:, i, :, j] for i, j in pairs])
    Wc = np.einsum("qna,qpb->abqnp", tab.dphi, tab.dphi).reshape(d * d * q, n * n)
    w_off = q * m * d
    cf_off = w_off + q
    wc_off = -(-(cf_off + C.size) // 4) * 4
    buf = np.zeros(wc_off + Wc.size, np.float32)
    buf[:w_off] = gd.reshape(-1)
    buf[w_off:cf_off] = tab.weights
    buf[cf_off : cf_off + C.size] = C.reshape(-1)
    buf[wc_off:] = Wc.reshape(-1)
    return buf, dict(m=m, n=n, q=q, d=d, s=s, sym=int(sym), w_off=w_off, cf_off=cf_off, wc_off=wc_off)


def _smem_bytes(m: int, q: int, d: int, nconst: int) -> int:
    """Shared memory per block (csrc/stiffness_pairs.cu smem_floats)."""
    return 4 * (-(-nconst // 4) * 4 + m * d * _THREADS + d * d * q * _THREADS)


def supports_stiffness_kernel(op, params, tab, X_geo) -> bool:
    """The kernel covers constant-contraction f32 CUDA inputs whose constants fit shared memory.

    The JAX gate (``supports_stiffness_pallas``) without its TPU block-size
    clause; parameters are scalars throughout the port.
    """
    if not (
        X_geo.device.type == "cuda"
        and X_geo.dtype == torch.float32
        and getattr(op, "constant_contraction", False)
        and tab.geo_dphi.shape[2] in (2, 3)
    ):
        return False
    q, m, d = tab.geo_dphi.shape
    return _smem_bytes(m, q, d, _constants(op, params, tab)[0].size) <= _MAX_SMEM


def stiffness_pairs(X_geo: torch.Tensor, op, params, tab) -> torch.Tensor:
    """Constant-contraction element matrices in the pairs layout ``[s², n², E]``."""
    if X_geo.device.type == "cpu":
        return stiffness_pairs_plain(X_geo, op, params, tab)
    if X_geo.device.type != "cuda":
        raise ValueError(f"stiffness_pairs: X_geo must be a CUDA or CPU tensor, not on {X_geo.device}")
    if X_geo.dtype != torch.float32:
        raise TypeError(f"stiffness_pairs: the kernel is f32-only, got {X_geo.dtype}")
    if not getattr(op, "constant_contraction", False):
        raise ValueError("stiffness_pairs: the operator's contraction must be constant")
    buf, meta = _constants(op, params, tab)
    if X_geo.dim() != 3 or tuple(X_geo.shape[1:]) != (meta["m"], meta["d"]) or not X_geo.is_contiguous():
        raise ValueError(f"stiffness_pairs: X_geo must be contiguous [E, {meta['m']}, {meta['d']}]")
    E = X_geo.shape[0]
    if meta["d"] not in (2, 3):
        raise ValueError(f"stiffness_pairs: the kernel covers d in (2, 3), got {meta['d']}")
    if _smem_bytes(meta["m"], meta["q"], meta["d"], buf.size) > _MAX_SMEM:
        raise ValueError("stiffness_pairs: the element's projector does not fit in shared memory")
    s, n = meta["s"], meta["n"]
    consts = torch.from_numpy(buf).to(X_geo.device)
    out = torch.empty((s * s, n * n, E), dtype=torch.float32, device=X_geo.device)
    lib = load_library()
    with torch.cuda.device(X_geo.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fenris_stiffness_pairs(
            X_geo.data_ptr(), consts.data_ptr(), out.data_ptr(), E, meta["m"], n, meta["q"],
            meta["d"], s, meta["sym"], meta["w_off"], meta["cf_off"], meta["wc_off"], buf.size, stream,
        )
    check(lib, code, "stiffness_pairs")
    stiffness_pairs.launches += 1
    return out


stiffness_pairs.launches = 0
