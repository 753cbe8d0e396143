"""Constant-contraction element stiffness (pairs layout): wrapper and plain version.

Counterpart of ``fenris_tpu/ops/stiffness_kernel.py``
(``stiffness_pairs_pallas``): element matrices ``[s², n², E]`` of an
operator whose contraction tensor is independent of ∇u, position and
element (Laplace, linear elasticity with scalar parameters), entry
``[i·s + j, a·n + b, e]`` = ``A_e((a, i), (b, j))``; the mirrored blocks
of a symmetric operator are node transposes of the upper blocks.

On a CUDA tensor :func:`stiffness_pairs` launches the hand-written kernel
(``csrc/stiffness_pairs.cu``; f32, ``X_geo [E, m, d]`` contiguous, one of the
eleven elements of d = 2, 3, s ≤ 3, any rule) or raises; on a CPU tensor it
runs :func:`stiffness_pairs_plain`.  The kernel builds one table a block of
``H_q[a] = sqrt(|w_q det J_q|) G_q[a] L`` (the physical gradients of each
point, ``L`` the Cholesky factor of an s.p.d. single contraction pair, else
the identity) and sums register tiles of node pairs over it: the scalar
``Σ_q H_q[a] · H_q[b]`` for Laplace (:func:`_scalar_form`), else
``C^{ij} : M_ab`` with ``M_ab = Σ_q H_q[a] H_q[b]ᵀ``, only an isotropic
contraction's terms where it is one (:func:`_isotropic`: the same bits);
tet20's Laplace instead contracts the rule's reference sums with ``|det J|
J⁻¹ C J⁻ᵀ`` (:func:`_reference_sums`, appended to the tables).
The points of negative weight come last in its tables and are subtracted; a
table that does not fit one block is taken in chunks of points
(:func:`_chunk_points`), each built once.  Each element's launch (elements
and warps a block, the tile, the launch bound) comes from ``kTiling`` in the
source, mirrored in :data:`_TILING` (:func:`launch_layout`).  The plain
version multiplies by the reference projector.  The kernel's output rows are
padded to a multiple of 32 elements (whole 32-byte sectors for every lane
group's store), so on the card the result is the view of their first E
columns, not a contiguous tensor.  Launches are counted in
``stiffness_pairs.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..assembly.local import has_mapped_params
from ._build import check, load_library

__all__ = ["launch_layout", "stiffness_pairs", "stiffness_pairs_plain", "supports_stiffness_kernel"]

_MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90
_SM_SMEM = 233472  # shared memory an SM, 1,024 bytes of it reserved a block
_ROW_ALIGN = 32  # output rows padded to a multiple of 32 elements
_PAIR_COUNTS = (1, 3, 4, 6, 9)  # pair counts the kernel takes
# csrc/stiffness_pairs.cu kShape and kTiling: element -> ((d, m, n), matrix form, scalar form), a form's
# launch (elements a block, warps a block, tile side T of T x T node pairs a thread, blocks an SM the launch
# bound asks for); T = 0 in a scalar row: the reference-sums form (:func:`_reference_sums`)
_TILING = {
    "tet4": ((3, 4, 4), (32, 3, 2, 8), (32, 1, 4, 16)),
    "tet10": ((3, 4, 10), (32, 15, 2, 1), (32, 3, 5, 8)),
    "tet20": ((3, 4, 20), (32, 12, 3, 1), (32, 8, 0, 8)),
    "hex8": ((3, 8, 8), (32, 10, 2, 3), (32, 3, 4, 7)),
    "hex20": ((3, 8, 20), (32, 12, 3, 1), (16, 10, 5, 2)),
    "hex27": ((3, 8, 27), (16, 12, 3, 1), (8, 5, 7, 3)),
    "quad4": ((2, 4, 4), (32, 1, 4, 16), (32, 1, 4, 16)),
    "quad8": ((2, 4, 8), (32, 5, 2, 6), (32, 3, 4, 8)),
    "quad9": ((2, 4, 9), (32, 3, 3, 8), (32, 3, 3, 8)),
    "tri3": ((2, 3, 3), (32, 1, 3, 16), (32, 1, 3, 16)),
    "tri6": ((2, 3, 6), (32, 3, 3, 8), (32, 1, 6, 16)),
}
_ELEMENT_OF_SHAPE = {shape: name for name, (shape, *_) in _TILING.items()}


def stiffness_pairs_plain(X_geo, op, params, tab) -> torch.Tensor:
    """Plain PyTorch version: the projector formulation of ``assemble_element_elliptic_matrices_pairs``."""
    from ..assembly.local import _elliptic_matrices_pairs

    if not getattr(op, "constant_contraction", False):
        raise ValueError("stiffness_pairs: the operator's contraction must be constant")
    return _elliptic_matrices_pairs(X_geo, None, op, params, tab)


def _constants(op, params, tab):
    """The kernel's inputs besides ``X``, in float64: ``(tables, C, meta)``.

    ``tables = [gd (q·m·d) | dphi (q·n·d) | w (q)]``, the points of negative
    weight moved last (the kernel subtracts their products there; otherwise
    in the rule's order), then in the reference-sums form
    :func:`_reference_sums`; ``C [P, d, d]`` holds,
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
    w = np.asarray(tab.weights, np.float64)
    order = np.argsort(w < 0, kind="stable")
    tables = np.concatenate([gd[order].reshape(-1), np.asarray(tab.dphi, np.float64)[order].reshape(-1), w[order]])
    if _sums_form(d, m, n, C):
        tables = np.concatenate([tables, _reference_sums(np.asarray(tab.dphi, np.float64), w).reshape(-1)])
    return tables, C, dict(m=m, n=n, q=q, d=d, s=s, sym=int(sym), neg=int((w < 0).sum()))


def _sums_form(d: int, m: int, n: int, C: np.ndarray) -> bool:
    """Whether the launch takes the reference-sums form: the scalar form on an element whose scalar row of
    ``_TILING`` has tile side 0."""
    name = _ELEMENT_OF_SHAPE.get((d, m, n))
    return name is not None and _TILING[name][2][2] == 0 and _scalar_form(C)


def _reference_sums(dphi: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The reference-sums form's table (csrc/stiffness_pairs.cu ``sums_kernel``), float64
    ``[n (n + 1) / 2, d (d + 1) / 2]``: for each upper node pair (a, b) in row-major order, with
    ``R = Σ_q w_q dphi_q[a] dphi_q[b]ᵀ``, ``R[l, l]`` and ``R[l, l'] + R[l', l]`` (l < l') row-major."""
    q, n, d = dphi.shape
    F = dphi.reshape(q, n * d)
    R = ((F.T * w) @ F).reshape(n, d, n, d)
    a, b = np.triu_indices(n)
    l, k = np.triu_indices(d)
    R = R[a, :, b, :]  # [pairs, d, d]
    return np.where(l == k, R[:, l, k], R[:, l, k] + R[:, k, l])


def host_constants(C: np.ndarray, meta: dict) -> np.ndarray:
    """The launcher's host block ``cf``: f32 ``C [P, d, d]``, then the count of points of negative weight."""
    return np.append(np.asarray(C, np.float64).ravel(), meta["neg"]).astype(np.float32)


def _cholesky(C: np.ndarray):
    """``L`` with ``C = L Lᵀ`` (csrc/stiffness_pairs.cu ``cholesky``: in float64 of the f32 values), or
    None unless ``C`` is exactly symmetric and positive definite."""
    C = np.asarray(C, np.float32).astype(np.float64)
    if not np.array_equal(C, C.T):
        return None
    d = C.shape[0]
    L = np.zeros((d, d))
    for j in range(d):
        s = C[j, j] - L[j, :j] @ L[j, :j]
        if not s > 0.0:
            return None
        L[j, j] = np.sqrt(s)
        for i in range(j + 1, d):
            L[i, j] = (C[i, j] - L[i, :j] @ L[j, :j]) / L[j, j]
    return L


def _scalar_form(C: np.ndarray) -> bool:
    """Whether the kernel takes the scalar form: one contraction pair, symmetric positive definite."""
    return C.shape[0] == 1 and _cholesky(C[0]) is not None


def _isotropic(C: np.ndarray, d: int) -> bool:
    """Whether the kernel's matrix form takes only an isotropic contraction's terms (csrc/stiffness_pairs.cu
    ``iso_term``): the d (d + 1) / 2 upper pairs (i, j), each ``C^p`` zero but at (i, j), (j, i) and, for
    i = j, the diagonal (linear elasticity).  The other terms add exact zeros, so the result is the same."""
    pairs = [(i, j) for i in range(d) for j in range(i, d)]
    if C.shape[0] != len(pairs):
        return False
    C = np.asarray(C, np.float32)
    return all(C[p, c, l] == 0 for p, (i, j) in enumerate(pairs) for c in range(d) for l in range(d)
               if not ((c, l) in ((i, j), (j, i)) or (i == j and c == l)))


def _smem_bytes(m: int, n: int, q: int, d: int, scalar: bool = False) -> int:
    """Shared memory a block of the launch for element (d, m, n) with a table of q points
    (csrc/stiffness_pairs.cu ``form_smem``): the table (a point an odd multiple of the lane group), the
    coordinates and, for a simplex, J^-1 L and |det| an element; the reference-sums form's sums, coordinates,
    K and pair nodes whatever q; 0 for an element the kernel does not take."""
    name = _ELEMENT_OF_SHAPE.get((d, m, n))
    if name is None:
        return 0
    elems, _, tile, _ = _TILING[name][2 if scalar else 1]
    if tile == 0:
        pairs, sym = n * (n + 1) // 2, d * (d + 1) // 2
        return 4 * (pairs * (sym + 1) + (m * d + sym) * elems)
    affine = (d * d + 1) * elems if m == d + 1 else 0
    return 4 * (q * ((n * d) | 1) * elems + m * d * elems + affine)


def _chunk_points(m: int, n: int, q: int, d: int, scalar: bool = False) -> int:
    """Points a chunk (csrc/stiffness_pairs.cu ``chunk_points``): ``q`` when the whole table fits a block,
    else the fewest balanced chunks that fit; 0 when not even one point fits (or the element is not one of
    the kernel's)."""
    if 0 < _smem_bytes(m, n, q, d, scalar) <= _MAX_SMEM:
        return q
    fixed = _smem_bytes(m, n, 0, d, scalar)
    point = _smem_bytes(m, n, 1, d, scalar) - fixed
    if not 0 < fixed + point <= _MAX_SMEM:
        return 0
    chunks = -(-q // ((_MAX_SMEM - fixed) // point))
    return -(-q // chunks)


def _fits(op, tab) -> bool:
    """Whether the kernel takes this element and operator: an element of ``_TILING`` and the pair count
    (any rule: a table past one block is taken in chunks of points)."""
    _, m, d = tab.geo_dphi.shape
    s = op.solution_dim
    pairs = s * (s + 1) // 2 if op.symmetric else s * s
    return (d, m, tab.dphi.shape[1]) in _ELEMENT_OF_SHAPE and pairs in _PAIR_COUNTS


def launch_layout(op, params, tab) -> dict:
    """The launch this operator and element take (csrc/stiffness_pairs.cu ``fenris_stiffness_pairs``):
    form (``"scalar"``, ``"sums"``: the scalar form from reference sums, ``"matrix"`` or ``"isotropic"``: the
    matrix form's isotropic terms alone), elements and warps a block, threads, tile side, tiles (node pairs in
    the sums form), points a chunk of the table (all q when it fits), shared bytes, the launch bound's blocks
    an SM and the blocks an SM that shared memory and threads allow."""
    q, m, d = tab.geo_dphi.shape
    n = tab.dphi.shape[1]
    C = _constants(op, params, tab)[1]
    scalar = _scalar_form(C)
    elems, warps, tile, bound = _TILING[_ELEMENT_OF_SHAPE[d, m, n]][2 if scalar else 1]
    iso = not scalar and bool(op.symmetric) and op.solution_dim == d and _isotropic(C, d)
    groups = -(-n // tile) if tile else n
    qc = _chunk_points(m, n, q, d, scalar)
    smem = _smem_bytes(m, n, qc, d, scalar)
    form = ("sums" if tile == 0 else "scalar") if scalar else "isotropic" if iso else "matrix"
    return dict(form=form, elements=elems, warps=warps,
                threads=32 * warps, tile=tile, tiles=groups * (groups + 1) // 2, chunk_points=qc, shared_bytes=smem,
                launch_bound=bound, blocks_per_sm=min(_SM_SMEM // (smem + 1024), 2048 // (32 * warps), 32))


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
        raise ValueError("stiffness_pairs: the kernel takes the elements of d = 2, 3 and s <= 3")
    tables, C, meta = _constants(op, params, tab)
    m, n, d, s = meta["m"], meta["n"], meta["d"], meta["s"]
    if X_geo.dim() != 3 or tuple(X_geo.shape[1:]) != (m, d) or not X_geo.is_contiguous():
        raise ValueError(f"stiffness_pairs: X_geo must be contiguous [E, {m}, {d}]")
    E = X_geo.shape[0]
    ld = -(-E // _ROW_ALIGN) * _ROW_ALIGN  # row stride: 128-byte aligned rows
    tables_d = device_tables(tables, X_geo.device)
    cf = host_constants(C, meta)  # read by the launcher on the host
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
