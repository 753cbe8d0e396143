"""Neo-Hookean stencil kernels on structured hex8 grids: wrappers and plain versions.

Counterpart of ``fenris_tpu/ops/structured_stencil.py``.  Two functions
carry the structured Newton–Krylov solve:

* :func:`neo_hookean_residual` — internal forces of a Neo-Hookean solid
  on a uniform hex8 grid (replaces ``neo_hookean_residual_pallas``);
* :func:`neo_hookean_hvp` — their closed-form Hessian action (replaces
  ``neo_hookean_hvp_pallas``).

Both take ``[3, nz, ny, nx]`` node grids and return a grid of the same
shape, with the basis-gradient table ``gp [8, 8, 3]`` and the weights
``wdet [8]`` from :func:`gp_table` (host numpy arrays, so the quadrature
order is the JAX package's).  On a CUDA tensor each wrapper launches its
hand-written kernel (``csrc/structured_stencil.cu``; f32, contiguous) or
raises; on a CPU tensor it runs the plain PyTorch version beside it.  Each
wrapper counts its kernel launches in ``<wrapper>.launches``.  Both
kernels are one launch of one z-marching body that allocates nothing but
its output, and work in the tensor-product form of a uniform grid's table:
:func:`stencil_factors` derives its factors from ``gp`` and ``wdet`` and
refuses a table without that structure.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..assembly.local import tabulate
from ..quadrature import canonical_stiffness
from ..reference_elements import HEX8
from ._build import check, load_library

__all__ = [
    "gp_table",
    "stencil_factors",
    "neo_hookean_residual",
    "neo_hookean_hvp",
    "neo_hookean_residual_plain",
    "neo_hookean_hvp_plain",
    "corner_views",
    "scatter_corners",
]

# local hex8 node -> (di, dj, dk) grid offsets (the reference hex node order)
_OFFSETS = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
            (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))


def gp_table(spacing: float):
    """Physical basis gradients ``gp[q, n, d]`` and weights ``wdet[q]`` (float64)."""
    tab = tabulate(HEX8, canonical_stiffness("hex8"))
    h = float(spacing)
    # affine geometry: J = (h/2) I for every cell and quadrature point
    return tab.dphi * (2.0 / h), tab.weights * (h / 2.0) ** 3


def corner_views(g: torch.Tensor):
    """The 8 cell-corner views ``[s, ncz, ncy, ncx]`` of a ``[s, z, y, x]`` grid."""
    _, nz, ny, nx = g.shape
    return [g[:, dk : dk + nz - 1, dj : dj + ny - 1, di : di + nx - 1] for di, dj, dk in _OFFSETS]


def scatter_corners(f_el: torch.Tensor, node_shape) -> torch.Tensor:
    """Sum ``f_el [8, s, ncz, ncy, ncx]`` into its cells' nodes, corner order fixed."""
    nz, ny, nx = node_shape
    out = f_el.new_zeros((f_el.shape[1], nz, ny, nx))
    for n, (di, dj, dk) in enumerate(_OFFSETS):
        out[:, dk : dk + nz - 1, dj : dj + ny - 1, di : di + nx - 1] += f_el[n]
    return out


# -- plain PyTorch versions (vectorised over cells) ---------------------------


def _tables(gp, wdet, like):
    return (
        torch.as_tensor(np.asarray(gp), dtype=like.dtype, device=like.device),
        torch.as_tensor(np.asarray(wdet), dtype=like.dtype, device=like.device),
    )


def _grad(gpt, g):
    """G[q][d][s] as [q, ncz, ncy, ncx] tensors: sum_n gp[q, n, d] g_n[s]."""
    U = torch.stack(corner_views(g))  # [n, s, z, y, x]
    G = torch.einsum("qnd,nszyx->dsqzyx", gpt, U)
    return [[G[d, s] for s in range(3)] for d in range(3)]


def _kinematics(G, mu, lam):
    """F = I + Gᵀ, its cofactors, 1/det and α = −μ + λ log J (log1p-stable)."""
    F = [[G[j][i] + (1.0 if i == j else 0.0) for j in range(3)] for i in range(3)]
    a, b, c = G[0][0], G[1][0], G[2][0]
    d, e, f = G[0][1], G[1][1], G[2][1]
    g, h, i = G[0][2], G[1][2], G[2][2]
    gamma = (
        (a + e + i)
        + (a * e - b * d + a * i - c * g + e * i - f * h)
        + (a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g))
    )
    inv_det = 1.0 / (1.0 + gamma)
    alpha = -mu + lam * torch.log1p(torch.clamp(gamma, min=-0.999999))
    cof = [[None] * 3 for _ in range(3)]
    for r in range(3):
        for k in range(3):
            r1, r2, k1, k2 = (r + 1) % 3, (r + 2) % 3, (k + 1) % 3, (k + 2) % 3
            cof[r][k] = F[r1][k1] * F[r2][k2] - F[r1][k2] * F[r2][k1]
    return F, cof, inv_det, alpha


def _contract(gpt, wt, P, node_shape):
    """f_el[n, s] = sum_q w_q sum_d gp[q, n, d] P[s][d], scattered to nodes."""
    Pt = torch.stack([torch.stack(row) for row in P])  # [s, d, q, z, y, x]
    f_el = torch.einsum("q,qnd,sdqzyx->nszyx", wt, gpt, Pt)
    return scatter_corners(f_el, node_shape)


def neo_hookean_residual_plain(u_grid, gp, wdet, mu, lam):
    """Plain PyTorch version of :func:`neo_hookean_residual` (any float dtype)."""
    gpt, wt = _tables(gp, wdet, u_grid)
    G = _grad(gpt, u_grid)
    F, cof, inv_det, alpha = _kinematics(G, mu, lam)
    # P = α F⁻ᵀ + μ F, F⁻ᵀ = cof / det
    P = [[alpha * cof[i][j] * inv_det + mu * F[i][j] for j in range(3)] for i in range(3)]
    return _contract(gpt, wt, P, u_grid.shape[1:])


def neo_hookean_hvp_plain(u_grid, v_grid, gp, wdet, mu, lam):
    """Plain PyTorch version of :func:`neo_hookean_hvp` (any float dtype)."""
    gpt, wt = _tables(gp, wdet, u_grid)
    G = _grad(gpt, u_grid)
    dG = _grad(gpt, v_grid)
    F, cof, inv_det, alpha = _kinematics(G, mu, lam)
    dF = [[dG[j][i] for j in range(3)] for i in range(3)]
    ddet = sum(cof[i][j] * dF[i][j] for i in range(3) for j in range(3))
    dalpha = lam * (ddet * inv_det)
    beta = alpha * (ddet * inv_det) * inv_det  # α ddet / det²
    dP = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            i1, i2, j1, j2 = (i + 1) % 3, (i + 2) % 3, (j + 1) % 3, (j + 2) % 3
            dcof = (
                dF[i1][j1] * F[i2][j2]
                + F[i1][j1] * dF[i2][j2]
                - dF[i1][j2] * F[i2][j1]
                - F[i1][j2] * dF[i2][j1]
            )
            dP[i][j] = mu * dF[i][j] + (dalpha * cof[i][j] + alpha * dcof) * inv_det - beta * cof[i][j]
    return _contract(gpt, wt, dP, u_grid.shape[1:])


# -- kernel wrappers ------------------------------------------------------------


def _check_grid(g: torch.Tensor, name: str) -> None:
    if g.device.type != "cuda":
        raise ValueError(f"{name}: the stencil kernels run on CUDA or CPU tensors, not {g.device}")
    if g.dtype != torch.float32:
        raise TypeError(f"{name}: the stencil kernels are f32-only, got {g.dtype}")
    if g.dim() != 4 or g.shape[0] != 3 or min(g.shape[1:]) < 2:
        raise ValueError(f"{name}: expected a [3, nz, ny, nx] grid with >= 2 nodes per axis, got {tuple(g.shape)}")
    if not g.is_contiguous():
        raise ValueError(f"{name}: grid must be contiguous")


def stencil_factors(gp, wdet) -> np.ndarray:
    """The stencil kernels' tensor-product factors of a uniform hex8 table, f32 ``[32]``.

    On a uniform grid ``gp[q, n, a] = ±D_a B_b1[q_b1, n_b1] B_b2[q_b2, n_b2]``
    (b1 = (a + 1) % 3, b2 = (a + 2) % 3; + where node n lies on the upper
    side along a): a difference along a, times the 1-D factors ``B_b[p, m]``
    of node side m at the axis' Gauss point p, with ``D_a`` the derivative
    scale (1/h).  Returns ``t1[a, p, m] = B_b1[p, m]``, ``t2[a, p, m] = D_a
    B_b2[p, m]`` and the weights ``w[qz, qy, qx] = wdet[q]``, concatenated
    (the kernels' ``StencilFactors``).  Raises ``ValueError`` unless the
    table rebuilt from these factors equals ``gp`` to 1e-6 of its largest
    entry (f32 roundoff, which :func:`gp_table`'s tables meet).
    """
    gp = np.asarray(gp, dtype=np.float64)
    wdet = np.asarray(wdet, dtype=np.float64)
    if gp.shape != (8, 8, 3) or wdet.shape != (8,):
        raise ValueError(f"expected gp [8, 8, 3] and wdet [8], got {gp.shape}, {wdet.shape}")
    off = np.array(_OFFSETS)  # [n, 3]: (di, dj, dk)
    upper = off == 1
    D = np.stack([gp[:, upper[:, a], a].sum(1) for a in range(3)], 1)  # [q, 3]
    if not np.all(np.abs(D) > 0):
        raise ValueError("gp is not a uniform hex8 tensor-product table: a zero derivative scale")
    # the 1-D factor along b at each point, read off the derivative along a = (b + 2) % 3
    L = np.empty((8, 3, 2))
    for b in range(3):
        a = (b + 2) % 3
        for m in range(2):
            L[:, b, m] = gp[:, upper[:, a] & (off[:, b] == m), a].sum(1) / D[:, a]
    pt = (L[:, :, 0] < L[:, :, 0].mean(0)).astype(np.int64)  # [q, 3]: point 0 nearer node side 0
    if len({tuple(r) for r in pt}) != 8:
        raise ValueError("gp is not a uniform hex8 tensor-product table: its points are not a 2x2x2 product")
    B = np.array([[L[pt[:, b] == p, b].mean(0) for p in range(2)] for b in range(3)])  # [b, p, m]
    Dm = D.mean(0)
    rebuilt = np.empty_like(gp)
    for a in range(3):
        b1, b2 = (a + 1) % 3, (a + 2) % 3
        sign = np.where(upper[:, a], 1.0, -1.0)
        rebuilt[:, :, a] = sign * Dm[a] * B[b1][pt[:, b1][:, None], off[:, b1]] * B[b2][pt[:, b2][:, None], off[:, b2]]
    if np.abs(rebuilt - gp).max() > 1e-6 * np.abs(gp).max():
        raise ValueError("gp is not a uniform hex8 tensor-product table (the stencil kernels need one)")
    t1 = np.stack([B[(a + 1) % 3] for a in range(3)])
    t2 = np.stack([Dm[a] * B[(a + 2) % 3] for a in range(3)])
    w = np.empty((2, 2, 2))
    w[pt[:, 2], pt[:, 1], pt[:, 0]] = wdet
    return np.ascontiguousarray(np.concatenate([t1.ravel(), t2.ravel(), w.ravel()]), dtype=np.float32)


@functools.lru_cache(maxsize=8)
def _factors_of(gp_bytes: bytes, wdet_bytes: bytes) -> np.ndarray:
    """:func:`stencil_factors` once per table (a solve passes the same one every call)."""
    return stencil_factors(np.frombuffer(gp_bytes).reshape(8, 8, 3), np.frombuffer(wdet_bytes))


def _launch(name, grids, gp, wdet, mu, lam):
    """One launch of ``fenris_<name>`` on the checked ``grids`` (u, and v for the Hessian action);
    returns its output, the only tensor the call allocates."""
    for g, arg in zip(grids, ("u_grid", "v_grid")):
        _check_grid(g, arg)
    u_grid = grids[0]
    if any(g.shape != u_grid.shape or g.device != u_grid.device for g in grids[1:]):
        raise ValueError("u_grid and v_grid must have the same shape and device")
    gp64, w64 = (np.ascontiguousarray(a, dtype=np.float64) for a in (gp, wdet))
    if gp64.shape != (8, 8, 3) or w64.shape != (8,):
        raise ValueError(f"expected gp [8, 8, 3] and wdet [8], got {gp64.shape}, {w64.shape}")
    factors = _factors_of(gp64.tobytes(), w64.tobytes())
    _, nz, ny, nx = u_grid.shape
    if ny * nx >= 2**31:
        raise ValueError(f"{name}: a node plane of {ny} x {nx} exceeds the kernel's 32-bit offsets")
    lib = load_library()
    out = torch.empty_like(u_grid)
    with torch.cuda.device(u_grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, f"fenris_{name}")(
            *(g.data_ptr() for g in grids), out.data_ptr(), nz, ny, nx,
            factors.ctypes.data, float(mu), float(lam), stream,
        )
    check(lib, code, name)
    return out


def neo_hookean_residual(u_grid, gp, wdet, mu, lam):
    """Internal forces of a Neo-Hookean structured hex8 model, grid layout.

    The kernel takes the tensor-product factors of ``gp``
    (:func:`stencil_factors`) and raises on a table without them.
    """
    if u_grid.device.type == "cpu":
        return neo_hookean_residual_plain(u_grid, gp, wdet, mu, lam)
    out = _launch("nh_residual", (u_grid,), gp, wdet, mu, lam)
    neo_hookean_residual.launches += 1
    return out


def neo_hookean_hvp(u_grid, v_grid, gp, wdet, mu, lam):
    """Hessian action d/dε f(u + ε v) of the Neo-Hookean internal forces, grid layout.

    ``v_grid`` is used as given: the caller applies the Dirichlet mask.  The
    kernel takes the tensor-product factors of ``gp`` (:func:`stencil_factors`)
    and raises on a table without them.
    """
    if u_grid.device.type == "cpu" and v_grid.device.type == "cpu":
        return neo_hookean_hvp_plain(u_grid, v_grid, gp, wdet, mu, lam)
    out = _launch("nh_hvp", (u_grid, v_grid), gp, wdet, mu, lam)
    neo_hookean_hvp.launches += 1
    return out


neo_hookean_residual.launches = 0
neo_hookean_hvp.launches = 0
