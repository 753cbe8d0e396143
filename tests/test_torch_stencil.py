"""Port parity: the stencil kernels' plain versions and wrappers.

The JAX Pallas kernels run in Pallas's TPU interpret mode on the CPU,
patched in as tests/test_stencil_kernel.py patches ``interpret=True``.
The CUDA kernels themselves run only on a card: their test is in
``tests/test_torch_cuda.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from torch_parity import LAM, MU, model_pair, rel_err, rng

import fenris_tpu.ops.structured_stencil as jss
import fenris_tpu_torch.ops.structured_stencil as tss
from fenris_tpu_torch.interop import flat_to_grid


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Pallas's TPU interpret mode (``pltpu.InterpretParams``): it runs the kernel body on the CPU one grid step
    at a time, with the outputs of ``interpret=True`` (bitwise equal in a check on this grid), in less than half the
    time, because XLA does not compile the whole interpreted kernel."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = pltpu.InterpretParams()
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _grids(cells, h, seed=0):
    """u with displacement gradients ~1e-2 and v ~ N(0, 1), as [3, nz, ny, nx]."""
    ncx, ncy, ncz = cells
    shape = (3, ncz + 1, ncy + 1, ncx + 1)
    g = rng(seed)
    return g.uniform(-0.02 * h, 0.02 * h, shape), g.standard_normal(shape)


@pytest.mark.parametrize("spacing", [0.25, 1.0 / 128])
def test_gp_table_matches_jax(spacing):
    gp_ref, w_ref = jss._gp_table(spacing)
    gp, w = tss.gp_table(spacing)
    # closed-form trilinear basis vs the JAX Vandermonde solve: rounding only
    assert np.abs(gp - gp_ref).max() <= 1e-15 * np.abs(gp_ref).max()
    assert np.abs(w - w_ref).max() <= 1e-15 * np.abs(w_ref).max()


#: ragged in x, y and z, and two KZ = 4 slabs in z: the smallest grid that reaches every branch of the kernels'
#: tiling
INTERPRET_CELLS = (3, 2, 5)


def test_residual_plain_matches_pallas_interpret(interpret_pallas):
    h = 0.25
    u, _ = _grids(INTERPRET_CELLS, h)
    u = u.astype(np.float32)
    ref = np.asarray(jss.neo_hookean_residual_pallas(jnp.asarray(u), h, MU, LAM, KZ=4))
    gp, w = tss.gp_table(h)
    got = tss.neo_hookean_residual_plain(torch.as_tensor(u), gp, w, MU, LAM)
    # f32 roundoff, summation order differs (the tolerance of test_stencil_kernel.py)
    assert rel_err(ref, got) < 1e-5


def test_hvp_plain_matches_pallas_interpret(interpret_pallas):
    h = 0.25
    u, v = _grids(INTERPRET_CELLS, h)
    u, v = u.astype(np.float32), v.astype(np.float32)
    ref = np.asarray(jss.neo_hookean_hvp_pallas(jnp.asarray(u), jnp.asarray(v), h, MU, LAM, KZ=4))
    gp, w = tss.gp_table(h)
    got = tss.neo_hookean_hvp_plain(torch.as_tensor(u), torch.as_tensor(v), gp, w, MU, LAM)
    # f32 roundoff, summation order differs
    assert rel_err(ref, got) < 1e-5


@pytest.mark.parametrize("cells", [(5, 4, 11), (15, 7, 5)])
@pytest.mark.parametrize("op", ["residual", "hvp"])
def test_plain_f64_matches_jax_model(op, cells):
    """f64 plain versions == the JAX XLA model (pallas=False): f64 roundoff."""
    jm, _ = model_pair(cells, mask=False, body_force=None, jax_kwargs=dict(pallas=False))
    h = jm.spacing
    u_flat = rng(1).uniform(-0.02 * h, 0.02 * h, jm.num_dofs)
    v_flat = rng(2).standard_normal(jm.num_dofs)
    gp, w = tss.gp_table(h)
    u = torch.as_tensor(flat_to_grid(u_flat, jm.node_shape))
    v = torch.as_tensor(flat_to_grid(v_flat, jm.node_shape))
    if op == "residual":
        ref = jm.internal_forces_grid(jnp.asarray(u_flat))
        got = tss.neo_hookean_residual_plain(u, gp, w, MU, LAM)
    else:
        ref = jm._grid(jm.hessian_vector_product(jnp.asarray(u_flat), jnp.asarray(v_flat)))
        got = tss.neo_hookean_hvp_plain(u, v, gp, w, MU, LAM)
    # closed forms vs traced autodiff in f64: roundoff amplified by cancellation
    assert rel_err(np.asarray(ref), got) < 1e-12


def test_wrappers_take_plain_version_on_cpu():
    u, v = _grids((3, 2, 4), 0.25)
    gp, w = tss.gp_table(0.25)
    ut, vt = torch.as_tensor(u, dtype=torch.float32), torch.as_tensor(v, dtype=torch.float32)
    before = (tss.neo_hookean_residual.launches, tss.neo_hookean_hvp.launches)
    assert torch.equal(
        tss.neo_hookean_residual(ut, gp, w, MU, LAM), tss.neo_hookean_residual_plain(ut, gp, w, MU, LAM)
    )
    assert torch.equal(
        tss.neo_hookean_hvp(ut, vt, gp, w, MU, LAM), tss.neo_hookean_hvp_plain(ut, vt, gp, w, MU, LAM)
    )
    # the plain version is not a kernel launch
    assert (tss.neo_hookean_residual.launches, tss.neo_hookean_hvp.launches) == before


def test_wrappers_refuse_other_devices():
    """A tensor off the CPU launches the kernel or raises: never a silent fallback."""
    gp, w = tss.gp_table(0.25)
    u = torch.empty((3, 3, 3, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tss.neo_hookean_residual(u, gp, w, MU, LAM)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tss.neo_hookean_hvp(u, u, gp, w, MU, LAM)


def test_scatter_corners_is_adjoint_of_corner_views():
    """<scatter(f), u> == <f, views(u)>: the scatter is the gather's transpose."""
    g = rng(3)
    u = torch.as_tensor(g.standard_normal((3, 4, 3, 5)))
    f = torch.as_tensor(g.standard_normal((8, 3, 3, 2, 4)))
    lhs = (tss.scatter_corners(f, u.shape[1:]) * u).sum()
    rhs = (f * torch.stack(tss.corner_views(u))).sum()
    assert abs(float(lhs - rhs)) < 1e-12 * abs(float(rhs))


# -- the Hessian-action kernel's tensor-product arithmetic and index plan -------------

_OFF = np.array(tss._OFFSETS)  # [n, 3]: (di, dj, dk)
_KERNEL_SRC = Path(tss.__file__).resolve().parent.parent / "csrc" / "structured_stencil.cu"


def _split_factors(f):
    return f[:12].reshape(3, 2, 2), f[12:24].reshape(3, 2, 2), f[24:].reshape(2, 2, 2)


def _points():
    """(qx, qy, qz) of the kernel's point loop, qx fastest."""
    return [(qx, qy, qz) for qz in range(2) for qy in range(2) for qx in range(2)]


def _tp_gradient(t1, t2, U):
    """The kernel's ``gradient_table``: edge differences, then two 1-D interpolations.

    ``U [8, 3, ...]`` corner values (hex8 order); returns ``Gt[a][p1][p2] [3, ...]``.
    """
    Gt = np.empty((3, 2, 2) + U.shape[1:])
    for a in range(3):
        b1, b2 = (a + 1) % 3, (a + 2) % 3
        e = np.empty((2, 2) + U.shape[1:])
        for m1 in range(2):
            for m2 in range(2):
                side = [(_OFF[:, a] == k) & (_OFF[:, b1] == m1) & (_OFF[:, b2] == m2) for k in (1, 0)]
                e[m1, m2] = U[side[0]][0] - U[side[1]][0]
        for p1 in range(2):
            r = [t1[a, p1, 0] * e[0, m2] + t1[a, p1, 1] * e[1, m2] for m2 in range(2)]
            for p2 in range(2):
                Gt[a, p1, p2] = t2[a, p2, 0] * r[0] + t2[a, p2, 1] * r[1]
    return Gt


def _tp_adjoint(t1, t2, w, P):
    """The kernel's point sum and adjoint: ``P[(qx, qy, qz)] [3 (s), 3 (d), ...]`` -> ``f [8, 3, ...]``."""
    shape = next(iter(P.values())).shape[2:]
    At = np.zeros((3, 2, 2, 3) + shape)
    for q, Pq in P.items():
        for a in range(3):
            At[a, q[(a + 1) % 3], q[(a + 2) % 3]] += w[q[2], q[1], q[0]] * Pq[:, a]
    f = np.zeros((8, 3) + shape)
    for a in range(3):
        b1, b2 = (a + 1) % 3, (a + 2) % 3
        r = [[t2[a, 0, m2] * At[a, p1, 0] + t2[a, 1, m2] * At[a, p1, 1] for m2 in range(2)] for p1 in range(2)]
        for m1 in range(2):
            for m2 in range(2):
                e = t1[a, 0, m1] * r[0][m2] + t1[a, 1, m1] * r[1][m2]
                for k, sign in ((1, 1.0), (0, -1.0)):
                    n = np.flatnonzero((_OFF[:, a] == k) & (_OFF[:, b1] == m1) & (_OFF[:, b2] == m2))[0]
                    f[n] += sign * e
    return f


@pytest.mark.parametrize("spacing", [0.25, 1.0 / 128])
def test_tensor_product_form_matches_dense_table(spacing):
    """f64 emulation of the kernel's gradient and adjoint against the dense gp form, and JAX's table."""
    gp, w = tss.gp_table(spacing)
    gp_jax, w_jax = (np.asarray(a) for a in jss._gp_table(spacing))
    t1, t2, wt = _split_factors(tss.stencil_factors(gp, w).astype(np.float64))
    pts = _points()
    g = rng(5)
    U = g.standard_normal((8, 3, 7))  # 7 cells
    Gt = _tp_gradient(t1, t2, U)
    # which table row is each point: the row whose dense gradient the tensor product reproduces
    dense = np.einsum("qnd,ns...->qds...", gp_jax, U)  # [q, d, s, cells]
    order = []
    for qa in pts:
        G = np.stack([Gt[a, qa[(a + 1) % 3], qa[(a + 2) % 3]] for a in range(3)])  # [d, s, cells]
        errs = [np.abs(G - dense[q]).max() for q in range(8)]
        order.append(int(np.argmin(errs)))
        # f32 factors: f32 roundoff of the scale 1/h
        assert min(errs) <= 1e-6 * np.abs(dense).max()
    assert sorted(order) == list(range(8))  # each table row exactly once
    # the adjoint: f[n, s] = sum_q w_q sum_d gp[q, n, d] P_q[s, d]
    P = {qa: g.standard_normal((3, 3, 7)) for qa in pts}
    f_dense = sum(w_jax[q] * np.einsum("nd,sd...->ns...", gp_jax[q], P[qa]) for qa, q in zip(pts, order))
    f_tp = _tp_adjoint(t1, t2, wt, P)
    assert np.abs(f_tp - f_dense).max() <= 1e-6 * np.abs(f_dense).max()


@pytest.mark.parametrize("spacing", [0.25, 1.0 / 128])
def test_tensor_product_residual_matches_plain(spacing):
    """f64 emulation of the residual kernel's arithmetic (tensor-product gradient, stress at each point,
    adjoint, the corner sum) against the plain version, which takes the dense table."""
    cells = (3, 2, 4)
    u, _ = _grids(cells, spacing, seed=6)
    u *= 10.0  # displacement gradients ~0.2: the stress well into its nonlinear range
    gp, w = tss.gp_table(spacing)
    t1, t2, wt = _split_factors(tss.stencil_factors(gp, w).astype(np.float64))
    ut = torch.as_tensor(u)
    U = torch.stack(tss.corner_views(ut)).numpy().reshape(8, 3, -1)  # [n, s, cells]
    Gt = _tp_gradient(t1, t2, U)
    P = {}
    for qa in _points():
        G = [[torch.as_tensor(Gt[a, qa[(a + 1) % 3], qa[(a + 2) % 3], s]) for s in range(3)] for a in range(3)]
        F, cof, inv_det, alpha = tss._kinematics(G, MU, LAM)
        P[qa] = np.array([[(alpha * cof[i][j] * inv_det + MU * F[i][j]).numpy() for j in range(3)] for i in range(3)])
    f = _tp_adjoint(t1, t2, wt, P)  # [n, s, cells]
    got = tss.scatter_corners(torch.as_tensor(f).reshape(8, 3, cells[2], cells[1], cells[0]), ut.shape[1:])
    ref = tss.neo_hookean_residual_plain(ut, gp, w, MU, LAM)
    # f32 factors: f32 roundoff of the scale 1/h and the weights
    assert rel_err(ref, got) < 1e-6


def test_hvp_factors_refuse_other_tables():
    gp, w = tss.gp_table(0.25)
    tss.stencil_factors(gp, w)  # the uniform table: accepted
    bad = gp.copy()
    bad[3, 5, 1] *= 1.001  # one entry off: no longer a tensor product
    with pytest.raises(ValueError, match="tensor-product"):
        tss.stencil_factors(bad, w)
    stretched = gp.copy()
    stretched[4:] *= 1.5  # another cell size at half the points
    with pytest.raises(ValueError, match="tensor-product"):
        tss.stencil_factors(stretched, w)
    with pytest.raises(ValueError, match="expected gp"):
        tss.stencil_factors(gp[:4], w[:4])


def _kernel_constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", _KERNEL_SRC.read_text())
    assert m, name
    return int(m.group(1))


@pytest.mark.parametrize("cells", [(33, 9, 17), (1, 1, 1), (5, 4, 11), (64, 20, 26), (2, 17, 1)])
def test_hvp_march_plan_owns_every_node_once(cells):
    """numpy emulation of the stencil kernels' tiles, slabs and owners (csrc/structured_stencil.cu; the
    residual and the Hessian action share them).

    Every node is written by exactly one block; it sums each of its adjacent
    cells exactly once, from a cell that block computed at that layer or the
    one before, at a shared-memory index inside the block's tile.
    """
    tx, ty, kz = (_kernel_constant(n) for n in ("kTileX", "kTileY", "kSlab"))
    cx, cy = tx + 1, ty + 1  # kCellsX, kCellsY: the cells a block computes, one left of its nodes
    ncx, ncy, ncz = cells
    nx, ny, nz = ncx + 1, ncy + 1, ncz + 1
    written = np.zeros((nz, ny, nx), dtype=np.int64)
    summed = {}

    def ends(o, tile, nc):
        return nc + 1 if o + tile >= nc else o + tile

    grid = (-(-ncx // tx), -(-ncy // ty), -(-ncz // kz))
    for bz in range(grid[2]):
        for by in range(grid[1]):
            for bx in range(grid[0]):
                x0, y0, z0 = bx * tx, by * ty, bz * kz
                xend, yend, zend = ends(x0, tx, ncx), ends(y0, ty, ncy), ends(z0, kz, ncz)
                computed = set()  # (layer, local cell x, local cell y)
                for L in range(z0 - 1, zend):
                    for tid in range(cx * cy):
                        lx, ly = tid % cx, tid // cx
                        gcx, gcy = x0 - 1 + lx, y0 - 1 + ly
                        if 0 <= gcx < ncx and 0 <= gcy < ncy and 0 <= L < ncz:
                            computed.add((L, lx, ly))
                    for tid in range(cx * cy):
                        lx, ly = tid % cx, tid // cx
                        gx, gy = x0 + lx, y0 + ly
                        if not (gx < xend and gy < yend and L >= z0):
                            continue
                        written[L, gy, gx] += 1
                        for di, dj, dk in tss._OFFSETS:
                            c = (gx - di, gy - dj, L - dk)
                            if not (0 <= c[0] < ncx and 0 <= c[1] < ncy and 0 <= c[2] < ncz):
                                continue
                            local = (L - dk, lx + 1 - di, ly + 1 - dj)
                            assert 0 <= local[1] < cx and 0 <= local[2] < cy
                            assert local in computed and local[0] in (L, L - 1)
                            summed.setdefault((L, gy, gx), []).append(c)
    assert (written == 1).all()
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                adjacent = {(i - di, j - dj, k - dk) for di, dj, dk in tss._OFFSETS
                            if 0 <= i - di < ncx and 0 <= j - dj < ncy and 0 <= k - dk < ncz}
                got = summed.get((k, j, i), [])
                assert len(got) == len(set(got)) and set(got) == adjacent
