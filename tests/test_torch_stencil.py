"""Port parity: the stencil kernels' plain versions and wrappers.

The JAX Pallas kernels run in interpret mode on the CPU, patched as in
tests/test_stencil_kernel.py.  The CUDA kernels themselves run only on a
card: their test is in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from torch_parity import LAM, MU, model_pair, rel_err, rng

import fenris_tpu.ops.structured_stencil as jss
import fenris_tpu_torch.ops.structured_stencil as tss
from fenris_tpu_torch.interop import flat_to_grid


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
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


def test_residual_plain_matches_pallas_interpret(interpret_pallas):
    h = 0.25
    u, _ = _grids((5, 4, 11), h)
    u = u.astype(np.float32)
    ref = np.asarray(jss.neo_hookean_residual_pallas(jnp.asarray(u), h, MU, LAM, KZ=4))
    gp, w = tss.gp_table(h)
    got = tss.neo_hookean_residual_plain(torch.as_tensor(u), gp, w, MU, LAM)
    # f32 roundoff, summation order differs (the tolerance of test_stencil_kernel.py)
    assert rel_err(ref, got) < 1e-5


def test_hvp_plain_matches_pallas_interpret(interpret_pallas):
    h = 0.25
    u, v = _grids((5, 4, 11), h)
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
