"""Port parity: StructuredHyperelasticModel against the JAX model (f64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import both, model_pair, rel_err, state, to_numpy

# f64 closed forms / autodiff with another summation order: roundoff only
RTOL = 1e-12

GRIDS = [(3, 4, 5), (4, 3, 7), (2, 2, 3)]
_PAIRS = {}


def _pair(cells, z_chunk_planes):
    """Cached (JAX, port) model pairs: JAX model construction compiles."""
    key = (cells, z_chunk_planes)
    if key not in _PAIRS:
        _PAIRS[key] = model_pair(cells, z_chunk_planes=z_chunk_planes)
    return _PAIRS[key]


@pytest.mark.parametrize("op", ["residual", "hessian_vector_product", "hessian_diagonal", "energy"])
@pytest.mark.parametrize("z_chunk_planes", [0, 2], ids=["one-sweep", "chunked"])
@pytest.mark.parametrize("cells", GRIDS, ids=lambda c: "x".join(map(str, c)))
def test_model_matches_jax(cells, z_chunk_planes, op):
    jm, tm = _pair(cells, z_chunk_planes)
    u, v = state(jm.num_dofs, seed=sum(cells))
    args = (u, v) if op == "hessian_vector_product" else (u,)
    ref, got = both(getattr(jm, op), getattr(tm, op), *args)
    assert rel_err(ref, got) < RTOL


def test_external_forces_constant_match_jax():
    jm, tm = _pair((3, 4, 5), 0)
    assert rel_err(np.asarray(jm._f_ext), tm._f_ext) < RTOL


def test_external_forces_callable_match_jax():
    def jax_force(x, p):
        return jnp.stack([jnp.sin(3.0 * x[0]), x[1] * x[2], -5.0 + x[0] * x[1]])

    def torch_force(x, p):
        return torch.stack([torch.sin(3.0 * x[0]), x[1] * x[2], -5.0 + x[0] * x[1]])

    jm, tm = model_pair((3, 2, 4), body_force=jax_force, torch_body_force=torch_force)
    assert rel_err(np.asarray(jm._f_ext), tm._f_ext) < RTOL
    u, _ = state(jm.num_dofs, seed=4)
    ref, got = both(jm.residual, tm.residual, u)
    assert rel_err(ref, got) < RTOL


def test_l2_error_matches_jax():
    jm, tm = _pair((3, 4, 5), 0)
    u, _ = state(jm.num_dofs, seed=5)
    ref = jm.l2_error(jnp.asarray(u), lambda x: jnp.stack([x[0] * x[1], jnp.cos(x[2]), x[2]]))
    got = tm.l2_error(torch.as_tensor(u), lambda x: torch.stack([x[0] * x[1], torch.cos(x[2]), x[2]]))
    assert abs(ref - got) < RTOL * abs(ref)


@pytest.mark.parametrize("material", ["linear", "stvk"])
def test_other_materials_match_jax(material):
    jm, tm = model_pair((3, 3, 4), material=material)
    u, v = state(jm.num_dofs, seed=6)
    for op in ("residual", "hessian_diagonal"):
        ref, got = both(getattr(jm, op), getattr(tm, op), u)
        assert rel_err(ref, got) < RTOL
    ref, got = both(jm.hessian_vector_product, tm.hessian_vector_product, u, v)
    assert rel_err(ref, got) < RTOL


def test_energy_gradient_is_unmasked_residual():
    """torch.func.grad of the energy == internal minus external forces."""
    _, tm = model_pair((3, 2, 4), mask=False)
    u, _ = state(tm.num_dofs, seed=7)
    ut = torch.as_tensor(u)
    g = torch.func.grad(tm.energy)(ut)
    assert rel_err(tm.residual(ut), g) < RTOL


def test_kernel_dispatch_on_cpu_matches_jax_f32():
    """kernel=True on CPU runs the wrappers' plain versions; f32 agreement."""
    jm, tm = model_pair((5, 4, 6), dtype=torch.float32, torch_kwargs=dict(kernel=True))
    assert tm._kernel_active()
    u, v = state(jm.num_dofs, seed=8)
    # f32 roundoff, closed form vs autodiff and another summation order
    for op, args in (("residual", (u,)), ("hessian_vector_product", (u, v))):
        ref, got = both(getattr(jm, op), getattr(tm, op), *args, dtype=torch.float32)
        assert rel_err(ref, got) < 1e-5


def test_kernel_auto_is_off_on_cpu():
    _, tm = model_pair((2, 2, 2), dtype=torch.float32)
    assert tm.kernel == "auto" and not tm._kernel_active()


@pytest.mark.parametrize(
    "dtype,material,match",
    [(torch.float64, "neo_hookean", "f32-only"), (torch.float32, "linear", "Neo-Hookean only")],
)
def test_kernel_true_raises_for_unsupported_models(dtype, material, match):
    _, tm = model_pair((2, 2, 2), dtype=dtype, material=material, torch_kwargs=dict(kernel=True))
    with pytest.raises(NotImplementedError, match=match):
        tm.residual(torch.zeros(tm.num_dofs, dtype=dtype))


def test_jax_hvp_is_jvp_of_residual_layout():
    """Grid/flat layouts agree with JAX's: the masked rows act as the identity."""
    jm, tm = _pair((3, 4, 5), 0)
    u, v = state(jm.num_dofs, seed=9)
    hv = to_numpy(tm.hessian_vector_product(torch.as_tensor(u), torch.as_tensor(v)))
    fixed = ~np.asarray(jm.free_mask)
    assert np.array_equal(hv[fixed], v[fixed])
    _, ref = jax.jvp(jm.residual, (jnp.asarray(u),), (jnp.asarray(np.where(fixed, 0.0, v)),))
    assert rel_err(np.asarray(ref)[~fixed], hv[~fixed]) < RTOL
