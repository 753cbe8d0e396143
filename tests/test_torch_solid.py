"""Port parity: materials and elliptic operators against fenris_tpu.solid (f64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import LAM, MATERIALS, MU, rel_err, rng, to_numpy

import fenris_tpu.operators as jops
import fenris_tpu.solid as jsolid
import fenris_tpu_torch.operators as tops
import fenris_tpu_torch.solid as tsolid

# Same closed forms evaluated in another order of operations: f64 roundoff
# of O(10) operations, amplified by cancellation, stays far below 1e-12.
RTOL = 1e-12


def _grads(dim, n=12, scale=0.2, seed=7):
    return rng(seed).uniform(-scale, scale, size=(n, dim, dim))


def _jax_pointwise(fn, *arrays):
    return np.asarray(jax.vmap(fn)(*(jnp.asarray(a) for a in arrays)))


QUANTITIES = ("energy", "stress", "contraction", "tangent")


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("quantity", QUANTITIES)
@pytest.mark.parametrize("material", sorted(MATERIALS))
def test_material_matches_jax(material, quantity, dim):
    jcls, tcls = MATERIALS[material]
    jm, tm = jcls(), tcls()
    jp, tp = jsolid.LameParameters(MU, LAM), tsolid.LameParameters(MU, LAM)
    G, dG = _grads(dim), _grads(dim, seed=8)
    Gt, dGt = torch.as_tensor(G), torch.as_tensor(dG)
    if quantity == "energy":
        ref = _jax_pointwise(lambda g: jm.energy_density_du(g, jp), G)
        got = tm.energy_density_du(Gt, tp)
    elif quantity == "stress":
        ref = _jax_pointwise(lambda g: jm.stress_du(g, jp), G)
        got = tm.stress_du(Gt, tp)
    elif quantity == "contraction":
        ref = _jax_pointwise(lambda g: jm.stress_contraction_tensor_du(g, jp), G)
        got = tm.stress_contraction_tensor_du(Gt, tp)
    else:
        ref = _jax_pointwise(lambda g, dg: jm.stress_tangent_du(g, dg, jp), G, dG)
        got = tm.stress_tangent_du(Gt, dGt, tp)
    assert rel_err(ref, got) < RTOL


class _EnergyOnlyNeoHookean(tsolid.HyperelasticMaterial):
    """Neo-Hookean through the autodiff defaults only."""

    def energy_density_du(self, u_grad, params):
        return tsolid.NeoHookeanMaterial().energy_density_du(u_grad, params)


@pytest.mark.parametrize("quantity", ["stress", "contraction", "tangent"])
def test_autodiff_defaults_match_closed_forms(quantity):
    """torch.func defaults of the material base class == the closed forms."""
    ad, cf = _EnergyOnlyNeoHookean(), tsolid.NeoHookeanMaterial()
    p = tsolid.LameParameters(MU, LAM)
    G, dG = torch.as_tensor(_grads(3)), torch.as_tensor(_grads(3, seed=9))
    if quantity == "stress":
        ref, got = cf.stress_du(G, p), ad.stress_du(G, p)
    elif quantity == "contraction":
        ref, got = cf.stress_contraction_tensor_du(G, p), ad.stress_contraction_tensor_du(G, p)
    else:
        ref, got = cf.stress_tangent_du(G, dG, p), ad.stress_tangent_du(G, dG, p)
    # AD and closed form differ by f64 roundoff only
    assert rel_err(ref, got) < RTOL


@pytest.mark.parametrize("method", ["energy", "g", "contraction", "g_tangent"])
def test_material_operator_matches_jax(method):
    jop = jsolid.MaterialEllipticOperator(jsolid.NeoHookeanMaterial(), dim=3)
    top = tsolid.MaterialEllipticOperator(tsolid.NeoHookeanMaterial(), dim=3)
    jp, tp = jsolid.LameParameters(MU, LAM), tsolid.LameParameters(MU, LAM)
    G, dG = _grads(3), _grads(3, seed=3)
    if method == "g_tangent":
        ref = _jax_pointwise(lambda g, dg: jop.g_tangent(g, dg, jp), G, dG)
        got = top.g_tangent(torch.as_tensor(G), torch.as_tensor(dG), tp)
    else:
        ref = _jax_pointwise(lambda g: getattr(jop, method)(g, jp), G)
        got = getattr(top, method)(torch.as_tensor(G), tp)
    assert rel_err(ref, got) < RTOL


class _JaxQuartic(jops.EllipticOperator):
    solution_dim = 2

    def energy(self, G, params):
        return jnp.sum(G**4) + 0.5 * jnp.sum(G * G)


class _TorchQuartic(tops.EllipticOperator):
    solution_dim = 2

    def energy(self, G, params):
        return (G**4).sum((-2, -1)) + 0.5 * (G * G).sum((-2, -1))


@pytest.mark.parametrize("method", ["g", "contraction", "g_tangent"])
def test_operator_autodiff_defaults_match_jax(method):
    """EllipticOperator's torch.func defaults == jax.grad/jacfwd/jvp."""
    jop, top = _JaxQuartic(), _TorchQuartic()
    G, dG = rng(2).standard_normal((6, 3, 2)), rng(3).standard_normal((6, 3, 2))
    if method == "g_tangent":
        ref = _jax_pointwise(lambda g, dg: jop.g_tangent(g, dg, None), G, dG)
        got = top.g_tangent(torch.as_tensor(G), torch.as_tensor(dG), None)
    else:
        ref = _jax_pointwise(lambda g: getattr(jop, method)(g, None), G)
        got = getattr(top, method)(torch.as_tensor(G), None)
    assert rel_err(ref, got) < RTOL


def test_laplace_operator_matches_jax():
    G = rng(4).standard_normal((5, 3, 1))
    jop, top = jops.LaplaceOperator(), tops.LaplaceOperator()
    Gt = torch.as_tensor(G)
    assert rel_err(_jax_pointwise(lambda g: jop.energy(g, None), G), top.energy(Gt, None)) < RTOL
    assert rel_err(_jax_pointwise(lambda g: jop.g(g, None), G), top.g(Gt, None)) == 0.0
    ref_D = _jax_pointwise(lambda g: jop.contraction(g, None), G)
    assert rel_err(ref_D, top.contraction(Gt, None)) == 0.0


@pytest.mark.parametrize("magnitude", [1e-3, 1e-8, 1e-13])
def test_log_det_F_near_identity(magnitude):
    """log1p-stable log det(I + U) keeps full relative precision as γ -> 0."""
    U = rng(5).uniform(-magnitude, magnitude, size=(20, 3, 3))
    ref = np.asarray(jax.vmap(jsolid.log_det_F)(jnp.asarray(U)))
    got = to_numpy(tsolid.log_det_F(torch.as_tensor(U)))
    assert rel_err(ref, got) < RTOL
    # log(det) of the assembled 1 + γ would lose ~ eps / γ relative accuracy;
    # the series log1p(γ) ≈ γ - γ²/2 pins the small-γ end independently
    if magnitude <= 1e-8:
        gamma = np.trace(U, axis1=1, axis2=2)
        gamma = gamma + sum(
            U[:, a, a] * U[:, b, b] - U[:, a, b] * U[:, b, a] for a, b in ((0, 1), (0, 2), (1, 2))
        ) + np.linalg.det(U)
        assert rel_err(gamma - gamma**2 / 2, got) < 1e-9


def test_log_det_F_inverted_is_minus_inf():
    U = np.diag([-2.0, 0.0, 0.0])[None]
    assert np.isneginf(to_numpy(tsolid.log_det_F(torch.as_tensor(U)))).all()
    e = tsolid.NeoHookeanMaterial().energy_density_du(
        torch.as_tensor(U).transpose(-1, -2), tsolid.LameParameters(MU, LAM)
    )
    assert torch.isinf(e).all()


def test_lame_and_gravity_match_jax():
    assert tuple(tsolid.lame_from_young_poisson(1e3, 0.3)) == pytest.approx(
        tuple(jsolid.lame_from_young_poisson(1e3, 0.3)), rel=1e-15
    )
    x = rng(6).standard_normal((4, 3))
    ref = _jax_pointwise(lambda p: jsolid.GravitySource([0.0, 0.0, -9.81], 2.0)(p, None), x)
    got = torch.func.vmap(lambda p: tsolid.GravitySource([0.0, 0.0, -9.81], 2.0)(p, None))(
        torch.as_tensor(x)
    )
    assert rel_err(ref, got) == 0.0
