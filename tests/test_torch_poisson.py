"""Port parity: integration, error estimation and the two Poisson routes on hex8.

The JAX package (``fenris_tpu.integrate``, ``fenris_tpu.error``,
``fenris_tpu.fem``) and the port run in f64 on the same numpy meshes; the
port's entry points get ``device="cpu"``, where the band sweep, gather and
scatter run their plain versions.  The MMS gate runs the port alone
against ``tests/reference_values/poisson3d_mms_hex8_summary.json`` with
sources written in torch (``tests/mms_common.py`` imports JAX).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err, rng

import fenris_tpu.error as JE
import fenris_tpu.fem as JF
import fenris_tpu.integrate as JI
from fenris_tpu.assembly.local import tabulate as jax_tabulate
from fenris_tpu.mesh import Mesh as JaxMesh
from fenris_tpu.mesh.procedural import create_unit_box_uniform_hex_mesh_3d as jax_box
from fenris_tpu.quadrature import hexahedron_gauss as jax_gauss
from fenris_tpu.reference_elements import HEX8 as JAX_HEX8
import fenris_tpu_torch.error as TE
import fenris_tpu_torch.fem as TF
import fenris_tpu_torch.integrate as TI
from fenris_tpu_torch.assembly.local import tabulate
from fenris_tpu_torch.mesh import Mesh
from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d as box
from fenris_tpu_torch.quadrature import hexahedron_gauss

PI = np.pi
REFERENCE = Path(__file__).parent / "reference_values" / "poisson3d_mms_hex8_summary.json"
ROUTES = {"assembled": (JF.solve_poisson_assembled, TF.solve_poisson_assembled),
          "matrix_free": (JF.solve_poisson_matrix_free, TF.solve_poisson_matrix_free)}


# -- the MMS problem in torch and in JAX (tests/mms_common.py:32-54) -------------------


def u_exact(x):
    return torch.sin(PI * x[0]) * torch.sin(PI * x[1]) * torch.sin(PI * x[2])


def u_exact_grad(x):
    s, c = torch.sin(PI * x), torch.cos(PI * x)
    return PI * torch.stack([c[0] * s[1] * s[2], s[0] * c[1] * s[2], s[0] * s[1] * c[2]])


def source(x, p):
    return 3.0 * PI * PI * u_exact(x)


def jax_u_exact(x):
    return jnp.sin(PI * x[0]) * jnp.sin(PI * x[1]) * jnp.sin(PI * x[2])


def jax_u_exact_grad(x):
    s, c = jnp.sin(PI * x), jnp.cos(PI * x)
    return PI * jnp.array([c[0] * s[1] * s[2], s[0] * c[1] * s[2], s[0] * s[1] * c[2]])


def jax_source(x, p):
    return 3.0 * PI * PI * jax_u_exact(x)


def dirichlet_nodes(points):
    """Nodes with ||x - 0.5||_inf > 0.4999 (poisson_mms_common.rs:122-135)."""
    return np.flatnonzero(np.abs(points - 0.5).max(axis=1) > 0.4999)


def perturbed_box(res, seed=0, amp=0.15):
    """A hex8 box with interior nodes moved by up to ``amp`` of a cell (boundary kept)."""
    mesh = box(res)
    pts = mesh.points.copy()
    inner = np.abs(pts - 0.5).max(axis=1) < 0.4999
    pts[inner] += rng(seed).uniform(-amp, amp, (int(inner.sum()), 3)) / res
    return Mesh(pts, mesh.cells, mesh.element), JaxMesh(pts, mesh.cells, JAX_HEX8)


_CASE = {}


def _case():
    """A perturbed res-3 box, a nodal field on it and the 6-point error rule, in both packages."""
    if not _CASE:
        tm, jm = perturbed_box(3)
        u = rng(1).standard_normal(tm.num_vertices)
        rule = hexahedron_gauss(6)
        X = tm.cell_points()
        _CASE.update(tm=tm, jm=jm, X=X, u_el=u[tm.cells][..., None], tab=tabulate(tm.element, rule),
                     jtab=jax_tabulate(JAX_HEX8, jax_gauss(6)))
    return _CASE


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


def test_diameters_match_jax():
    tm, jm = perturbed_box(4, seed=3)
    np.testing.assert_array_equal(tm.diameters(), jm.diameters())


@pytest.mark.parametrize("with_u", [False, True])
def test_integrate_matches_jax(with_u, monkeypatch):
    monkeypatch.setattr(TI, "_POINTS_PER_CHUNK", 7 * 216)  # chunks of 7 of the 27 elements
    c = _case()
    u_el = c["u_el"] if with_u else None

    def f(x, u, G):  # the same arithmetic on JAX and torch arrays
        return x[0] * x[1] + x[2] ** 2 + (u[0] * G.sum() if with_u else 0.0)

    ref = np.asarray(JI.integrate_over_elements(jnp.asarray(c["X"]), None if u_el is None else jnp.asarray(u_el),
                                                f, c["jtab"]))
    got = TI.integrate_over_elements(_t(c["X"]), None if u_el is None else _t(u_el), f, c["tab"])
    assert rel_err(ref, got) <= 1e-12
    total = TI.integrate(_t(c["X"]), None if u_el is None else _t(u_el), f, c["tab"])
    assert abs(float(total) - ref.sum()) <= 1e-12 * abs(ref.sum())


@pytest.mark.parametrize("norm", ["L2", "H1"])
def test_error_estimators_match_jax(norm, monkeypatch):
    monkeypatch.setattr(TI, "_POINTS_PER_CHUNK", 5 * 216)  # chunks of 5 of the 27 elements
    c = _case()
    X, u_el, tab, jtab = c["X"], c["u_el"], c["tab"], c["jtab"]
    if norm == "L2":
        ref_el = JE.estimate_element_L2_error_squared(jnp.asarray(X), jnp.asarray(u_el), jax_u_exact, jtab)
        got_el = TE.estimate_element_L2_error_squared(_t(X), _t(u_el), u_exact, tab)
        ref = float(JE.estimate_L2_error(jnp.asarray(X), jnp.asarray(u_el), jax_u_exact, jtab))
        got = float(TE.estimate_L2_error(_t(X), _t(u_el), u_exact, tab))
        ref_b = float(JE.estimate_L2_error_batched(jnp.asarray(X), jnp.asarray(u_el),
                                                   lambda p: jax_u_exact(p.T)[:, None], jtab))
        got_b = float(TE.estimate_L2_error_batched(_t(X), _t(u_el), lambda p: u_exact(p.T)[:, None], tab))
    else:
        ref_el = JE.estimate_element_H1_seminorm_error_squared(jnp.asarray(X), jnp.asarray(u_el), jax_u_exact_grad,
                                                               jtab)
        got_el = TE.estimate_element_H1_seminorm_error_squared(_t(X), _t(u_el), u_exact_grad, tab)
        ref = float(JE.estimate_H1_seminorm_error(jnp.asarray(X), jnp.asarray(u_el), jax_u_exact_grad, jtab))
        got = float(TE.estimate_H1_seminorm_error(_t(X), _t(u_el), u_exact_grad, tab))
        ref_b = float(JE.estimate_H1_seminorm_error_batched(jnp.asarray(X), jnp.asarray(u_el),
                                                            lambda p: jax_u_exact_grad(p.T).T[:, :, None], jtab))
        got_b = float(TE.estimate_H1_seminorm_error_batched(_t(X), _t(u_el),
                                                            lambda p: u_exact_grad(p.T).T[:, :, None], tab))
    assert rel_err(ref_el, got_el) <= 1e-12
    assert abs(got - ref) <= 1e-12 * ref
    assert abs(got_b - ref_b) <= 1e-12 * ref_b
    assert abs(got_b - ref) <= 1e-12 * ref


@pytest.mark.parametrize("route", list(ROUTES))
def test_poisson_routes_match_jax(route):
    jax_solve, torch_solve = ROUTES[route]
    mesh = box(3)
    jm = jax_box(3)
    nd = dirichlet_nodes(mesh.points)
    kw = dict(rel_tolerance=1e-12)
    ref = jax_solve(jm, jax_gauss(2), jax_gauss(6), jax_source, jax_u_exact, jax_u_exact_grad, nd, **kw)
    got = torch_solve(mesh, hexahedron_gauss(2), hexahedron_gauss(6), source, u_exact, u_exact_grad, nd,
                      dtype=torch.float64, device="cpu", **kw)
    assert rel_err(np.asarray(ref.u), got.u) <= 1e-9
    assert abs(got.l2_error - ref.l2_error) <= 1e-9 * ref.l2_error
    assert abs(got.h1_seminorm_error - ref.h1_seminorm_error) <= 1e-9 * ref.h1_seminorm_error
    # the port's CG starts from r = b without applying the operator to x = 0
    assert abs(got.cg_iterations - ref.cg_iterations) <= 1


@pytest.mark.parametrize("route", list(ROUTES))
def test_poisson_mms_hex8_gate(route):
    """The reference's acceptance gate at the truncated resolutions of tests/test_convergence.py:85-90."""
    reference = json.loads(REFERENCE.read_text())
    torch_solve = ROUTES[route][1]
    resolutions, l2, h1 = [], [], []
    for res in (1, 2, 4, 8):
        mesh = box(res)
        r = torch_solve(mesh, hexahedron_gauss(2), hexahedron_gauss(6), source, u_exact, u_exact_grad,
                        dirichlet_nodes(mesh.points), dtype=torch.float64, device="cpu")
        resolutions.append(float(mesh.diameters().max()))
        l2.append(r.l2_error)
        h1.append(r.h1_seminorm_error)
    np.testing.assert_allclose(resolutions, reference["resolutions"][:4], rtol=1e-12)
    for ours, ref in zip(l2, reference["L2_errors"]):
        assert abs(ours - ref) <= 0.01 * abs(ref), (ours, ref)
    for ours, ref in zip(h1, reference["H1_seminorm_errors"]):
        assert abs(ours - ref) <= 0.01 * abs(ref), (ours, ref)


def test_poisson_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    mesh = box(1)
    for solve in (TF.solve_poisson_assembled, TF.solve_poisson_matrix_free):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            solve(mesh, hexahedron_gauss(2), hexahedron_gauss(6), source)
