"""Port parity: point location, inverse mapping and interpolation (``space.py``), and the tri3 error suite.

The JAX package and the port run on the same numpy meshes and points in
f64.  JAX's location is traced once per case under ``jax.jit`` (its
traced branch: the chart pass on every candidate, no re-run; the concrete
branch re-traces its loops on every call, ~25 s a call), on points
whose answers need no re-run.  Element indices are held on points with a
unique nearest element; distances, reference coordinates and
interpolated values on all, at 1e-10.  The port's grid branch is also
held against its brute-force branch, and against itself at another chunk
size (bitwise).  The error-estimation subset of
``tests/test_error_estimation.py`` runs the port alone against
``tests/reference_values/error_estimation_tri3_summary.json`` at 1%.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err

import fenris_tpu.space as JS
from fenris_tpu.mesh import convert as jax_convert
from fenris_tpu.mesh import procedural as JP
from fenris_tpu.reference_elements import ELEMENTS as JAX_ELEMENTS
import fenris_tpu_torch.space as TS
from fenris_tpu_torch import quadrature as TQ
from fenris_tpu_torch.assembly.local import tabulate
from fenris_tpu_torch.error import estimate_H1_seminorm_error_batched, estimate_L2_error_batched
from fenris_tpu_torch.mesh import Mesh
from fenris_tpu_torch.mesh import procedural as TP
from fenris_tpu_torch.reference_elements import ELEMENTS

PI = np.pi


def _port(jm) -> Mesh:
    return Mesh(jm.points, jm.cells, ELEMENTS[jm.element.name])


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _jax_mesh(name):
    base = {"tet": lambda: JP.create_unit_box_uniform_tet_mesh_3d(2),
            "hex": lambda: JP.create_unit_box_uniform_hex_mesh_3d(3),
            "tri": lambda: JP.create_unit_square_uniform_tri_mesh_2d(3),
            "qua": lambda: JP.create_unit_square_uniform_quad_mesh_2d(3)}[name[:3]]()
    return base if base.element.name == name else jax_convert.convert_mesh(base, name)


def _perturbed_nodes(name, rng, amount):
    el = JAX_ELEMENTS[name]
    return el.nodes + rng.uniform(-amount, amount, size=el.nodes.shape)


def test_inverse_mapping_and_projection_match_jax(rng):
    """``map_physical_coordinates`` on a curved hex8 and a tet10 (tet4 geometry), ``project_physical_coordinates``
    on a quad4: JAX's values and the true reference coordinates, 1e-10."""
    for name, amount, fn in (("hex8", 0.2, "map_physical_coordinates"), ("tet10", 0.1, "map_physical_coordinates"),
                             ("quad4", 0.1, "project_physical_coordinates")):
        el = JAX_ELEMENTS[name]
        geo = el.geometry
        X = _perturbed_nodes(geo.name, rng, amount)
        xi_true = rng.uniform(-0.3, 0.3, size=(20, el.ref_dim))
        x = geo.tabulate(xi_true)[0] @ X
        Xb = np.repeat(X[None], 20, 0)
        ref = np.asarray(jax.jit(lambda A, b: getattr(JS, fn)(el, A, b))(jnp.asarray(Xb), jnp.asarray(x)))
        got = getattr(TS, fn)(ELEMENTS[name], _t(Xb), _t(x)).numpy()
        assert np.abs(got - ref).max() < 1e-10, name
        assert np.abs(got - xi_true).max() < 1e-10, name


def test_reference_domain_projection_matches_jax(rng):
    for name in ("tri3", "tet4", "quad4", "hex8"):
        el = JAX_ELEMENTS[name]
        xi = rng.uniform(-3.0, 3.0, size=(200, el.ref_dim))
        ref_p, ref_d = jax.jit(lambda v: (JS.project_reference_domain(el, v), JS.reference_domain_distance(el, v)))(
            jnp.asarray(xi))
        p = TS.project_reference_domain(ELEMENTS[name], _t(xi))
        assert np.abs(p.numpy() - np.asarray(ref_p)).max() < 1e-12, name
        assert np.abs(TS.reference_domain_distance(ELEMENTS[name], _t(xi)).numpy() - np.asarray(ref_d)).max() < 1e-12
        assert float(TS.reference_domain_distance(ELEMENTS[name], p).max()) < 1e-12


def test_closest_point_in_element_tet_matches_jax(rng):
    """The constrained closest point on a perturbed tet4, 20 points inside and 100 around it (every Voronoi
    region of the affine tet): ``(xi, inside, distance)`` against JAX; the pre-pass answers the inside ones."""
    el = JAX_ELEMENTS["tet4"]
    X = _perturbed_nodes("tet4", rng, 0.15)
    pts = rng.uniform(-3.0, 3.0, size=(120, 3))
    pts[:20] = el.tabulate(rng.uniform(-0.9, -0.5, size=(20, 3)))[0] @ X
    Xb = np.repeat(X[None], len(pts), 0)
    ref = jax.jit(lambda A, b: JS.closest_point_in_element(el, A, b))(jnp.asarray(Xb), jnp.asarray(pts))
    got = TS.closest_point_in_element(ELEMENTS["tet4"], _t(Xb), _t(pts))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert got[1][:20].all() and not got[1][20:].any()
    assert np.abs(got[0].numpy() - np.asarray(ref[0])).max() < 1e-10
    assert np.abs(got[2].numpy() - np.asarray(ref[2])).max() < 1e-10
    pre = TS.closest_point_in_element(ELEMENTS["tet4"], _t(Xb), _t(pts), charts=False)
    assert torch.equal(pre[1], got[1]) and torch.isinf(pre[2][20:]).all()


def test_closest_point_in_element_hex_beats_sampling(rng):
    """A trilinear hex8 (JAX's oracle of tests/test_space.py: no sampled point of the element is closer; JAX
    parity of the hex closest point is held through ``test_interpolation_matches_jax[hex8]``)."""
    el = ELEMENTS["hex8"]
    X = _perturbed_nodes("hex8", rng, 0.2)
    pts = rng.uniform(-3.0, 3.0, size=(30, 3))
    _, inside, dist = TS.closest_point_in_element(el, _t(np.repeat(X[None], 30, 0)), _t(pts))
    g = np.linspace(-1, 1, 13)
    samples = el.tabulate(np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3))[0] @ X
    d_samp = np.linalg.norm(samples[None] - pts[:, None], axis=-1).min(axis=1)
    assert (dist.numpy() <= d_samp + 1e-9).all() and (dist[inside] == 0).all()


def _l_shape():
    mesh = JP.create_unit_square_uniform_quad_mesh_2d(8)
    centres = mesh.cell_points().mean(axis=1)
    return mesh.keep_cells(np.flatnonzero(~((centres[:, 0] > 0.5) & (centres[:, 1] > 0.5))))


@pytest.mark.parametrize("case", ["l_shape", "tet_box"])
def test_grid_index_arrays_equal_jax(case, rng):
    """``GridIndex.build`` bitwise (the L-shape's many cells include empty ones, filled by the dilation), its
    plain and ring candidates and its guarantee radius."""
    jm, avg = (_l_shape(), 0.5) if case == "l_shape" else (JP.create_unit_box_uniform_tet_mesh_3d(3), 2.0)
    ref = JS.GridIndex.build(jm, avg_elements_per_cell=avg)
    got = TS.GridIndex.build(_port(jm), avg_elements_per_cell=avg)
    for key in ("origin", "inv_cell", "dims", "table"):
        a, b = getattr(got, key), getattr(ref, key)
        assert a.dtype == b.dtype and np.array_equal(a, b), key
    assert (got.table >= 0).any(axis=1).all()
    if case == "l_shape":  # a cell in the hole holds the candidates of a filled cell: none of them covers it
        cand = got.candidates(torch.tensor([[0.9, 0.9]], dtype=torch.float64))[0]
        cand = cand[cand >= 0].numpy()
        assert len(cand) and (jm.cell_points()[cand].max(axis=1) < 0.9 - 1e-9).any(axis=1).all()
    pts = rng.uniform(-0.5, 1.5, size=(50, jm.dim))
    for ring in (False, True):
        np.testing.assert_array_equal(got.candidates(_t(pts), ring=ring).numpy(),
                                      np.asarray(ref.candidates(jnp.asarray(pts), ring=ring)))
    np.testing.assert_array_equal(got.guarantee_radius(_t(pts)).numpy(), ref.guarantee_radius(pts))


def _unique_nearest(res_dist_all):
    """Points whose nearest element is unique by more than 1e-9: a row of per-element distances."""
    s = np.sort(res_dist_all, axis=1)
    return s[:, 1] - s[:, 0] > 1e-9


def _jax_interpolation(jm, pts, u):
    """JAX's location (traced grid branch), values and gradients of ``u`` at ``pts``, one trace."""
    jidx = JS.GridIndex.build(jm)

    def fn(p, uu):
        g, res = JS.interpolate_gradient_at_points(jm, uu, p, index=jidx)
        return res.element_indices, res.reference_coords, res.domain_distance, JS._interpolate_located(jm, uu, res, 1), g

    return [np.asarray(r) for r in jax.jit(fn)(jnp.asarray(pts), jnp.asarray(u))]


@pytest.fixture(scope="module")
def tet_location():
    """The tet10 box at res 2, 120 points inside and up to 0.5 outside, located by JAX (with values and
    gradients of a random field) and by the port (grid, brute force, and grid at chunk size 7)."""
    rng = np.random.default_rng(7)
    jm = _jax_mesh("tet10")
    pts = np.concatenate([rng.uniform(0.02, 0.98, size=(60, 3)), rng.uniform(-0.5, 1.5, size=(60, 3))])
    u = rng.standard_normal(jm.num_vertices)
    ref = _jax_interpolation(jm, pts, u)
    pm = _port(jm)
    idx = TS.GridIndex.build(pm)
    grid = TS.find_closest_element(pm, _t(pts), index=idx)
    brute = TS.find_closest_element(pm, _t(pts))
    chunked = TS.find_closest_element(pm, _t(pts), index=idx, chunk_size=7)
    # every element's closest-point distance to every point, for the uniqueness of the nearest
    X = np.repeat(pm.cell_points()[None, :, :4], len(pts), 0).reshape(-1, 4, 3)
    all_d = TS.closest_point_in_element(pm.element, _t(X), _t(np.repeat(pts, pm.num_cells, 0)))[2]
    return dict(mesh=pm, index=idx, pts=pts, u=u, ref=ref, grid=grid, brute=brute, chunked=chunked,
                all_d=all_d.numpy().reshape(len(pts), pm.num_cells))


def test_find_closest_element_matches_jax_inside_and_outside(tet_location):
    loc = tet_location
    ref_e, ref_xi, ref_d = loc["ref"][:3]
    got = loc["grid"]
    exact = loc["all_d"].min(axis=1)
    assert np.abs(got.domain_distance.numpy() - ref_d).max() < 1e-10
    assert np.abs(got.domain_distance.numpy() - exact).max() < 1e-10
    assert (got.domain_distance[:60] == 0).all() and (got.domain_distance[60:] > 0).any()
    unique = _unique_nearest(loc["all_d"])
    assert unique.sum() >= 40
    np.testing.assert_array_equal(got.element_indices.numpy()[unique], ref_e[unique])
    assert np.abs(got.reference_coords.numpy()[unique] - ref_xi[unique]).max() < 1e-10


def test_find_closest_element_grid_matches_brute_force_and_chunks(tet_location):
    loc = tet_location
    grid, brute, chunked = loc["grid"], loc["brute"], loc["chunked"]
    assert np.abs(grid.domain_distance.numpy() - brute.domain_distance.numpy()).max() < 1e-12
    unique = _unique_nearest(loc["all_d"])
    np.testing.assert_array_equal(grid.element_indices.numpy()[unique], brute.element_indices.numpy()[unique])
    for a, b in zip(grid, chunked):
        assert torch.equal(a, b)


def test_find_closest_element_empty_cells_and_reruns(rng):
    """The L-shape with empty grid cells: points in the hole and far outside agree with the brute force over
    every element; some of them must go to the re-run.  The brute force at another chunk size is bitwise the
    same."""
    pm = _port(_l_shape())
    idx = TS.GridIndex.build(pm, avg_elements_per_cell=0.5)
    pts = np.concatenate([rng.uniform(0.6, 0.95, size=(15, 2)), rng.uniform(-1.0, 2.0, size=(25, 2))])
    before = TS.location_counts["reruns"]
    fast = TS.find_closest_element(pm, _t(pts), index=idx)
    assert TS.location_counts["reruns"] > before
    brute = TS.find_closest_element(pm, _t(pts), num_candidates=pm.num_cells)
    assert np.abs(fast.domain_distance.numpy() - brute.domain_distance.numpy()).max() < 1e-10
    small = TS.find_closest_element(pm, _t(pts), chunk_size=3)
    again = TS.find_closest_element(pm, _t(pts))
    for a, b in zip(small, again):
        assert torch.equal(a, b)


def test_brute_force_candidates_equal_a_full_scan(rng):
    """The brute-force branch's filtered candidates (an f32 centre-distance bound, then f64 box distances of
    the survivors) are the first k of a stable sort of every element's f64 box distance, ties included, at
    points inside, outside and exactly on vertices."""
    pm = _port(JP.create_unit_box_uniform_tet_mesh_3d(3))
    a = TS._mesh_arrays(pm, torch.device("cpu"), torch.float64)
    pts = np.concatenate([rng.uniform(-0.5, 1.5, size=(150, 3)), pm.points[rng.integers(0, pm.num_vertices, 50)]])
    d2, order = torch.sort(TS._aabb_d2(a["lo"][None], a["hi"][None], _t(pts)[:, None]), dim=1, stable=True)
    for k in (8, 32, pm.num_cells - 1):
        cand, box_d, limit = TS._brute_candidates(a, _t(pts), k)
        assert torch.equal(cand, order[:, :k]) and torch.equal(limit, torch.sqrt(d2[:, k]))
        assert torch.equal(box_d, torch.sqrt(d2[:, :k] + 1e-300))


@pytest.mark.parametrize("name", ["tri6", "quad9", "tet10", "hex8"])
def test_interpolation_matches_jax(name, rng, request):
    """``interpolate_at_points``, ``interpolate_gradient_at_points`` and ``FixedInterpolator`` (values and
    gradients) on points inside and outside: JAX's values at 1e-10 (one traced location a case; tet10's
    is the location fixture's), and a field of the element's degree reproduced with its gradient."""
    if name == "tet10":
        loc = request.getfixturevalue("tet_location")
        pm, idx, pts, u, ref = loc["mesh"], loc["index"], loc["pts"], loc["u"], loc["ref"]
    else:
        jm = _jax_mesh(name)
        d = jm.dim
        pts = np.concatenate([rng.uniform(0.03, 0.97, size=(30, jm.dim)), rng.uniform(-0.1, 1.1, size=(10, jm.dim))])
        u = rng.standard_normal(jm.num_vertices)
        ref = _jax_interpolation(jm, pts, u)
        pm = _port(jm)
        idx = TS.GridIndex.build(pm)
    d = pm.dim
    vals, res = TS.interpolate_at_points(pm, _t(u), _t(pts), index=idx)
    grads, _ = TS.interpolate_gradient_at_points(pm, _t(u), _t(pts), index=idx)
    assert np.abs(res.domain_distance.numpy() - ref[2]).max() < 1e-10
    assert rel_err(ref[3], vals) < 1e-10
    assert rel_err(ref[4], grads) < 1e-10
    fixed = TS.FixedInterpolator.from_space_and_points(pm, _t(pts), with_gradients=True, index=idx)
    assert rel_err(vals, fixed.interpolate(_t(u))) < 1e-12
    assert rel_err(grads, fixed.interpolate_gradient(_t(u))) < 1e-12
    deg = 1 if name == "hex8" else 2
    coef = rng.standard_normal(d)
    f = lambda p: 1.0 + p @ coef + (deg - 1) * (p[:, 0] * p[:, -1] + p[:, 0] ** 2)  # noqa: E731
    inside = pts[:30]
    fix2 = TS.FixedInterpolator.from_space_and_points(pm, _t(inside), with_gradients=True, index=idx)
    assert np.abs(fix2.interpolate(_t(f(pm.points)))[:, 0].numpy() - f(inside)).max() < 1e-10
    grad_exact = coef[None, :] + (deg - 1) * np.stack(
        [inside[:, -1] + 2 * inside[:, 0]] + [np.zeros(30)] * (d - 2) + [inside[:, 0]], 1)
    assert np.abs(fix2.interpolate_gradient(_t(f(pm.points)))[:, :, 0].numpy() - grad_exact).max() < 1e-9


# ---------------------------------------------------------------------------
# The tri3 error-estimation suite (port only, against the reference's values)
# ---------------------------------------------------------------------------


def _u(pts):
    return torch.sin(PI * pts[:, 0]) * torch.sin(PI * pts[:, 1])


def _grad(pts):
    return PI * torch.stack([torch.cos(PI * pts[:, 0]) * torch.sin(PI * pts[:, 1]),
                             torch.sin(PI * pts[:, 0]) * torch.cos(PI * pts[:, 1])], -1)


def _coarse(res):
    mesh = TP.create_unit_square_uniform_tri_mesh_2d(res)
    tab = tabulate(mesh.element, TQ.total_order.triangle(20))
    X = torch.as_tensor(mesh.cell_points())
    u = _u(torch.as_tensor(mesh.points))
    return X, u[torch.as_tensor(mesh.cells, dtype=torch.int64)][:, :, None], tab


def _fine_interpolant(fm, fidx, fu):
    """Values and gradients of the fine interpolant at the coarse quadrature points: located once
    (``FixedInterpolator``) when the estimators ask for the same points twice."""
    cache = {}

    def located(p):
        if "p" not in cache or not torch.equal(cache["p"], p):
            cache.update(p=p, f=TS.FixedInterpolator.from_space_and_points(fm, p, with_gradients=True, index=fidx))
        return cache["f"]

    return (lambda p: located(p).interpolate(fu)), (lambda p: located(p).interpolate_gradient(fu))


def test_error_estimation_default_subset():
    """The default subset of tests/test_error_estimation.py: analytic samples at coarse 1, 2, 4, 16 and the
    fine interpolants (1, 64), (4, 64), (16, 64), (2, 128), (8, 131), located through the grid index."""
    path = Path(__file__).parent / "reference_values" / "error_estimation_tri3_summary.json"
    samples = {(s["coarse_res"], s["fine_res"]): s for s in json.load(open(path))["samples"]}
    fine = {}
    for coarse, fine_res in [(1, 0), (2, 0), (4, 0), (16, 0), (1, 64), (4, 64), (16, 64), (2, 128), (8, 131)]:
        X, u_el, tab = _coarse(coarse)
        if fine_res == 0:
            u_ref, g_ref = (lambda p: _u(p)[:, None]), (lambda p: _grad(p)[:, :, None])
        else:
            if fine_res not in fine:
                fm = TP.create_unit_square_uniform_tri_mesh_2d(fine_res)
                fine[fine_res] = (fm, TS.GridIndex.build(fm), _u(torch.as_tensor(fm.points)))
            fm, fidx, fu = fine[fine_res]
            u_ref, g_ref = _fine_interpolant(fm, fidx, fu)
        l2 = float(estimate_L2_error_batched(X, u_el, u_ref, tab))
        h1 = float(estimate_H1_seminorm_error_batched(X, u_el, g_ref, tab))
        s = samples[(coarse, fine_res)]
        assert abs(l2 - s["L2_error"]) / s["L2_error"] <= 0.01, (s, l2)
        assert abs(h1 - s["H1_semi_error"]) / s["H1_semi_error"] <= 0.01, (s, h1)
