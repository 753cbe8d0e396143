"""Port parity: ``fenris_tpu_torch.geometry`` and the procedural sphere against the JAX package's geometry.

Mirrors tests/test_geometry.py and tests/test_polyhedron.py: each case runs
the same numpy inputs through both packages (``G``: the geometry package,
``P``: its procedural meshes, ``M``: its ``Mesh``) and the results must be
equal, bit for bit: the port's geometry is the same host-numpy code.
"""

import numpy as np
import pytest

import fenris_tpu.geometry as jgeo
import fenris_tpu.mesh as jmesh
import fenris_tpu.mesh.procedural as jproc
import fenris_tpu_torch.geometry as tgeo
import fenris_tpu_torch.mesh as tmesh
import fenris_tpu_torch.mesh.procedural as tproc

PACKAGES = {"jax": (jgeo, jproc, jmesh), "torch": (tgeo, tproc, tmesh)}


def _rng(seed=1234):
    return np.random.default_rng(seed)


def _random_affine(rng, scale=1.0):
    while True:
        A = rng.standard_normal((3, 3)) * scale
        if np.linalg.det(A) > 0.1 * scale**3:
            return A, rng.standard_normal(3) * 2.0


def _square():
    return np.array([[0.0, 0], [1, 0], [1, 1], [0, 1]])


def _box_polymesh(G, P, M, lo=-2.0, hi=2.0):
    mesh = P.create_unit_box_uniform_hex_mesh_3d(2)
    return G.PolyMesh.from_cell_mesh(M.Mesh(np.asarray(mesh.points) * (hi - lo) + lo, mesh.cells, mesh.element))


def _polymesh(pm):
    return {"vertices": pm.vertices, "faces": [list(map(int, f)) for f in pm.faces],
            "cells": [list(map(int, c)) for c in pm.cells]}


def _mesh(m):
    return {"points": m.points, "cells": np.asarray(m.cells), "element": m.element.name}


# -- the cases: (G, P, M) -> results ---------------------------------------------------------------


def case_aabb(G, P, M):
    box = G.Aabb(np.array([0.0, 0.0]), np.array([1.0, 2.0]))
    pts = _rng().uniform(-1, 3, size=(20, 2))
    other = G.Aabb(np.array([0.5, -1.0]), np.array([2.0, 0.5]))
    return [box.contains(pts), box.dist2(pts), box.closest_point(pts), box.center, box.max_dist2(pts),
            box.grow(0.5).extents, box.intersects(other), box.enclose(other).min, box.enclose(other).max,
            G.Aabb.from_points(pts).min, G.Aabb.from_points(pts).max]


def case_orientation(G, P, M):
    p = _rng().standard_normal((4, 10, 3))
    return [G.orient2d(p[0, :, :2], p[1, :, :2], p[2, :, :2]), G.orient3d(*p)]


def case_halfspace_plane_sdfs(G, P, M):
    rng = _rng()
    hs = G.HalfSpace.from_point_and_normal([0.0, 0.0, 0.5], [0.3, 0.0, 1.0])
    pts3 = rng.uniform(-2, 2, size=(30, 3))
    plane = G.Plane(np.array([0.0, 0, 1.0]), np.array([0.0, 0.6, 0.8]))
    ball = G.Ball(center=np.array([0.1, -0.2]), radius=2.0)
    box = G.BoxSdf(np.array([0.0, 0.0]), np.array([1.0, 1.5]))
    union = G.SdfUnion((ball, box))
    pts = rng.uniform(-3, 3, size=(50, 2))
    return [hs.signed_distance(pts3), hs.contains(pts3), plane.project(pts3), ball.eval(pts), ball.gradient(pts),
            ball.bounding_box(), box.eval(pts), box.gradient(pts), box.bounding_box(), union.eval(pts),
            union.gradient(pts), union.bounding_box()]


def case_segments_and_lines(G, P, M):
    rng = _rng()
    s = G.LineSegment(np.array([0.0, 0.0]), np.array([2.0, 0.0]))
    hp = G.HalfPlane.from_point_and_normal([1.0, 0.0], [1.0, 0.0])
    l1 = G.Line.from_point_and_dir([0.0, 0.0], [1.0, 0.0])
    l2 = G.Line.from_point_and_dir([2.0, -1.0], [0.0, 1.0])
    l3 = G.Line.from_point_and_dir([0.0, 0, 0], [0, 0, 2.0])
    plane = G.Plane(np.array([0.0, 0, 1.0]), np.array([0.0, 0, 1.0]))
    s3 = G.LineSegment(np.array([0.0, 0, -1]), np.array([0.5, 0.2, 2.0]))
    out = [s.midpoint, s.length, s.tangent_dir(), s.normal_dir(), s.closest_point(rng.standard_normal((5, 2))),
           s.intersect_segment_parametric(G.LineSegment(np.array([1.0, -1.0]), np.array([1.0, 1.0]))),
           s.intersect_half_plane_parametric(hp), s.intersect_half_plane(hp).b, s.distance([1.0, 3.0]),
           l1.intersect_line_parametric(l2), l1.intersect(l2), l1.project_point_parametric([3.0, 7.0]),
           l3.intersect_plane_parametric(plane), s3.intersect_plane_parametric(plane), s3.closest_point_to_plane(plane)]
    for _ in range(10):
        out.append(G.segment_segment_closest(*rng.standard_normal((4, 3))))
    return out


def case_triangles(G, P, M):
    rng = _rng()
    tri = np.array([[0.0, 0, 0], [2.0, 0, 0], [0.0, 2.0, 0]])
    queries = [[0.5, 0.5, 3.0], [-1.0, -1.0, 1.0], [3.0, -1.0, 0.0], [-0.5, 3.0, -2.0], [1.0, -1.0, 0.5],
               [-1.0, 1.0, 0.0], [2.0, 2.0, 0.0]]
    out = [G.triangle_closest_point(tri, q) for q in queries]
    for _ in range(10):
        t, p = rng.standard_normal((3, 3)), 2.0 * rng.standard_normal(3)
        T = G.Triangle(t)
        out += [T.closest_point(p), T.distance(p), T.area(), T.normal(), T.centroid(), T.solid_angle(p), T.edge(1).a]
    out.append(G.Triangle(np.array([[0.0, 0], [1, 0], [0, 1]])).area())
    return out


def case_tetrahedra(G, P, M):
    rng = _rng()
    tet = G.Tetrahedron(np.array([[0.0, 0, 0], [1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]]))
    tet2 = G.Tetrahedron(tet.vertices[[1, 0, 2, 3]])
    out = [tet.signed_volume(), tet2.signed_volume(), tet.volume(), tet.centroid(), G.Tetrahedron.reference().vertices]
    for p in [[0.1, 0.1, 0.1], [1.0, 1.0, 1.0], [0.25, 0.25, -1.0]] + list(rng.standard_normal((10, 3))):
        out += [tet.contains_point(p), tet.closest_point(p), tet.distance(p), tet2.distance(p),
                G.tetrahedron_closest_point(tet2.vertices, p)]
    return out


def case_winding_number_cube(G, P, M):
    surf = P.create_unit_box_uniform_hex_mesh_3d(1).boundary_mesh().split_into_triangles()
    tris = [surf.points[c] for c in np.asarray(surf.cells)]
    oriented = []
    for t in tris:
        n = np.cross(t[1] - t[0], t[2] - t[0])
        oriented.append(t if n @ (t.mean(axis=0) - 0.5) > 0 else t[[0, 2, 1]])
    return [G.compute_winding_number_for_triangles_3d(oriented, p) for p in ([0.5, 0.5, 0.5], [2.0, 2.0, 2.0])]


def case_simple_polygons(G, P, M):
    square = G.SimplePolygon2d.from_vertices(_square())
    ell = G.SimplePolygon2d.from_vertices([[0.0, 0], [2, 0], [2, 1], [1, 1], [1, 2], [0, 2]])
    out = [square.signed_area(), square.orientation(), G.SimplePolygon2d.from_vertices(_square()[::-1]).signed_area(),
           ell.area(), square.triangulate()]
    for q in ([0.5, 0.3], [1.5, 0.5], [2.0, -1.0], [0.99, 0.01], [1.01, 0.5], [2.0, 0.5], [0.5, 0.5]):
        e = square.closest_edge(q)
        out += [e.signed_distance, e.edge_point, square.contains_point(q), square.distance(q), ell.closest_edge(q)]
    out += [square.intersects_segment(a, b) for a, b in (([-1.0, 0.5], [2.0, 0.5]), ([0.2, 0.2], [0.8, 0.8]),
                                                          ([2.0, 2.0], [3.0, 2.0]))]
    poly = G.SimplePolygon3d.from_vertices([[0.0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])
    clipped = poly.intersect_half_space(G.HalfSpace.from_point_and_normal([0.25, 0.0, 0.0], [1.0, 0.0, 0.0]))
    return out + [poly.area(), poly.normal(), clipped.area(), clipped.vertices]


def case_convex_polygons(G, P, M):
    rng = _rng()
    square = G.ConvexPolygon.from_vertices(_square())
    half = G.HalfPlane.from_point_and_normal([0.5, 0.0], [1.0, 0.0])
    other = G.ConvexPolygon.from_vertices(_square() + 0.5)
    inter = square.intersect_polygon(other)
    out = [square.is_convex(), square.contains_point([0.5, 0.5]), square.contains_point([1.5, 0.5]),
           square.intersect_halfplane(half).area(), inter.area(), inter.vertices, inter.triangulate(),
           square.intersect_polygon(G.ConvexPolygon.from_vertices(_square() + 5.0)).is_empty()]
    poly = G.ConvexPolygon.from_vertices(2.0 * _square())
    for _ in range(12):
        poly = poly.intersect_halfplane(G.HalfPlane.from_point_and_normal(rng.uniform(0, 2, 2), rng.standard_normal(2)))
        out += [poly.vertices, poly.area(), poly.is_convex()]
    seg = G.ConvexPolygon(np.array([[0.0, 0.0], [1.0, 0.0]]))
    out += [seg.contains_point(p, tol=t) for p, t in (([0.5, -5.0], 0.0), ([1.5, 0.0], 1e-9), ([0.5, 0.0], 1e-12),
                                                      ([0.25, 1e-13], 1e-12))]
    out.append(G.convex_polygon_clip_halfplane(_square(), G.HalfSpace.from_point_and_normal([0.5, 0.0], [1.0, 0.0])))
    return out


def case_polymesh_clips(G, P, M):
    rng = _rng()
    pm = G.PolyMesh.from_hex_mesh(P.create_unit_box_uniform_hex_mesh_3d(2))
    out = [pm.volume(), pm.surface_area(), pm.find_boundary_faces(), pm.cell_vertex_sets()]
    for _ in range(4):
        p, n = rng.uniform(0.2, 0.8, size=3), rng.standard_normal(3)
        for normal in (n, -n):
            c = pm.intersect_half_space(G.HalfSpace.from_point_and_normal(p, normal))
            out += [_polymesh(c), c.volume()]
    oblique = pm.intersect_half_space(G.HalfSpace.from_point_and_normal([0.5, 0.5, 0.5], [1.0, 1.0, 1.0]))
    unit = G.PolyMesh.from_hex_mesh(P.create_unit_box_uniform_hex_mesh_3d(1))
    corner = unit.intersect_half_space(G.HalfSpace.from_point_and_normal([0.5, 0.0, 0.0], [1.0, 1.0, 1.0]))
    halves = []
    for ax in range(3):
        for sign, off in ((1.0, 0.75), (-1.0, 0.25)):
            n, p = np.zeros(3), np.full(3, 0.5)
            n[ax], p[ax] = sign, off
            halves.append(G.HalfSpace.from_point_and_normal(p, n))
    inner = pm.intersect_convex_polyhedron(halves)
    return out + [_polymesh(oblique), _polymesh(corner), corner.volume(), _polymesh(inner), inner.volume()]


def case_polymesh_from_tet_mesh(G, P, M):
    pm = G.PolyMesh.from_cell_mesh(P.create_unit_box_uniform_tet_mesh_3d(2))
    return [_polymesh(pm), pm.volume(), pm.surface_area(), pm.find_boundary_faces(), _mesh(pm.triangulate()),
            _polymesh(pm.translate([1.0, 2.0, 3.0]))]


def case_quads(G, P, M):
    rng = _rng()
    q = G.Quad3d.from_vertices([[0, 0, 0], [2, 0, 0], [2, 1, 0], [0, 1, 0]])
    unit = G.Quad3d.from_vertices([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]])
    out = [q.area(), q.compute_normal(), q.compute_area_vector()]
    for p in ([0.5, 0.5, 2.0], [0.5, -1.0, 0.0], [-3.0, -4.0, 0.0]):
        r = unit.closest_point(p)
        out += [r.closest_point, r.distance]
    convex = G.Quad2d.from_vertices(_square())
    dart = G.Quad2d.from_vertices([[0, 0], [2, 0], [0.5, 0.5], [0, 2]])
    out += [convex.concave_corner(), convex.split_into_triangle_connectivities(), convex.area(), dart.concave_corner(),
            dart.split_into_triangle_connectivities(), [t.vertices for t in dart.split_into_triangles()], dart.area()]
    for _ in range(10):
        ang = np.sort(rng.uniform(0, 2 * np.pi, size=6))
        A, b = _random_affine(rng)
        pts3 = np.concatenate([np.stack([np.cos(ang), np.sin(ang)], 1), np.zeros((6, 1))], 1) @ A.T + b
        r = G.Polygon3d.from_vertices(pts3).closest_point(rng.standard_normal(3) * 3.0)
        out += [r.closest_point, r.distance]
        quad = G.Quad2d.from_vertices(rng.standard_normal((4, 2)))
        out += [quad.concave_corner(), quad.area(), quad.distance(rng.standard_normal(2) * 3.0)]
    return out


def case_hexahedra(G, P, M):
    rng = _rng()
    h = G.Hexahedron.reference()
    out = [h.num_faces, h.compute_volume(), h.contains_point([0.0, 0.0, 0.0]), h.contains_point([1.5, 0.0, 0.0]),
           h.compute_signed_distance([0.0, 0.0, 0.0]), h.compute_signed_distance([2.0, 0.0, 0.0]),
           h.distance([0.0, 0.0, 0.0]), h.bounding_box().min, h.bounding_box().max,
           [f.compute_normal() for f in h.faces()], G.compute_polyhedron_volume_from_faces(h.faces())]
    for _ in range(8):
        A, b = _random_affine(rng)
        hx = G.Hexahedron(G.Hexahedron.reference().vertices @ A.T + b)
        out.append(hx.compute_volume())
        for p in rng.standard_normal((5, 3)) * 2.5:
            sd = hx.compute_signed_distance(p)
            out += [sd.signed_distance, sd.point, hx.contains_point(p)]
    v = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    tet = G.ConvexPolyhedron.from_vertices_and_faces(v, [(0, 1, 2), (3, 2, 1), (3, 1, 0), (3, 0, 2)])
    out += [tet.compute_volume(), tet.contains_point([0.1, 0.1, 0.1]), tet.compute_signed_distance([0.1, 0.1, 0.1]),
            tet.compute_signed_distance([1.0, 1.0, 1.0])]
    A = np.diag(rng.uniform(0.3, 0.9, size=3))
    hs = G.Hexahedron(G.Hexahedron.reference().vertices @ A.T)
    pm = _box_polymesh(G, P, M)
    clipped = pm.intersect_convex_polyhedron(hs)
    clipped2 = pm.intersect_convex_polyhedron(hs.half_spaces())
    return out + [_polymesh(clipped), clipped.volume(), _polymesh(clipped2), hs.compute_volume()]


def case_util(G, P, M):
    v = _rng().standard_normal((40, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    close = lambda a, b: abs(a - b) < 1e-9  # noqa: E731
    return [G.compute_orthonormal_vectors_3d(v), G.slices_are_equal_shift_invariant([1, 2, 3], [3, 1, 2]),
            G.slices_are_equal_shift_invariant([1, 2, 3], [3, 2, 1]), G.slices_are_equal_shift_invariant([], []),
            G.slices_are_equal_shift_invariant([1], [1, 1]),
            G.slices_are_equal_shift_invariant([1.0, 2.0], [2.0, 1.0 + 1e-12], close)]


def case_sphere(G, P, M):
    """``create_simple_stupid_sphere`` (procedural.rs:405) and its triangulation."""
    pm = P.create_simple_stupid_sphere([1.0, -2.0, 0.5], 1.0, 6)
    tet = pm.triangulate()
    return [_polymesh(pm), pm.volume(), pm.surface_area(), _mesh(tet)]


CASES = {name[5:]: fn for name, fn in dict(globals()).items() if name.startswith("case_")}


def _equal(a, b, path="result"):
    """Recursive exact equality of nested results (numpy arrays, numbers, strings, tuples, dicts, dataclasses)."""
    if hasattr(a, "__dataclass_fields__") or (isinstance(a, tuple) and hasattr(a, "_fields")):
        a, b = vars(a) if hasattr(a, "__dataclass_fields__") else a._asdict(), \
            vars(b) if hasattr(b, "__dataclass_fields__") else b._asdict()
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif a is None or isinstance(a, str):
        assert a == b, path
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape and x.dtype == y.dtype, f"{path}: {x.shape} {x.dtype} vs {y.shape} {y.dtype}"
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), f"{path}: {x} vs {y}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_geometry_matches_jax(case):
    _equal(CASES[case](*PACKAGES["torch"]), CASES[case](*PACKAGES["jax"]))


def test_sphere_volume_and_triangulation():
    """The sphere's volume is within (0.8, 1.5) x 4π/3, centred on its centre, and its tet4 triangulation (a mesh
    of the port) has the same volume (tests/test_geometry.py's checks on the port's sphere)."""
    pm = tproc.create_simple_stupid_sphere([1.0, -2.0, 0.5], 1.0, 6)
    vol = pm.volume()
    assert 0.8 * 4.0 / 3.0 * np.pi < vol < 1.5 * 4.0 / 3.0 * np.pi
    assert np.allclose(0.5 * (pm.vertices.min(axis=0) + pm.vertices.max(axis=0)), [1.0, -2.0, 0.5], atol=1e-9)
    tet = pm.triangulate()
    assert isinstance(tet, tmesh.Mesh) and tet.element.name == "tet4"
    v = tet.points[tet.cells]
    assert abs((np.abs(np.linalg.det(v[:, 1:] - v[:, :1])) / 6.0).sum() - vol) < 1e-9
    with pytest.raises(ValueError):
        tproc.create_simple_stupid_sphere([0.0, 0.0, 0.0], 1.0, 0)


def test_polygonal_vtu_export_matches_jax(tmp_path):
    """``export_vtu`` writes the JAX package's bytes: polygons through the port's ``write_vtu_polygons``, and the
    tetrahedralised volume through its ``write_vtu``."""
    for polygonal in (True, False):
        files = {}
        for name, (G, P, M) in PACKAGES.items():
            pm = _box_polymesh(G, P, M).intersect_convex_polyhedron(G.Hexahedron.reference())
            files[name] = tmp_path / f"{name}_{polygonal}.vtu"
            pm.export_vtu(files[name], polygonal=polygonal)
        assert files["torch"].read_bytes() == files["jax"].read_bytes()
