"""Port parity: quadrature tables (uniform, general, compact) and aggregate mixed-element assembly.

The JAX package and the port run on the same numpy meshes, rules and
data in f64: table assembly agrees to 1e-12; the aggregate pattern's
arrays (row pointers, columns, rows, diagonal positions and every
block's scatter map) are equal, its values agree to 1e-12 and two port
assemblies are bitwise equal.  JAX's references are traced once each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import LAM, MU, rel_err

from fenris_tpu import quadrature as JQ
from fenris_tpu.assembly import aggregate as JA
from fenris_tpu.assembly import quadrature_table as JT
from fenris_tpu.mesh import procedural as JP
from fenris_tpu.solid import LameParameters as JaxLame
from fenris_tpu.solid import MaterialEllipticOperator as JaxOperator
from fenris_tpu.solid import LinearElasticMaterial as JaxLinear
from fenris_tpu.solid import NeoHookeanMaterial as JaxNeoHookean
from fenris_tpu_torch import quadrature as TQ
from fenris_tpu_torch.assembly import aggregate as TA
from fenris_tpu_torch.assembly import quadrature_table as TT
from fenris_tpu_torch.assembly.global_ import element_dof_indices
from fenris_tpu_torch.operators import LaplaceOperator
from fenris_tpu_torch.reference_elements import ELEMENTS
from fenris_tpu_torch.solid import LameParameters, LinearElasticMaterial, MaterialEllipticOperator, NeoHookeanMaterial


@pytest.fixture(scope="module")
def hex_box():
    """A 4 x 2 x 2 hex8 box (16 cells: no element count equals a rule's point count), its cell points and a
    small displacement ``u_el [E, 8, 3]``."""
    rng = np.random.default_rng(3)
    mesh = JP.create_rectangular_uniform_hex_mesh(1.0, 2, 1, 1, 2)
    return mesh.cell_points(), 0.01 * rng.standard_normal((mesh.num_cells, 8, 3)), rng


def _jax_table_outputs(table, rho_table, X, u, op):
    def fn(Xj, uj):
        return (table.assemble_elliptic_matrices(Xj, uj, op), table.assemble_elliptic_vectors(Xj, uj, op),
                table.elliptic_energies(Xj, uj, op), rho_table.assemble_mass_matrices(Xj, 3),
                table.assemble_source_vectors(Xj, lambda x, p: jnp.stack([x[0], x[1] * x[2], 1.0 + 0 * x[0]]), 3))
    return [np.asarray(o) for o in jax.jit(fn)(jnp.asarray(X), jnp.asarray(u))]


def _port_table_outputs(table, rho_table, X, u, op):
    X, u = torch.as_tensor(X), torch.as_tensor(u)
    return [table.assemble_elliptic_matrices(X, u, op), table.assemble_elliptic_vectors(X, u, op),
            table.elliptic_energies(X, u, op), rho_table.assemble_mass_matrices(X, 3),
            table.assemble_source_vectors(X, lambda x, p: torch.stack([x[0], x[1] * x[2], 1.0 + 0 * x[0]]), 3)]


@pytest.mark.parametrize("case", ["uniform_per_element", "uniform_per_point", "general", "compact"])
def test_quadrature_tables_match_jax(case, hex_box):
    """Elliptic matrices, vectors and energies with the table's Lamé data (Neo-Hookean through the uniform
    tables, linear elasticity through the grouped ones), source vectors, and mass matrices through the same
    kind of table with a density as its data, against JAX at 1e-12."""
    X, u, rng = hex_box
    E = X.shape[0]
    el, jel = ELEMENTS["hex8"], JP.create_unit_box_uniform_hex_mesh_3d(1).element
    if case.startswith("uniform"):
        jop, op = JaxOperator(JaxNeoHookean(), dim=3), MaterialEllipticOperator(NeoHookeanMaterial(), dim=3)
    else:
        jop, op = JaxOperator(JaxLinear(), dim=3), MaterialEllipticOperator(LinearElasticMaterial(), dim=3)
    g2, g3 = TQ.hexahedron_gauss(2), TQ.hexahedron_gauss(3)
    jg2, jg3 = JQ.hexahedron_gauss(2), JQ.hexahedron_gauss(3)
    mu = MU * (1.0 + rng.random(E))
    rho = 1.0 + rng.random(E)
    jl = lambda m: JaxLame(mu=jnp.asarray(m), lam=LAM)  # noqa: E731
    tl = lambda m: LameParameters(mu=torch.as_tensor(np.asarray(m)), lam=LAM)  # noqa: E731
    if case in ("uniform_per_element", "uniform_per_point"):
        if case == "uniform_per_point":  # [E, q] leaves
            mu, rho = MU * (1.0 + rng.random((E, 8))), 1.0 + rng.random((E, 8))
        tables = [(JT.UniformQuadratureTable.from_rule(jel, jg2, data=d), TT.UniformQuadratureTable.from_rule(el, g2, data=t))
                  for d, t in ((jl(mu), tl(mu)), (jnp.asarray(rho), torch.as_tensor(rho)))]
    elif case == "general":  # two rules, per-group data
        ids = (np.arange(E) % 3 == 0).astype(np.int64)
        n1 = int(ids.sum())
        tables = [(JT.GeneralQuadratureTable.from_rules(jel, [jg2, jg3], ids, jd),
                   TT.GeneralQuadratureTable.from_rules(el, [g2, g3], ids, td))
                  for jd, td in (([jl(MU), jl(mu[:n1])], [tl(MU), tl(mu[:n1])]),
                                 ([2.0, jnp.asarray(rho[:n1])], [2.0, torch.as_tensor(rho[:n1])]))]
        assert tables[0][1].num_elements() == E and [len(g[0]) for g in tables[0][1].groups] == [E - n1, n1]
    else:  # per-element rules deduplicated, per-element data stacked per group
        rules = [g3 if e % 3 == 0 else g2 for e in range(E)]
        jrules = [jg3 if e % 3 == 0 else jg2 for e in range(E)]
        tables = [(JT.compact_quadrature_table(jel, jrules, jd), TT.compact_quadrature_table(el, rules, td))
                  for jd, td in (([JaxLame(mu=float(m), lam=LAM) for m in mu], [LameParameters(mu=float(m), lam=LAM) for m in mu]),
                                 ([float(r) for r in rho], [float(r) for r in rho]))]
        assert len(tables[0][1].groups) == 2 and tables[0][1].groups[1][2].mu.dtype == torch.float64
    (jt, tt), (jr, tr) = tables
    ref = _jax_table_outputs(jt, jr, X, u, jop)
    got = _port_table_outputs(tt, tr, X, u, op)
    for name, r, g in zip(["matrices", "vectors", "energies", "mass", "sources"], ref, got):
        assert rel_err(r, g) < 1e-12, (case, name)


def _mixed_square(nq):
    """Quads on [0, 0.5] x [0, 1] (nq x 2nq cells) and split quads on [0.5, 1] x [0, 1], nodes merged by
    coordinates (tests/test_aggregate.py)."""
    quads = JP.create_rectangular_uniform_quad_mesh_2d(0.5, 1, 2, nq, (0.0, 1.0))
    tris = JP.create_rectangular_uniform_quad_mesh_2d(0.5, 1, 2, nq, (0.5, 1.0)).split_into_triangles()
    pts = np.concatenate([quads.points, tris.points])
    uniq, inverse = np.unique(np.round(pts, 12), axis=0, return_inverse=True)
    return uniq, inverse[quads.cells.astype(np.int64)], inverse[tris.cells.astype(np.int64) + quads.num_vertices]


@pytest.fixture(scope="module")
def mixed():
    """The mixed square at 3 x 6 quads and 36 triangles, and its Laplace element matrices from the port's
    uniform tables (the same arrays go to JAX's aggregate assembly)."""
    pts, qcells, tcells = _mixed_square(3)
    tq = TT.UniformQuadratureTable.from_rule(ELEMENTS["quad4"], TQ.quadrilateral_gauss(2))
    tt = TT.UniformQuadratureTable.from_rule(ELEMENTS["tri3"], TQ.total_order.triangle(2))
    Aq = tq.assemble_elliptic_matrices(torch.as_tensor(pts[qcells]), None, LaplaceOperator())
    At = tt.assemble_elliptic_matrices(torch.as_tensor(pts[tcells]), None, LaplaceOperator())
    return pts, qcells, tcells, Aq, At


@pytest.mark.parametrize("s", [1, 2])
def test_aggregate_pattern_equals_jax(s, mixed):
    pts, qcells, tcells = mixed[:3]
    ref = JA.aggregate_csr_pattern([qcells, tcells], len(pts), s)
    got = TA.aggregate_csr_pattern([qcells, tcells], len(pts), s, device="cpu")
    for key in ("row_ptr", "col_indices", "rows_of_nnz", "diag_positions", "scatter_indices"):
        np.testing.assert_array_equal(getattr(got.pattern, key).numpy(), np.asarray(getattr(ref.pattern, key)), key)
    assert got.pattern.num_rows == ref.pattern.num_rows and got.pattern.solution_dim == s
    assert len(got.block_scatter) == 2
    for a, b in zip(got.block_scatter, ref.block_scatter):
        np.testing.assert_array_equal(a.numpy(), b)


def test_aggregate_assembly_matches_jax_and_repeats(mixed):
    """The mixed Laplacian's values against JAX's on the same element matrices (1e-12), bitwise on a second
    assembly, and the interior row sums zero."""
    pts, qcells, tcells, Aq_t, At_t = mixed
    ref = np.asarray(JA.assemble_aggregate_csr([jnp.asarray(Aq_t.numpy()), jnp.asarray(At_t.numpy())],
                                               JA.aggregate_csr_pattern([qcells, tcells], len(pts), 1)))
    agg = TA.aggregate_csr_pattern([qcells, tcells], len(pts), 1, device="cpu")
    values = TA.assemble_aggregate_csr([Aq_t, At_t], agg)
    assert rel_err(ref, values) < 1e-12
    assert torch.equal(values, TA.assemble_aggregate_csr([Aq_t, At_t], agg))
    rows = agg.pattern.rows_of_nnz.long()
    sums = torch.zeros(agg.pattern.num_rows, dtype=values.dtype).index_add_(0, rows, values)
    interior = (pts[:, 0] > 1e-9) & (pts[:, 0] < 1 - 1e-9) & (pts[:, 1] > 1e-9) & (pts[:, 1] < 1 - 1e-9)
    assert sums[torch.as_tensor(interior)].abs().max() <= 1e-12 * values.abs().max()


def test_aggregate_vector_matches_jax(rng):
    mesh = JP.create_unit_square_uniform_tri_mesh_2d(3)
    half = mesh.num_cells // 2
    b1 = rng.standard_normal((half, 3))
    b2 = rng.standard_normal((mesh.num_cells - half, 3))
    dofs = element_dof_indices(mesh.cells, 1)
    ref = np.asarray(JA.assemble_aggregate_vector([jnp.asarray(b1), jnp.asarray(b2)], [dofs[:half], dofs[half:]],
                                                  mesh.num_vertices))
    got = TA.assemble_aggregate_vector([torch.as_tensor(b1), torch.as_tensor(b2)], [dofs[:half], dofs[half:]],
                                       mesh.num_vertices)
    assert rel_err(ref, got) < 1e-12
