"""Port parity: symbolic and numeric CSR assembly, the Dirichlet elimination and the CSR matrix.

The JAX package (``fenris_tpu.assembly.global_``, ``fenris_tpu.sparse``,
f64 on the CPU) and the port (``device="cpu"``) run on the same numpy
meshes and values: the pattern arrays must be identical, the numeric
results equal to f64 roundoff (1e-13; the sums run in the same element
order).  ``HyperelasticModel.assemble_hessian_csr`` is held against the
JAX model on a small hex8 linear-elastic box.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import LAM, MU, rel_err, rng

import fenris_tpu.assembly.global_ as JG
import fenris_tpu.sparse as JS
from fenris_tpu.elasticity import HyperelasticModel as JaxModel
from fenris_tpu.mesh import procedural as JP
from fenris_tpu.mesh.convert import convert_mesh as jax_convert
from fenris_tpu.solid import LameParameters as JaxLame
from fenris_tpu.solid import LinearElasticMaterial as JaxLinear
import fenris_tpu_torch.assembly.global_ as TG
import fenris_tpu_torch.sparse as TS
from fenris_tpu_torch.elasticity import HyperelasticModel as TorchModel
from fenris_tpu_torch.fem import FemSpace
from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d as torch_box
from fenris_tpu_torch.mesh.procedural import create_unit_square_uniform_quad_mesh_2d
from fenris_tpu_torch.solid import LameParameters as TorchLame
from fenris_tpu_torch.solid import LinearElasticMaterial as TorchLinear

PATTERN_FIELDS = ("row_ptr", "col_indices", "scatter_indices", "rows_of_nnz", "diag_positions")
_PATTERNS = {}


def jax_mesh(name, res=3):
    """tri3 or quad4 on the unit square, converted to tri6 or quad9 (JAX's numbering, which the port
    reproduces: tests/test_torch_poisson2d.py)."""
    base = (JP.create_unit_square_uniform_tri_mesh_2d if name.startswith("tri") else
            JP.create_unit_square_uniform_quad_mesh_2d)(res)
    return base if name in ("tri3", "quad4") else jax_convert(base, name)


def patterns(name, s):
    """JAX's and the port's pattern of the res-3 mesh at block size ``s`` (cached: each is built once)."""
    if (name, s) not in _PATTERNS:
        m = jax_mesh(name)
        cells = np.asarray(m.cells)
        _PATTERNS[name, s] = (cells, JG.csr_pattern(cells, m.num_vertices, s),
                              TG.csr_pattern(cells, m.num_vertices, s, device="cpu"))
    return _PATTERNS[name, s]


@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("name", ["tri3", "tri6", "quad9"])
def test_pattern_matches_jax(name, s):
    """Every array of the pattern, dtype and value, as JAX's ``csr_pattern`` builds it."""
    _, jp, tp = patterns(name, s)
    assert (tp.num_rows, tp.num_cols, tp.solution_dim, tp.nnz) == (jp.num_rows, jp.num_cols, s, jp.nnz)
    for field in PATTERN_FIELDS:
        ref, got = np.asarray(getattr(jp, field)), getattr(tp, field).numpy()
        assert got.dtype == ref.dtype, field
        np.testing.assert_array_equal(got, ref, err_msg=field)


@pytest.mark.parametrize("name,s", [("tri6", 1), ("quad9", 2)])
def test_numeric_csr_and_dirichlet_match_jax(name, s):
    """``assemble_csr``, the three Dirichlet functions, ``spmv``, ``to_dense`` and ``diagonal``
    on random element matrices, f64, within 1e-13."""
    cells, jp, tp = patterns(name, s)
    g = rng(5)
    E, nd, _ = jp.scatter_indices.shape
    el = g.standard_normal((E, nd, nd))
    ref = np.asarray(JG.assemble_csr(jnp.asarray(el), jp))
    got = TG.assemble_csr(torch.as_tensor(el), tp)
    assert rel_err(ref, got) <= 1e-13
    nodes = np.array([0, 4, 7, 11])
    ref_bc = np.asarray(JG.apply_homogeneous_dirichlet_bc_csr(jnp.asarray(ref), jp, nodes))
    got_bc = TG.apply_homogeneous_dirichlet_bc_csr(torch.as_tensor(ref.copy()), tp, nodes)
    np.testing.assert_array_equal(got_bc.numpy(), ref_bc)
    rhs = g.standard_normal(jp.num_rows)
    np.testing.assert_array_equal(TG.apply_homogeneous_dirichlet_bc_rhs(torch.as_tensor(rhs), nodes, s).numpy(),
                                  np.asarray(JG.apply_homogeneous_dirichlet_bc_rhs(jnp.asarray(rhs), nodes, s)))
    jm, tm = JS.from_pattern(jp, jnp.asarray(ref_bc)), TS.from_pattern(tp, torch.as_tensor(ref_bc))
    dense = np.asarray(JS.to_dense(jm))
    assert rel_err(dense, TS.to_dense(tm)) <= 1e-13
    assert rel_err(np.asarray(jm.diagonal()), tm.diagonal()) <= 1e-13
    x = g.standard_normal(jp.num_cols)
    assert rel_err(np.asarray(JS.spmv(jm, jnp.asarray(x))), tm @ torch.as_tensor(x)) <= 1e-13
    ref_dense_bc = np.asarray(JG.apply_homogeneous_dirichlet_bc_matrix(jnp.asarray(dense), nodes, s))
    assert rel_err(ref_dense_bc, TG.apply_homogeneous_dirichlet_bc_matrix(torch.as_tensor(dense), nodes, s)) <= 1e-13


def test_dirichlet_scale_is_the_first_nonzero_diagonal():
    """The elimination's diagonal value: the first nonzero |diagonal| entry, else 1 (global.rs:390-398)."""
    _, jp, tp = patterns("tri3", 1)
    values = np.zeros(jp.nnz)
    dpos = np.asarray(jp.diag_positions)
    values[dpos[3]], values[dpos[5]] = -2.5, 7.0  # rows 0-2 have zero diagonals
    nodes = np.array([1, 6])
    for vals in (values, np.zeros(jp.nnz)):
        ref = np.asarray(JG.apply_homogeneous_dirichlet_bc_csr(jnp.asarray(vals), jp, nodes))
        got = TG.apply_homogeneous_dirichlet_bc_csr(torch.as_tensor(vals), tp, nodes).numpy()
        np.testing.assert_array_equal(got, ref)
    assert got[dpos[1]] == 1.0 and ref[dpos[1]] == 1.0
    assert TG.assemble_scalar(torch.arange(5.0, dtype=torch.float64)).item() == 10.0


def test_assemble_csr_sums_in_element_order():
    """The scatter's layers: every stored entry sums its contributions in element order, so the
    values equal a sequential accumulation bitwise (f32, where the order shows)."""
    cells, _, tp = patterns("quad9", 1)
    el = rng(8).standard_normal((cells.shape[0], 9, 9)).astype(np.float32) * 1e3
    got = TG.assemble_csr(torch.as_tensor(el), tp).numpy()
    seq = np.zeros(tp.nnz, np.float32)
    for idx, v in zip(tp.scatter_indices.numpy().reshape(-1), el.reshape(-1)):
        seq[idx] += v
    np.testing.assert_array_equal(got, seq)
    assert tp.scatter.layers is not None and len(tp.scatter.layers) == 4  # a vertex shared by 4 quads


def test_fem_space_pattern_is_built_once_on_its_device():
    mesh = create_unit_square_uniform_quad_mesh_2d(2)
    space = FemSpace.create(mesh, 2, torch.float64, "cpu")
    assert "pattern" not in space.__dict__  # lazy
    p = space.pattern
    assert space.pattern is p and p.row_ptr.device.type == "cpu" and p.num_rows == 2 * mesh.num_vertices
    np.testing.assert_array_equal(space.X_full.numpy(), mesh.cell_points())
    assert space.X_geo.is_contiguous()


def test_csr_builders_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    mesh = create_unit_square_uniform_quad_mesh_2d(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TG.csr_pattern(mesh.cells, mesh.num_vertices)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FemSpace.create(mesh)


@pytest.mark.parametrize("clamped", [False, True])
def test_assemble_hessian_csr_matches_jax(clamped):
    """A linear-elastic hex8 box (res 2), with and without the z = 0 plane clamped: the CSR values of
    the Hessian at a random state and their product, f64."""
    jmesh = JP.create_unit_box_uniform_hex_mesh_3d(2)
    tmesh = torch_box(2)
    fixed = np.flatnonzero(np.asarray(jmesh.points)[:, 2] < 1e-12) if clamped else None
    jm = JaxModel(mesh=jmesh, material=JaxLinear(), params=JaxLame(MU, LAM), dirichlet_nodes=fixed,
                  dtype=jnp.float64)
    tm = TorchModel(mesh=tmesh, material=TorchLinear(), params=TorchLame(MU, LAM), dirichlet_nodes=fixed,
                    dtype=torch.float64, device="cpu")
    u = rng(3).uniform(-0.01, 0.01, tm.space.num_dofs)
    ref = np.asarray(jm.assemble_hessian_csr(jnp.asarray(u)))
    got = tm.assemble_hessian_csr(torch.as_tensor(u))
    assert rel_err(ref, got) <= 1e-13
    for field in PATTERN_FIELDS:
        np.testing.assert_array_equal(getattr(tm.space.pattern, field).numpy(), np.asarray(getattr(jm.space.pattern, field)))
    v = rng(4).standard_normal(tm.space.num_dofs)
    ref_v = np.asarray(JS.spmv(JS.from_pattern(jm.space.pattern, jnp.asarray(ref)), jnp.asarray(v)))
    assert rel_err(ref_v, TS.from_pattern(tm.space.pattern, got) @ torch.as_tensor(v)) <= 1e-13
