"""The port's CUDA kernels against their plain versions on a card (``cuda``-marked).

JAX-free: imports only ``torch``, ``numpy``, ``pytest`` and
``fenris_tpu_torch``, and builds its inputs with numpy from a seed, so it
runs where the port runs.  Without a card every test skips.  On a card
``chip_smoke.py`` runs this file after its kernel build::

    python -m pytest -q -p no:cacheprovider --noconftest -o markers="cuda: needs a card" tests/test_torch_cuda.py

Each kernel check is ``max |kernel - plain| / max |plain| < 1e-5`` (f32
roundoff: FMA contraction and summation order), with two launches bitwise
equal where the kernel promises it.
"""

import numpy as np
import pytest
import torch

import fenris_tpu_torch.assembly.local_em as TLE
import fenris_tpu_torch.ops.banded as tb
import fenris_tpu_torch.ops.dia_sweep as tds
import fenris_tpu_torch.ops.em_sweep as tes
import fenris_tpu_torch.ops.stiffness_pairs as tsk
import fenris_tpu_torch.ops.structured_stencil as tss
from fenris_tpu_torch.assembly.local import assemble_element_elliptic_matrices, tabulate
from fenris_tpu_torch.elasticity import HyperelasticModel
from fenris_tpu_torch.mesh import Mesh
from fenris_tpu_torch.mesh.convert import convert_mesh
from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d as box
from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_tet_mesh_3d as tet_box
from fenris_tpu_torch.mesh.reorder import reorder_mesh
from fenris_tpu_torch.operators import LaplaceOperator
from fenris_tpu_torch.quadrature import Rule, canonical_stiffness, total_order
from fenris_tpu_torch.reference_elements import HEX8, element
from fenris_tpu_torch.solid import LameParameters, LinearElasticMaterial, MaterialEllipticOperator
from fenris_tpu_torch.solid import NeoHookeanMaterial, StVKMaterial
from fenris_tpu_torch.sparse.block_dia import assemble_block_dia, block_dia_assembly_plan

MU, LAM = 384.614, 576.923  # the flagship model's Lamé parameters
KERNEL_RTOL = 1e-5  # f32 roundoff (FMA contraction, summation order)


def rng(seed):
    return np.random.default_rng(seed)


def rel_err(ref, got) -> float:
    """max |ref - got| / max |ref| over float64 copies on the CPU."""
    ref, got = ref.detach().double().cpu(), got.detach().double().cpu()
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float((ref - got).abs().max() / ref.abs().max())


def hex8_tab():
    return tabulate(HEX8, canonical_stiffness("hex8"))


def stiffness_case(kind):
    if kind == "laplace":
        return LaplaceOperator(), None
    return MaterialEllipticOperator(LinearElasticMaterial(), dim=3), LameParameters(MU, LAM)


def perturbed_cells(res, seed=0, amp=0.2):
    """Box hex8 element coordinates ``[E, 8, 3]`` with nodes moved by up to ``amp`` of a cell."""
    mesh = box(res)
    pts = mesh.points + rng(seed).uniform(-amp, amp, mesh.points.shape) / res
    return pts[mesh.cells]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# -- structured stencils (csrc/structured_stencil.cu) ------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("cells", [(5, 4, 11), (15, 7, 5), (33, 9, 17), (1, 1, 1), (64, 20, 26), (2, 17, 33),
                                   (2, 17, 1)])
def test_stencil_kernels_match_plain_on_card(cells, cuda_device):
    """Ragged tiles (32 x 10 nodes), slabs (13 layers), a tile's extra last node on each axis, one cell
    or one cell layer."""
    h = 0.25
    ncx, ncy, ncz = cells
    g = rng(0)
    shape = (3, ncz + 1, ncy + 1, ncx + 1)
    u, v = g.uniform(-0.02 * h, 0.02 * h, shape), g.standard_normal(shape)
    gp, w = tss.gp_table(h)
    ut = torch.as_tensor(u, dtype=torch.float32, device=cuda_device)
    vt = torch.as_tensor(v, dtype=torch.float32, device=cuda_device)
    for kernel, plain, args in (
        (tss.neo_hookean_residual, tss.neo_hookean_residual_plain, (ut,)),
        (tss.neo_hookean_hvp, tss.neo_hookean_hvp_plain, (ut, vt)),
    ):
        got = kernel(*args, gp, w, MU, LAM)
        again = kernel(*args, gp, w, MU, LAM)
        torch.cuda.synchronize()
        assert rel_err(plain(*args, gp, w, MU, LAM), got) < KERNEL_RTOL
        assert torch.equal(got, again)  # no atomics: bitwise reproducible


@pytest.mark.cuda
def test_residual_kernel_allocates_only_its_output(cuda_device):
    """One launch, no scratch: a residual call allocates its output and nothing else."""
    h = 0.25
    gp, w = tss.gp_table(h)
    u = torch.as_tensor(rng(2).uniform(-0.02 * h, 0.02 * h, (3, 14, 23, 40)), dtype=torch.float32, device=cuda_device)
    tss.neo_hookean_residual(u, gp, w, MU, LAM)  # the library and the factors, once
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0, n0 = torch.cuda.memory_allocated(), tss.neo_hookean_residual.launches
    out = tss.neo_hookean_residual(u, gp, w, MU, LAM)
    torch.cuda.synchronize()
    assert tss.neo_hookean_residual.launches == n0 + 1
    assert torch.cuda.max_memory_allocated() - m0 <= -(-out.numel() * 4 // 512) * 512


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["hvp", "residual"])
def test_hvp_kernel_refuses_what_it_does_not_take(kernel, cuda_device):
    """A CUDA input launches the kernel or raises: other tables, dtypes, layouts and devices raise."""
    h = 0.25
    gp, w = tss.gp_table(h)
    shape = (3, 4, 5, 6)
    g = rng(1)
    u = torch.as_tensor(g.uniform(-0.02 * h, 0.02 * h, shape), dtype=torch.float32, device=cuda_device)
    v = torch.as_tensor(g.standard_normal(shape), dtype=torch.float32, device=cuda_device)
    if kernel == "hvp":
        fn = tss.neo_hookean_hvp
        call = lambda a, b, table: fn(a, b, table, w, MU, LAM)  # noqa: E731
    else:
        fn = tss.neo_hookean_residual
        call = lambda a, b, table: fn(b, table, w, MU, LAM)  # noqa: E731  (the residual takes v's place)
    stretched = gp.copy()
    stretched[4:] *= 1.5  # not a uniform tensor-product table
    before = fn.launches
    with pytest.raises(ValueError, match="tensor-product"):
        call(u, v, stretched)
    with pytest.raises(TypeError, match="f32-only"):
        call(u.double(), v.double(), gp)
    with pytest.raises(ValueError, match="contiguous"):
        call(u.transpose(2, 3), v.transpose(2, 3), gp)
    # the Hessian action with v on the CPU; the residual on another device (on the CPU it runs the plain version)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        call(u, v.cpu() if kernel == "hvp" else v.to("meta"), gp)
    assert fn.launches == before


# -- element stiffness (csrc/stiffness_pairs.cu) --------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["linear", "laplace"])
def test_stiffness_kernel_matches_plain_on_card(kind, cuda_device):
    op, params = stiffness_case(kind)
    tab = hex8_tab()
    Xt = torch.as_tensor(perturbed_cells(5), dtype=torch.float32, device=cuda_device)
    got = tsk.stiffness_pairs(Xt, op, params, tab)
    again = tsk.stiffness_pairs(Xt, op, params, tab)
    torch.cuda.synchronize()
    assert rel_err(tsk.stiffness_pairs_plain(Xt, op, params, tab), got) < KERNEL_RTOL
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("num_elements", [1, 33, 1331])
@pytest.mark.parametrize("kind", ["linear", "laplace"])
def test_stiffness_kernel_ragged_tiles_on_card(kind, num_elements, cuda_device):
    """Element counts that are not a multiple of the kernel's 32-element tile: the ragged last
    tile, bitwise repeats, the launch count and exact mirror blocks."""
    op, params = stiffness_case(kind)
    tab = hex8_tab()
    Xt = torch.as_tensor(perturbed_cells(11, seed=3)[:num_elements], dtype=torch.float32, device=cuda_device)
    assert tsk.supports_stiffness_kernel(op, params, tab, Xt)
    before = tsk.stiffness_pairs.launches
    got = tsk.stiffness_pairs(Xt, op, params, tab)
    again = tsk.stiffness_pairs(Xt, op, params, tab)
    torch.cuda.synchronize()
    assert tsk.stiffness_pairs.launches == before + 2
    assert got.shape == (op.solution_dim**2, 64, num_elements)
    assert rel_err(tsk.stiffness_pairs_plain(Xt, op, params, tab), got) < KERNEL_RTOL
    assert torch.equal(got, again)
    s = op.solution_dim
    blocks = got.reshape(s, s, 8, 8, num_elements)
    for i in range(s):
        for j in range(i + 1, s):  # mirror blocks are exact node transposes
            assert torch.equal(blocks[j, i], blocks[i, j].transpose(0, 1))


STIFFNESS_ELEMENTS = ["tet4", "tet10", "tet20", "hex8", "hex20", "hex27", "quad4", "quad8", "quad9", "tri3", "tri6"]


def stiffness_inputs(name, kind, count, seed=11):
    """``(X [E, m, d] f32 on the card, op, params, tab, E)`` of a perturbed box or square of the element,
    repeated to ``count``: 1, a tile (``launch_layout``'s elements a block) less or more one element, or
    three tiles and five elements."""
    d = 2 if name in ("quad4", "quad8", "quad9", "tri3", "tri6") else 3
    if kind == "laplace":
        op, params = LaplaceOperator(), None
    else:
        op, params = MaterialEllipticOperator(LinearElasticMaterial(), dim=d), LameParameters(MU, LAM)
    tab = tabulate(element(name), canonical_stiffness(name))
    tile = tsk.launch_layout(op, params, tab)["elements"]
    E = {"one": 1, "tile-1": tile - 1, "tile+1": tile + 1, "ragged": 3 * tile + 5}[count]
    mesh = square_mesh(name, 4) if d == 2 else element_mesh(name, 2)
    m = mesh.element.geometry.num_nodes
    pts = mesh.points + rng(seed).uniform(-0.03, 0.03, mesh.points.shape)
    X = np.concatenate([pts[mesh.cells[:, :m]]] * -(-E // mesh.num_cells))[:E]
    return torch.as_tensor(X, dtype=torch.float32, device="cuda"), op, params, tab, E


def check_stiffness_launch(X, op, params, tab, E):
    """Two launches against the plain version: within KERNEL_RTOL, bitwise equal, two launches counted, and for a
    symmetric operator mirror blocks exact node transposes, a scalar block exactly symmetric."""
    assert tsk.supports_stiffness_kernel(op, params, tab, X)
    before = tsk.stiffness_pairs.launches
    got = tsk.stiffness_pairs(X, op, params, tab)
    again = tsk.stiffness_pairs(X, op, params, tab)
    torch.cuda.synchronize()
    assert tsk.stiffness_pairs.launches == before + 2
    s, n = op.solution_dim, tab.dphi.shape[1]
    assert got.shape == (s * s, n * n, E)
    assert rel_err(tsk.stiffness_pairs_plain(X, op, params, tab), got) < KERNEL_RTOL
    assert torch.equal(got, again)
    if not op.symmetric:
        return
    blocks = got.reshape(s, s, n, n, E)
    for i in range(s):
        for j in range(i + 1, s):
            assert torch.equal(blocks[j, i], blocks[i, j].transpose(0, 1))
    if tsk.launch_layout(op, params, tab)["form"] in ("scalar", "sums"):
        assert torch.equal(blocks[0, 0], blocks[0, 0].transpose(0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("count", ["one", "tile-1", "tile+1", "ragged"])
@pytest.mark.parametrize("kind", ["linear", "laplace"])
@pytest.mark.parametrize("name", STIFFNESS_ELEMENTS)
def test_stiffness_kernel_at_tile_edges_on_card(name, kind, count, cuda_device):
    """Every element of both dimensions, linear elasticity (the matrix form's isotropic terms) and
    Laplace (the scalar form; tet20's reference sums), at element counts around the launch's tile: 1, a tile less and more one
    element, and three tiles and five elements (``check_stiffness_launch``)."""
    check_stiffness_launch(*stiffness_inputs(name, kind, count))


class _Anisotropic(LaplaceOperator):
    """s = 1 with a constant contraction that is symmetric but not positive definite, or not symmetric: the
    kernel's matrix form at one contraction pair."""

    def __init__(self, symmetric):
        self.symmetric = symmetric
        C = np.array([[1.0, 0.3, -0.2], [0.1, -0.5, 0.4], [0.2, 0.0, 2.0]])
        self.C = 0.5 * (C + C.T) if symmetric else C

    def contraction(self, G, params):
        d = G.shape[-2]
        D = torch.as_tensor(self.C[:d, :d], dtype=G.dtype, device=G.device)[:, None, :, None]
        return D.expand(tuple(G.shape[:-2]) + tuple(D.shape))


@pytest.mark.cuda
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("name", ["tet10", "hex8", "hex20", "quad9"])
def test_stiffness_kernel_matrix_form_at_one_pair_on_card(name, symmetric, cuda_device):
    """An s = 1 contraction without a Cholesky factor takes the matrix form, three tiles and five elements."""
    X, _, _, tab, E = stiffness_inputs(name, "laplace", "ragged")
    op = _Anisotropic(symmetric)
    assert tsk.launch_layout(op, None, tab)["form"] == "matrix"
    check_stiffness_launch(X, op, None, tab, E)


class _Constant(LaplaceOperator):
    """A constant contraction ``D [d, s, d, s]`` (symmetric operators: ``D[k, i, m, j] = D[m, j, k, i]``)."""

    def __init__(self, D, symmetric):
        self.D, self.solution_dim, self.symmetric = D, D.shape[1], symmetric

    def contraction(self, G, params):
        D = torch.as_tensor(self.D, dtype=G.dtype, device=G.device)
        return D.expand(tuple(G.shape[:-2]) + tuple(D.shape))


def _general_contraction(d, symmetric, seed=3):
    """An anisotropic s = d contraction: symmetric positive definite as a [d², d²] matrix, or neither."""
    A = rng(seed).standard_normal((d * d, d * d))
    D = A @ A.T + d * d * np.eye(d * d) if symmetric else A + 2 * np.eye(d * d)
    return _Constant(D.reshape(d, d, d, d), symmetric)


@pytest.mark.cuda
@pytest.mark.parametrize("name, symmetric", [("tet10", True), ("hex8", True), ("hex20", True), ("quad9", False),
                                             ("tri6", False)])
def test_stiffness_kernel_general_contraction_on_card(name, symmetric, cuda_device):
    """The matrix form at P > 1 with every term: an anisotropic symmetric s = 3 contraction (six pairs and
    their mirrors) and a non-symmetric s = 2 one (four pairs), three tiles and five elements."""
    X, _, _, tab, E = stiffness_inputs(name, "linear", "ragged")
    op = _general_contraction(X.shape[2], symmetric)
    assert tsk.launch_layout(op, None, tab)["form"] == "matrix"
    check_stiffness_launch(X, op, None, tab, E)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tet10", "hex20", "quad8"])
def test_stiffness_kernel_isotropic_terms_match_general_form_on_card(name, cuda_device):
    """Linear elasticity's isotropic launch against the same contraction given as a non-symmetric operator,
    which takes the general matrix form with every term: the upper blocks are bitwise equal."""
    X, op, params, tab, E = stiffness_inputs(name, "linear", "ragged")
    d = X.shape[2]
    general = _Constant(op.contraction(torch.zeros((d, d), dtype=torch.float64), params).numpy(), False)
    assert tsk.launch_layout(op, params, tab)["form"] == "isotropic"
    assert tsk.launch_layout(general, None, tab)["form"] == "matrix"
    iso = tsk.stiffness_pairs(X, op, params, tab).reshape(d, d, -1, E)
    full = tsk.stiffness_pairs(X, general, None, tab).reshape(d, d, -1, E)
    for i in range(d):
        for j in range(i, d):
            assert torch.equal(iso[i, j], full[i, j]), (i, j)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["linear", "laplace"])
@pytest.mark.parametrize("name, strength", [("hex20", 6), ("hex27", 12), ("tet20", 10), ("quad9", 11)])
def test_stiffness_kernel_large_rules_on_card(name, strength, kind, cuda_device):
    """Total-order rules past the canonical ones (hex20 34 points, hex27 343, tet20 81, quad9 28): the 3D
    tables take several chunks of points in the matrix form (``launch_layout``), three tiles and five
    elements."""
    X, op, params, _, E = stiffness_inputs(name, kind, "ragged")
    tab = tabulate(element(name), total_order.for_domain(element(name).geometry.domain, strength))
    lay = tsk.launch_layout(op, params, tab)
    if name != "quad9" and kind == "linear":
        assert lay["chunk_points"] < tab.num_points, lay
    check_stiffness_launch(X, op, params, tab, E)


def _keast_tab(name):
    """A rule with a negative weight: Keast's 5-point tetrahedron rule (degree 3), on the tets as it is and
    on hex8 mapped to [-1, 1]^3 with a sixth point of weight 0."""
    a, b = 0.5, 1 / 6
    pts = np.array([[0.25] * 3, [b, b, b], [a, b, b], [b, a, b], [b, b, a]])
    w = np.array([-2 / 15, 3 / 40, 3 / 40, 3 / 40, 3 / 40])
    if name == "hex8":
        pts, w = np.concatenate([2 * pts - 1, [[0.1, 0.2, 0.3]]]), np.concatenate([8 * w, [0.0]])
    return tabulate(element(name), Rule(w, pts))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["linear", "laplace"])
@pytest.mark.parametrize("name", ["tet4", "tet10", "tet20", "hex8"])
def test_stiffness_kernel_negative_weights_on_card(name, kind, cuda_device):
    """A rule with a negative weight (``_keast_tab``): its point's products are subtracted (in tet20's reference
    sums for Laplace, as they are)."""
    X, op, params, _, E = stiffness_inputs(name, kind, "ragged")
    check_stiffness_launch(X, op, params, _keast_tab(name), E)


# -- band sweep (csrc/dia_sweep.cu) ---------------------------------------------------------

_PLANE_SWAP = np.arange(7**3)  # node renumbering of the plane-swapped res-6 box
_PLANE_SWAP[:49], _PLANE_SWAP[98:147] = np.arange(98, 147), np.arange(49)


def _block_dia_operator(name):
    """f64 Neo-Hookean tangent bands: exact DIA on a res-4 box, or with a remainder on the res-6
    box with node planes z = 0 and z = 2 renumbered into each other."""
    if name == "exact":
        mesh, kw = box(4), {}
    else:
        m6 = box(6)
        moved = np.empty_like(m6.points)
        moved[_PLANE_SWAP] = m6.points  # node i is now numbered _PLANE_SWAP[i]
        mesh, kw = Mesh(moved, _PLANE_SWAP[m6.cells], HEX8), {"min_fill": 0.2}
    model = HyperelasticModel(mesh=mesh, material=NeoHookeanMaterial(), params=LameParameters(384.0, 577.0),
                              dirichlet_nodes=np.arange(25), dtype=torch.float64, device="cpu")
    u = rng(6).standard_normal(model.space.num_dofs) * 0.01
    return model.assemble_hessian_block_dia(torch.as_tensor(u), **kw)


def element_mesh(name, res):
    base = tet_box(res) if name.startswith("tet") else box(res)
    return base if name in ("tet4", "hex8") else convert_mesh(base, name)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["linear", "laplace"])
@pytest.mark.parametrize("name", ["tet4", "tet10", "tet20", "hex20", "hex27"])
def test_stiffness_kernel_on_3d_elements_on_card(name, kind, cuda_device):
    """The higher-order and tet elements, 77 elements (a ragged last tile) of a perturbed box: against the
    plain version, bitwise repeats, the launch count and exact mirror blocks."""
    op, params = stiffness_case(kind)
    mesh = element_mesh(name, 3)
    m, n = mesh.element.geometry.num_nodes, mesh.element.num_nodes
    pts = mesh.points + rng(7).uniform(-0.05, 0.05, mesh.points.shape)
    X = np.concatenate([pts[mesh.cells[:, :m]]] * 4)[:77]
    Xt = torch.as_tensor(X, dtype=torch.float32, device=cuda_device)
    tab = tabulate(element(name), canonical_stiffness(name))
    assert tsk.supports_stiffness_kernel(op, params, tab, Xt)
    before = tsk.stiffness_pairs.launches
    got = tsk.stiffness_pairs(Xt, op, params, tab)
    again = tsk.stiffness_pairs(Xt, op, params, tab)
    torch.cuda.synchronize()
    assert tsk.stiffness_pairs.launches == before + 2
    s = op.solution_dim
    assert got.shape == (s * s, n * n, 77)
    assert rel_err(tsk.stiffness_pairs_plain(Xt, op, params, tab), got) < KERNEL_RTOL
    assert torch.equal(got, again)
    blocks = got.reshape(s, s, n, n, 77)
    for i in range(s):
        for j in range(i + 1, s):
            assert torch.equal(blocks[j, i], blocks[i, j].transpose(0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["exact", "remainder"])
def test_dia_sweep_kernel_matches_plain_on_card(name, cuda_device):
    tm = _block_dia_operator(name)
    assert (tm.remainder is None) == (name == "exact")
    bands = tm.bands.to(device=cuda_device, dtype=torch.float32)
    x2 = torch.as_tensor(rng(11).standard_normal((3, tm.num_nodes)), dtype=torch.float32, device=cuda_device)
    got = tds.dia_sweep(bands, tm.offsets, x2)
    again = tds.dia_sweep(bands, tm.offsets, x2)
    torch.cuda.synchronize()
    assert rel_err(tds.dia_sweep_plain(bands, tm.offsets, x2), got) < KERNEL_RTOL
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_dia_sweep_kernel_scalar_on_card(cuda_device):
    """The band sweep at s = 1 (the Poisson operator's layout) on a ragged N: the res-6 Laplace bands."""
    mesh = box(6)
    tab = hex8_tab()
    plan = block_dia_assembly_plan(mesh.cells, mesh.num_vertices, 1, device="cpu")
    X = torch.as_tensor(mesh.points[mesh.cells] + rng(14).uniform(-0.02, 0.02, (mesh.num_cells, 8, 3)))
    A = assemble_block_dia(plan, assemble_element_elliptic_matrices(X, None, LaplaceOperator(), None, tab))
    bands = A.bands.to(device=cuda_device, dtype=torch.float32)
    x2 = torch.as_tensor(rng(15).standard_normal((1, A.num_nodes)), dtype=torch.float32, device=cuda_device)
    got = tds.dia_sweep(bands, A.offsets, x2)
    again = tds.dia_sweep(bands, A.offsets, x2)
    torch.cuda.synchronize()
    assert A.num_nodes == 343 and len(A.offsets) == 27
    assert rel_err(tds.dia_sweep_plain(bands, A.offsets, x2), got) < KERNEL_RTOL
    assert torch.equal(got, again)


# -- banded gather and scatter (csrc/banded.cu) --------------------------------------------

# (mesh, res, s, r_nodes, rowt): a box, an RCM-reordered box with one component,
# and a box with several owner blocks (ragged counts)
BANDED_CASES = {
    "box5_s3": ("box", 5, 3, 1024, 256),
    "rcm6_s1": ("rcm", 6, 1, 1024, 256),
    "box12_s3_blocks": ("box", 12, 3, 1024, 256),
    # the scalar (Poisson) layouts: one component on the boxes the s = 3 cases use
    "box5_s1": ("box", 5, 1, 1024, 256),
    "box12_s1_blocks": ("box", 12, 1, 1024, 256),
    # the 2D layouts (s = 2): a quad4 square of three owner blocks, the last one short, and RCM'd tri6
    "quad4_s2_blocks": ("quad4", 48, 2, 1024, 256),
    "tri6_s2": ("tri6", 16, 2, 1024, 256),
    # a fan of tri3 whose centre has 2,548 rows (the scatter walks them in hundreds of batches)
    "star_s1": ("star", 2548, 1, 1024, 256),
    "star_s2": ("star", 2548, 2, 1024, 256),
    "star_s3": ("star", 2548, 3, 1024, 256),
}


def star_cells(m):
    """A closed fan of ``m`` tri3 around node 0 (rim nodes 1..m): node 0 has ``m`` rows."""
    rim = np.arange(1, m + 1)
    return np.stack([np.zeros(m, np.int64), rim, np.roll(rim, -1)], axis=1)


def banded_cells(kind, res):
    if kind == "star":
        return star_cells(res)
    if kind == "quad4":
        return square_mesh("quad4", res).cells
    if kind == "tri6":
        return reorder_mesh(square_mesh("tri6", res))[0].cells
    return (box(res) if kind == "box" else reorder_mesh(box(res))[0]).cells


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BANDED_CASES))
def test_banded_kernels_match_plain_on_card(name, cuda_device):
    """Gather and scatter bitwise equal to their plain versions and to their own repeats (the star: one node
    with thousands of rows)."""
    kind, res, s, r_nodes, rowt = BANDED_CASES[name]
    cells = banded_cells(kind, res)
    N = int(cells.max()) + 1
    tp = tb.make_banded_plan(cells, N, s=s, r_nodes=r_nodes, rowt=rowt, device=cuda_device)
    if kind == "star":
        assert int(tp.row_ptr[1] - tp.row_ptr[0]) == res
    before = (tb.banded_gather.launches, tb.banded_scatter.launches)
    u = torch.as_tensor(rng(12).standard_normal((N, s)), dtype=torch.float32, device=cuda_device)
    got = tb.banded_gather(tp, u)
    again = tb.banded_gather(tp, u)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, tb.banded_gather_plain(tp, u))
    f = torch.as_tensor(rng(13).standard_normal((tp.padded_elements, tp.n, s)), dtype=torch.float32,
                        device=cuda_device)
    got = tb.banded_scatter(tp, f)
    again = tb.banded_scatter(tp, f)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, tb.banded_scatter_plain(tp, f))
    assert (tb.banded_gather.launches, tb.banded_scatter.launches) == (before[0] + 2, before[1] + 2)


@pytest.mark.cuda
def test_banded_launch_route_on_card(cuda_device):
    """On the card's torch: an untraced launch is called straight from Python, and under make_fx the custom
    op is what the trace records (the kernel still launches, once)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    cells = banded_cells("quad4", 8)
    N = int(cells.max()) + 1
    tp = tb.make_banded_plan(cells, N, s=2, r_nodes=1024, rowt=256, device=cuda_device)
    u = torch.as_tensor(rng(14).standard_normal((N, 2)), dtype=torch.float32, device=cuda_device)
    seen = []
    before = tb.banded_gather.launches
    graph = make_fx(lambda a: seen.append(tb._eager(a)) or tb.banded_gather(tp, a))(u)
    assert tb._eager(u) and seen == [False]
    assert "banded_gather_kernel" in str(graph.graph) and tb.banded_gather.launches == before + 1


@pytest.mark.cuda
def test_banded_gather_refuses_misaligned_input_on_card(cuda_device):
    """At s = 2 the gather loads a node as one float2: a view of u at an odd float offset is refused with
    a ValueError that names the alignment, before any launch."""
    cells = banded_cells("quad4", 8)
    N = int(cells.max()) + 1
    tp = tb.make_banded_plan(cells, N, s=2, r_nodes=1024, rowt=256, device=cuda_device)
    u = torch.zeros(2 * N + 1, device=cuda_device)[1:].view(N, 2)
    before = tb.banded_gather.launches
    with pytest.raises(ValueError, match="8-byte aligned"):
        tb.banded_gather(tp, u)
    assert tb.banded_gather.launches == before
    assert torch.equal(tb.banded_gather(tp, u.clone()), tb.banded_gather_plain(tp, u))


# -- element sweeps (csrc/em_sweep.cu) ------------------------------------------------------


def _neo_hookean_op():
    return MaterialEllipticOperator(NeoHookeanMaterial(), dim=3)


@pytest.mark.cuda
def test_banded_tangent_sweep_matches_plain_on_card(cuda_device):
    """RCM-reordered, perturbed res-11 box with two owner blocks of 1,024 nodes and padding rows."""
    res = 11
    mesh, _ = reorder_mesh(box(res))
    cells, N = mesh.cells, mesh.num_vertices
    g = rng(8)
    pts = mesh.points + g.uniform(-0.15, 0.15, (N, 3)) / res
    tp = tb.make_banded_plan(cells, N, s=3, r_nodes=1024, rowt=256, device=cuda_device)
    assert tp.k_blocks == 2 and tp.padded_elements > tp.num_elements
    u, v = g.uniform(-0.01, 0.01, (N, 3)), g.standard_normal((N, 3))
    op, tab, params = _neo_hookean_op(), hex8_tab(), LameParameters(MU, LAM)
    X_band = torch.as_tensor(tp.pad_elements(pts[cells]), dtype=torch.float32,
                             device=cuda_device).permute(1, 2, 0).contiguous()
    ut, vt = (torch.as_tensor(a, dtype=torch.float32, device=cuda_device) for a in (u, v))
    got = tes.banded_tangent_sweep(tp, X_band, ut, vt, op, params, tab)
    again = tes.banded_tangent_sweep(tp, X_band, ut, vt, op, params, tab)
    ref = tes.banded_tangent_sweep_plain(tp, X_band, ut, vt, op, params, tab)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # fixed lane reduction order, no atomics
    assert rel_err(ref, got) < KERNEL_RTOL


@pytest.mark.cuda
def test_banded_vector_sweep_matches_plain_on_card(cuda_device):
    """The fused residual sweep on an RCM-reordered, perturbed res-11 box with two owner blocks and padding
    rows: bitwise repeats, zero rows for padding elements, the plain version to f32 roundoff."""
    res = 11
    mesh, _ = reorder_mesh(box(res))
    cells, N = mesh.cells, mesh.num_vertices
    g = rng(9)
    pts = mesh.points + g.uniform(-0.15, 0.15, (N, 3)) / res
    tp = tb.make_banded_plan(cells, N, s=3, r_nodes=1024, rowt=256, device=cuda_device)
    assert tp.k_blocks == 2 and tp.padded_elements > tp.num_elements
    op, tab, params = _neo_hookean_op(), hex8_tab(), LameParameters(MU, LAM)
    X_band = torch.as_tensor(tp.pad_elements(pts[cells]), dtype=torch.float32,
                             device=cuda_device).permute(1, 2, 0).contiguous()
    ut = torch.as_tensor(g.uniform(-0.01, 0.01, (N, 3)), dtype=torch.float32, device=cuda_device)
    before = tes.banded_vector_sweep.launches
    got = tes.banded_vector_sweep(tp, X_band, ut, op, params, tab)
    again = tes.banded_vector_sweep(tp, X_band, ut, op, params, tab)
    ref = tes.banded_vector_sweep_plain(tp, X_band, ut, op, params, tab)
    torch.cuda.synchronize()
    assert tes.banded_vector_sweep.launches == before + 2
    assert torch.equal(got, again)  # fixed lane reduction order, no atomics
    padding = torch.as_tensor(tp.valid_elements(), device=cuda_device) == 0
    assert bool(padding.any()) and not bool(got[padding].any())
    assert rel_err(ref, got) < KERNEL_RTOL


@pytest.mark.cuda
def test_em_kernels_match_plain_on_card(cuda_device):
    """The element-minor sweeps on a perturbed res-3 box (``[8, 3, E]`` geometry and fields)."""
    res = 3
    mesh = box(res)
    g = rng(5)
    pts = mesh.points + g.uniform(-0.15, 0.15, mesh.points.shape) / res
    X = np.transpose(pts[mesh.cells], (1, 2, 0))
    E = X.shape[-1]
    u, v = g.uniform(-0.01, 0.01, (8, 3, E)), g.standard_normal((8, 3, E))
    op, tab, params = _neo_hookean_op(), hex8_tab(), LameParameters(MU, LAM)
    Xt, ut, vt = (torch.as_tensor(a, dtype=torch.float32, device=cuda_device) for a in (X, u, v))
    for got, ref in (
        (tes.em_vector_sweep(Xt, ut, op, params, tab), TLE.assemble_element_elliptic_vectors_em(Xt, ut, op, params, tab)),
        (tes.em_vector_tangent_sweep(Xt, ut, vt, op, params, tab),
         TLE.assemble_element_elliptic_tangent_vectors_em(Xt, ut, vt, op, params, tab)),
    ):
        torch.cuda.synchronize()
        assert rel_err(ref, got) < KERNEL_RTOL


# every element and material of the sweeps: a box with two owner blocks of 1,024 nodes (RCM-reordered), and
# 77 elements of a res-3 box (a ragged last tile for every element's tile: hex8's 4, the others' 32 or 64)
TWO_BLOCK_RES = {"tet4": 8, "tet10": 4, "tet20": 3, "hex8": 11, "hex20": 6, "hex27": 5}
SWEEP_MATERIALS = {"neo_hookean": NeoHookeanMaterial, "stvk": StVKMaterial, "linear": LinearElasticMaterial}


def _em_sweep_layout(name, mesh, cells, res, device, seed):
    """A banded plan of ``cells`` (1,024 nodes a block, rowt 256), the padded geometry ``[m, d, E_pad]``
    of the nodes perturbed by up to 5% of a cell, u ~ 1e-2 of a cell and v ~ N(0, 1)."""
    tab = tabulate(element(name), canonical_stiffness(name))
    m, d, N = tab.geo_dphi.shape[1], mesh.dim, mesh.num_vertices
    g = rng(res + seed)
    pts = mesh.points + g.uniform(-0.05, 0.05, mesh.points.shape) / res
    tp = tb.make_banded_plan(cells, N, s=d, r_nodes=1024, rowt=256, device=device)
    X = torch.as_tensor(tp.pad_elements(pts[cells[:, :m]]), dtype=torch.float32, device=device).permute(1, 2, 0)
    u, v = (torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in (g.uniform(-0.01, 0.01, (N, d)) / res, g.standard_normal((N, d))))
    return tab, tp, X.contiguous(), u, v


def _em_sweep_cases(tp, X, u, v):
    """The four element-sweep wrappers with their plain versions and arguments on one layout."""
    ue, ve = (tb.banded_gather(tp, a).permute(1, 2, 0) for a in (u, v))
    return (
        (tes.banded_vector_sweep, tes.banded_vector_sweep_plain, (tp, X, u)),
        (tes.banded_tangent_sweep, tes.banded_tangent_sweep_plain, (tp, X, u, v)),
        (tes.em_vector_sweep, TLE.assemble_element_elliptic_vectors_em, (X, ue)),
        (tes.em_vector_tangent_sweep, TLE.assemble_element_elliptic_tangent_vectors_em, (X, ue, ve)),
    )


def _check_em_sweeps(name, material, mesh_fn, two_block_res, device):
    """The four element-sweep wrappers of one element and material against their plain versions with
    bitwise repeats: the fused banded sweeps (padding rows zero) and the strided sweeps on the gathered
    element-major rows, on the two-block mesh and on 77 elements of a res-3 mesh (a ragged last tile for
    every tile of 4, 32 or 64 elements)."""
    for res, count in ((two_block_res, None), (3, 77)):
        mesh, _ = reorder_mesh(mesh_fn(name, res))
        op, params = MaterialEllipticOperator(SWEEP_MATERIALS[material](), dim=mesh.dim), LameParameters(MU, LAM)
        cells = mesh.cells if count is None else np.concatenate([mesh.cells] * -(-count // mesh.num_cells))[:count]
        tab, tp, X, u, v = _em_sweep_layout(name, mesh, cells, res, device, 0)
        assert tp.padded_elements > tp.num_elements and (count is not None or tp.k_blocks == 2)
        padding = torch.as_tensor(tp.valid_elements(), device=device) == 0
        launches = [f.launches for f in (tes.banded_vector_sweep, tes.banded_tangent_sweep, tes.em_vector_sweep,
                                         tes.em_vector_tangent_sweep)]
        for kernel, plain, args in _em_sweep_cases(tp, X, u, v):
            got, again = kernel(*args, op, params, tab), kernel(*args, op, params, tab)
            ref = plain(*args, op, params, tab)
            torch.cuda.synchronize()
            assert torch.equal(got, again), kernel.__name__  # fixed summation order, no atomics
            assert rel_err(ref, got) < KERNEL_RTOL, kernel.__name__
            if kernel.__name__.startswith("banded"):
                assert got.shape == (tp.padded_elements, tab.dphi.shape[1], mesh.dim)
                assert not bool(got[padding].any())
        assert [f.launches for f in (tes.banded_vector_sweep, tes.banded_tangent_sweep, tes.em_vector_sweep,
                                     tes.em_vector_tangent_sweep)] == [k + 2 for k in launches]


@pytest.mark.cuda
@pytest.mark.parametrize("material", list(SWEEP_MATERIALS))
@pytest.mark.parametrize("name", list(TWO_BLOCK_RES))
def test_em_sweeps_on_3d_elements_on_card(name, material, cuda_device):
    """The four element-sweep wrappers on a 3D element (``_check_em_sweeps``), u ~ 1e-2 of a cell,
    v ~ N(0, 1)."""
    _check_em_sweeps(name, material, element_mesh, TWO_BLOCK_RES[name], cuda_device)


# the 2D elements: a square with two owner blocks of 1,024 nodes (1,681 nodes; quad8 1,281)
TWO_BLOCK_RES_2D = {"quad4": 40, "quad8": 20, "quad9": 20, "tri3": 40, "tri6": 20}


@pytest.mark.cuda
@pytest.mark.parametrize("material", list(SWEEP_MATERIALS))
@pytest.mark.parametrize("name", list(TWO_BLOCK_RES_2D))
def test_em_sweeps_on_2d_elements_on_card(name, material, cuda_device):
    """The four element-sweep wrappers at d = 2 (``_check_em_sweeps``) on a perturbed unit square."""
    _check_em_sweeps(name, material, square_mesh, TWO_BLOCK_RES_2D[name], cuda_device)


# the elements of the general layouts (every element but hex8)
GENERAL_ELEMENTS = [name for name in (*TWO_BLOCK_RES, *TWO_BLOCK_RES_2D) if name != "hex8"]


@pytest.mark.cuda
@pytest.mark.parametrize("count", ["one", "tile-1", "tile+1", "two blocks"])
@pytest.mark.parametrize("name", GENERAL_ELEMENTS)
def test_em_sweeps_at_tile_edges_on_card(name, count, cuda_device):
    """Element counts around the launch's tile (``launch_layout``): 1, a tile less one and more one element, on
    plans with one row an element (rowt 1: no padding, E_pad not a multiple of 4, so X and the fields take the
    4-byte copies); and the two-block mesh of ``_check_em_sweeps`` with rowt 1, whose smaller owner block ends
    in padding rows.  The four wrappers of each material against their plain versions, bitwise repeats,
    padding rows zero, each wrapper's launch count up by 2."""
    d = 2 if name in TWO_BLOCK_RES_2D else 3
    mesh_fn = square_mesh if d == 2 else element_mesh
    res = (TWO_BLOCK_RES_2D if d == 2 else TWO_BLOCK_RES)[name] if count == "two blocks" else 3
    mesh, _ = reorder_mesh(mesh_fn(name, res))
    tab = tabulate(element(name), canonical_stiffness(name))
    tile = tes.launch_layout(MaterialEllipticOperator(NeoHookeanMaterial(), dim=d), tab, True)["elements"]
    E = {"one": 1, "tile-1": tile - 1, "tile+1": tile + 1, "two blocks": mesh.num_cells}[count]
    cells = np.concatenate([mesh.cells] * -(-E // mesh.num_cells))[:E]
    g = rng(res + 7)
    m, N = tab.geo_dphi.shape[1], mesh.num_vertices
    pts = mesh.points + g.uniform(-0.05, 0.05, mesh.points.shape) / res
    r_nodes = 1024 if count == "two blocks" else -(-N // 1024) * 1024  # else one owner block
    tp = tb.make_banded_plan(cells, N, s=d, r_nodes=r_nodes, rowt=1, device=cuda_device)
    assert count != "two blocks" or (tp.k_blocks == 2 and tp.padded_elements > tp.num_elements)
    assert count == "two blocks" or tp.padded_elements == E
    X = torch.as_tensor(tp.pad_elements(pts[cells[:, :m]]), dtype=torch.float32, device=cuda_device)
    X = X.permute(1, 2, 0).contiguous()
    u, v = (torch.as_tensor(a, dtype=torch.float32, device=cuda_device)
            for a in (g.uniform(-0.01, 0.01, (N, d)) / res, g.standard_normal((N, d))))
    ue, ve = (tb.banded_gather_plain(tp, a).permute(1, 2, 0) for a in (u, v))
    cases = (
        (tes.banded_vector_sweep, tes.banded_vector_sweep_plain, (tp, X, u)),
        (tes.banded_tangent_sweep, tes.banded_tangent_sweep_plain, (tp, X, u, v)),
        (tes.em_vector_sweep, TLE.assemble_element_elliptic_vectors_em, (X, ue)),
        (tes.em_vector_tangent_sweep, TLE.assemble_element_elliptic_tangent_vectors_em, (X, ue, ve)),
    )
    padding = torch.as_tensor(tp.valid_elements(), device=cuda_device) == 0
    for material, cls in SWEEP_MATERIALS.items():
        op, params = MaterialEllipticOperator(cls(), dim=d), LameParameters(MU, LAM)
        launches = [case[0].launches for case in cases]
        for kernel, plain, args in cases:
            got, again = kernel(*args, op, params, tab), kernel(*args, op, params, tab)
            ref = plain(*args, op, params, tab)
            torch.cuda.synchronize()
            assert torch.equal(got, again), (kernel.__name__, material)
            assert rel_err(ref, got) < KERNEL_RTOL, (kernel.__name__, material)
            if kernel.__name__.startswith("banded"):
                assert not bool(got[padding].any()), (kernel.__name__, material)
        assert [case[0].launches for case in cases] == [k + 2 for k in launches]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hex8", "tet10", "quad9", *(n for n in GENERAL_ELEMENTS if n not in ("tet10", "quad9"))])
def test_em_sweeps_per_element_params_on_card(name, cuda_device):
    """Per-element ``[E]`` Lamé parameters (a two-material solid, each value varied by up to 10%) in the
    four wrappers against their plain versions, bitwise repeatable; an ``[E]`` array of one repeated value,
    and a 0-d CUDA tensor (read by the kernel, no host sync), give the scalar launch bitwise."""
    mesh_fn, res = ((square_mesh, TWO_BLOCK_RES_2D[name]) if name in TWO_BLOCK_RES_2D
                    else (element_mesh, TWO_BLOCK_RES[name]))
    mesh, _ = reorder_mesh(mesh_fn(name, res))
    op = MaterialEllipticOperator(NeoHookeanMaterial(), dim=mesh.dim)
    tab, tp, X, u, v = _em_sweep_layout(name, mesh, mesh.cells, res, cuda_device, 1)
    g = rng(23)
    stiff = 1.0 + 9.0 * (mesh.points[mesh.cells].mean(1)[:, 0] > 0.5)
    mu, lam = (c * stiff * g.uniform(0.9, 1.1, mesh.num_cells) for c in (MU, LAM))

    def lame(*values):  # [E_pad] leaves in the padded element order, as X
        return LameParameters(*(torch.as_tensor(tp.pad_elements(x), dtype=torch.float32, device=cuda_device)
                                for x in values))

    params = lame(mu, lam)
    for kernel, plain, args in _em_sweep_cases(tp, X, u, v):
        got, again = kernel(*args, op, params, tab), kernel(*args, op, params, tab)
        ref = plain(*args, op, params, tab)
        scalar = kernel(*args, op, LameParameters(MU, LAM), tab)
        repeated = kernel(*args, op, lame(np.full_like(mu, MU), np.full_like(lam, LAM)), tab)
        device_scalar = kernel(*args, op, LameParameters(torch.tensor(MU, device=cuda_device),
                                                         torch.tensor(LAM, device=cuda_device)), tab)
        torch.cuda.synchronize()
        assert torch.equal(got, again), kernel.__name__
        assert rel_err(ref, got) < KERNEL_RTOL, kernel.__name__
        assert rel_err(scalar, got) > 1e-2, kernel.__name__  # the parameters differ from element to element
        assert torch.equal(repeated, scalar) and torch.equal(device_scalar, scalar), kernel.__name__


# -- models ---------------------------------------------------------------------------------


def _box_model(res, dtype, device, **kw):
    """tools/solve_assembled.py's model: unit box, z = 0 clamped, body force (0, 0, -4)."""
    mesh = box(res)
    return HyperelasticModel(mesh=mesh, material=kw.pop("material", NeoHookeanMaterial()),
                             params=LameParameters(MU, LAM), dirichlet_nodes=np.flatnonzero(mesh.points[:, 2] < 1e-12),
                             body_force=np.array([0.0, 0.0, -4.0]), dtype=dtype, device=device, **kw)


@pytest.mark.cuda
def test_fused_model_refuses_what_the_kernels_do_not_take(cuda_device):
    """A CUDA fused model the element-sweep kernels cannot run (f64, a material without closed forms, per-point
    ``[E, q]`` parameters on the banded path) raises; it does not fall back.  Every material and element the
    kernels take builds, per-element parameters and 2D meshes too."""
    from fenris_tpu_torch.solid import HyperelasticMaterial

    kw = dict(banded=True, fused_kernels=True)
    with pytest.raises(NotImplementedError, match="fused_kernels"):
        _box_model(2, torch.float64, cuda_device, **kw)
    with pytest.raises(NotImplementedError, match="material"):
        _box_model(2, torch.float32, cuda_device, material=HyperelasticMaterial(), **kw)
    mesh = box(2)
    with pytest.raises(ValueError, match="per-quadrature-point"):
        HyperelasticModel(mesh=mesh, material=NeoHookeanMaterial(),
                          params=LameParameters(np.full((mesh.num_cells, 8), MU), LAM), dtype=torch.float32,
                          device=cuda_device, **kw)
    HyperelasticModel(mesh=mesh, material=NeoHookeanMaterial(),
                      params=LameParameters(np.full(mesh.num_cells, MU), LAM), dtype=torch.float32,
                      device=cuda_device, **kw)
    _box_model(2, torch.float32, cuda_device, material=StVKMaterial(), **kw)
    tet = element_mesh("tet10", 2)
    HyperelasticModel(mesh=tet, material=LinearElasticMaterial(), params=LameParameters(MU, LAM),
                      dtype=torch.float32, device=cuda_device, **kw)
    HyperelasticModel(mesh=square_mesh("tri6", 2), material=NeoHookeanMaterial(), params=LameParameters(MU, LAM),
                      dtype=torch.float32, device=cuda_device, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["quad9", "tet10"])
def test_fused_model_with_per_element_params_on_card(name, cuda_device):
    """The fused model on the card (the kernels, parameters padded into the banded order) against the
    same model on the CPU (the plain versions) with per-element Lamé parameters: residual, Hessian action."""
    mesh, _ = reorder_mesh(square_mesh(name, 6) if name == "quad9" else element_mesh(name, 2))
    g = rng(29)
    mu = MU * g.uniform(0.5, 2.0, mesh.num_cells)
    fixed = np.flatnonzero(mesh.points[:, 0] < 1e-12)
    models = [HyperelasticModel(mesh=mesh, material=NeoHookeanMaterial(), params=LameParameters(mu, LAM),
                                dirichlet_nodes=fixed, body_force=np.array([0.0, -4.0, 0.0][: mesh.dim]),
                                dtype=torch.float32, device=dev, banded=True, fused_kernels=True, banded_r_nodes=1024)
              for dev in ("cpu", cuda_device)]
    u = g.uniform(-0.01, 0.01, models[0].space.num_dofs)
    v = g.standard_normal(models[0].space.num_dofs)
    before = (tes.banded_vector_sweep.launches, tes.banded_tangent_sweep.launches)
    out = [(m.residual(torch.as_tensor(u, dtype=torch.float32, device=m.device)),
            m.hessian_vector_product(torch.as_tensor(u, dtype=torch.float32, device=m.device),
                                     torch.as_tensor(v, dtype=torch.float32, device=m.device)))
           for m in models]
    torch.cuda.synchronize()
    assert (tes.banded_vector_sweep.launches, tes.banded_tangent_sweep.launches) == (before[0] + 1, before[1] + 1)
    assert rel_err(out[0][0], out[1][0]) < 1e-4  # f32 residual: the stress cancels to O(strain)
    assert rel_err(out[0][1], out[1][1]) < KERNEL_RTOL


@pytest.mark.cuda
def test_f64_banded_model_runs_on_card(cuda_device):
    """An f64 banded model takes the plain gather and scatter on the card (the kernel wrappers
    raise on f64) and equals the unbanded f64 model; an f32 banded model launches the kernels."""
    banded = _box_model(4, torch.float64, cuda_device, banded=True)
    plain = _box_model(4, torch.float64, cuda_device)
    u = torch.as_tensor(rng(7).uniform(-0.01, 0.01, plain.space.num_dofs), device=cuda_device)
    u = torch.where(plain.free_mask, u, 0.0)
    before = (tb.banded_gather.launches, tb.banded_scatter.launches)
    assert rel_err(plain.residual(u), banded.residual(u)) <= 1e-12
    assert rel_err(plain.hessian_diagonal(u), banded.hessian_diagonal(u)) <= 1e-12
    assert (tb.banded_gather.launches, tb.banded_scatter.launches) == before
    with pytest.raises(TypeError, match="f32"):
        tb.banded_gather(banded._plan, u.reshape(-1, 3))
    banded32 = _box_model(4, torch.float32, cuda_device, banded=True)
    r32 = banded32.residual(u.float())
    torch.cuda.synchronize()
    assert tb.banded_gather.launches > before[0] and tb.banded_scatter.launches > before[1]
    assert rel_err(plain.residual(u), r32) < 1e-4  # f32 against f64


# -- Poisson and the unstructured multigrid (fem.py, multigrid.py) --------------------------


def _poisson_problem():
    """The MMS problem of tests/mms_common.py in torch: source, exact solution, Dirichlet nodes."""

    def u_exact(x):
        return torch.sin(np.pi * x[0]) * torch.sin(np.pi * x[1]) * torch.sin(np.pi * x[2])

    def u_exact_grad(x):
        sn, cs = torch.sin(np.pi * x), torch.cos(np.pi * x)
        return np.pi * torch.stack([cs[0] * sn[1] * sn[2], sn[0] * cs[1] * sn[2], sn[0] * sn[1] * cs[2]])

    return (lambda x, p: 3.0 * np.pi**2 * u_exact(x)), u_exact, u_exact_grad


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["assembled", "matrix_free"])
def test_poisson_route_on_card_matches_cpu(route, cuda_device):
    """f32 Poisson at res 8 on the card (band sweep, or banded gather and scatter at s = 1) against the
    same route on the CPU: solutions within 1e-4 relative (f32 CG at rel 1e-6 on both), errors within
    1e-3, and the route's kernels launched."""
    from fenris_tpu_torch import fem
    from fenris_tpu_torch.quadrature import hexahedron_gauss

    solve = fem.solve_poisson_assembled if route == "assembled" else fem.solve_poisson_matrix_free
    counters = [tds.dia_sweep] if route == "assembled" else [tb.banded_gather, tb.banded_scatter]
    mesh = box(8)
    src, ue, ug = _poisson_problem()
    nd = np.flatnonzero(np.abs(mesh.points - 0.5).max(axis=1) > 0.4999)
    args = (mesh, hexahedron_gauss(2), hexahedron_gauss(6), src, ue, ug, nd)
    before = [k.launches for k in counters]
    card = solve(*args, rel_tolerance=1e-6, dtype=torch.float32, device=cuda_device)
    torch.cuda.synchronize()
    assert all(k.launches > b for k, b in zip(counters, before))
    cpu = solve(*args, rel_tolerance=1e-6, dtype=torch.float32, device="cpu")
    assert rel_err(cpu.u, card.u) < 1e-4
    assert abs(card.l2_error - cpu.l2_error) <= 1e-3 * cpu.l2_error
    assert abs(card.h1_seminorm_error - cpu.h1_seminorm_error) <= 1e-3 * cpu.h1_seminorm_error


@pytest.mark.cuda
def test_unstructured_vcycle_on_card_matches_cpu(cuda_device):
    """One banded V-cycle (coarse res 2, two levels, RCM hierarchy, f32) on the card against the CPU:
    the levels' gathers and scatters launch the kernels; rel 1e-4 (f32 roundoff through the cycle)."""
    from fenris_tpu_torch.multigrid import GeometricMGPreconditioner, rcm_refined_hierarchy

    coarse = box(2)
    out = {}
    for dev in ("cpu", cuda_device):
        fine, perm = rcm_refined_hierarchy(coarse, 2, device=dev)
        model = HyperelasticModel(mesh=fine, material=LinearElasticMaterial(), params=LameParameters(MU, LAM),
                                  dirichlet_nodes=np.flatnonzero(fine.points[:, 0] < 1e-12), dtype=torch.float32,
                                  device=dev, banded=True, banded_r_nodes=1024)
        mg = GeometricMGPreconditioner(model, coarse, 2, fine_permutation=perm, banded=True)
        r = torch.as_tensor(rng(16).standard_normal(model.space.num_dofs), dtype=torch.float32, device=dev)
        before = (tb.banded_gather.launches, tb.banded_scatter.launches)
        out[str(dev)] = (mg(r), perm)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert tb.banded_gather.launches > before[0] and tb.banded_scatter.launches > before[1]
    (cpu, perm_cpu), (card, perm_card) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_array_equal(perm_cpu, perm_card)
    assert rel_err(cpu, card) < 1e-4


@pytest.mark.cuda
def test_tet4_vcycle_on_card_matches_cpu(cuda_device):
    """One banded V-cycle over a tet4 hierarchy (BCC res 2, two refinements, RCM, f32) on the card against the
    CPU: the levels' gathers and scatters launch the kernels; rel 1e-4 (f32 roundoff through the cycle)."""
    from fenris_tpu_torch.multigrid import GeometricMGPreconditioner, rcm_refined_hierarchy

    coarse = tet_box(2)
    out = {}
    for dev in ("cpu", cuda_device):
        fine, perm = rcm_refined_hierarchy(coarse, 2, device=dev)
        model = HyperelasticModel(mesh=fine, material=LinearElasticMaterial(), params=LameParameters(MU, LAM),
                                  dirichlet_nodes=np.flatnonzero(fine.points[:, 0] < 1e-12), dtype=torch.float32,
                                  device=dev, banded=True, banded_r_nodes=1024)
        mg = GeometricMGPreconditioner(model, coarse, 2, fine_permutation=perm, banded=True)
        r = torch.as_tensor(rng(17).standard_normal(model.space.num_dofs), dtype=torch.float32, device=dev)
        before = (tb.banded_gather.launches, tb.banded_scatter.launches)
        out[str(dev)] = (mg(r), perm)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert tb.banded_gather.launches > before[0] and tb.banded_scatter.launches > before[1]
    (cpu, perm_cpu), (card, perm_card) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_array_equal(perm_cpu, perm_card)
    assert rel_err(cpu, card) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hex20", "tet10"])
def test_mass_and_surface_assemblers_on_card_match_cpu(name, cuda_device):
    """The mass matrices (per-element density, s = 3) of a distorted res-3 box and the traction vectors
    (a traction varying over the faces) of its boundary faces, in f64 on the card against the CPU (1e-12)."""
    from fenris_tpu_torch.assembly.local import assemble_element_mass_matrices, assemble_element_surface_source_vectors
    from fenris_tpu_torch.quadrature import canonical_mass

    base = (tet_box if name.startswith("tet") else box)(3)
    mesh = convert_mesh(base, name)
    el, fel = mesh.element, mesh.boundary_mesh().element
    g = rng(18)
    X = mesh.points[mesh.cells[:, : el.geometry.num_nodes]]
    X = X + 0.01 * g.standard_normal(X.shape)
    rho = g.uniform(1.0, 3.0, mesh.num_cells)
    faces = mesh.boundary_mesh().cells
    Xf = mesh.points[faces[:, : fel.geometry.num_nodes]]
    tab, ftab = tabulate(el, canonical_mass(name)), tabulate(fel, canonical_mass(fel.name))

    def traction(x, p):
        return torch.stack([x[0] * x[1], 1.0 + x[2], -x[0]])

    out = {}
    for dev in ("cpu", cuda_device):
        Xt = torch.as_tensor(X, device=dev)
        out[str(dev)] = (assemble_element_mass_matrices(Xt, torch.as_tensor(rho, device=dev), 3, tab),
                         assemble_element_surface_source_vectors(torch.as_tensor(Xf, device=dev), traction, None, 3,
                                                                 ftab))
    for cpu, card in zip(out["cpu"], out[str(cuda_device)]):
        assert card.is_cuda and rel_err(cpu, card) < 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["assembled", "matrix_free"])
@pytest.mark.parametrize("name", ["tet10", "hex20"])
def test_poisson_elements_on_card_match_cpu(name, route, cuda_device):
    """f32 Poisson on a res-3 tet10 or hex20 box (the gate's rules) on the card against the same route on
    the CPU: solutions within 1e-4 relative (CG at rel 1e-6 on both), errors within 1e-3, and the
    route's kernels launched (band sweep; or gather and scatter on n-node rows)."""
    from fenris_tpu_torch import fem
    from fenris_tpu_torch.quadrature import hexahedron_gauss, total_order

    solve = fem.solve_poisson_assembled if route == "assembled" else fem.solve_poisson_matrix_free
    counters = [tds.dia_sweep] if route == "assembled" else [tb.banded_gather, tb.banded_scatter]
    mesh = element_mesh(name, 3)
    rule, err = ((total_order.tetrahedron(2), total_order.tetrahedron(6)) if name == "tet10"
                 else (hexahedron_gauss(4), hexahedron_gauss(6)))
    src, ue, ug = _poisson_problem()
    nd = np.flatnonzero(np.abs(mesh.points - 0.5).max(axis=1) > 0.4999)
    kw = dict(min_fill=0.05) if route == "assembled" else {}
    args = (mesh, rule, err, src, ue, ug, nd)
    before = [k.launches for k in counters]
    card = solve(*args, rel_tolerance=1e-6, dtype=torch.float32, device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert all(k.launches > b for k, b in zip(counters, before))
    cpu = solve(*args, rel_tolerance=1e-6, dtype=torch.float32, device="cpu", **kw)
    assert rel_err(cpu.u, card.u) < 1e-4
    assert abs(card.l2_error - cpu.l2_error) <= 1e-3 * cpu.l2_error
    assert abs(card.h1_seminorm_error - cpu.h1_seminorm_error) <= 1e-3 * cpu.h1_seminorm_error


# -- the 2D slice: the stiffness kernel at d = 2, CSR assembly and the CSR product ----------------


def square_mesh(name, res):
    """The unit square of ``name`` cells: quad4 or tri3 (split quads), converted for the others."""
    from fenris_tpu_torch.mesh.procedural import create_unit_square_uniform_quad_mesh_2d as square
    from fenris_tpu_torch.mesh.procedural import create_unit_square_uniform_tri_mesh_2d as tri_square

    base = (tri_square if name.startswith("tri") else square)(res)
    return base if name in ("tri3", "quad4") else convert_mesh(base, name)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["linear", "laplace"])
@pytest.mark.parametrize("name", ["quad4", "quad8", "quad9", "tri3", "tri6"])
def test_stiffness_kernel_on_2d_elements_on_card(name, kind, cuda_device):
    """The kernel's d = 2 branch (2x2 Jacobian and inverse), 77 elements (a ragged last tile) of a
    perturbed square, Laplace (s = 1) and 2D linear elasticity (s = 2): against the plain version,
    bitwise repeats, the launch count and exact mirror blocks."""
    op, params = ((LaplaceOperator(), None) if kind == "laplace" else
                  (MaterialEllipticOperator(LinearElasticMaterial(), dim=2), LameParameters(MU, LAM)))
    mesh = square_mesh(name, 4)
    m, n = mesh.element.geometry.num_nodes, mesh.element.num_nodes
    pts = mesh.points + rng(17).uniform(-0.03, 0.03, mesh.points.shape)
    X = np.concatenate([pts[mesh.cells[:, :m]]] * -(-77 // mesh.num_cells))[:77]
    Xt = torch.as_tensor(X, dtype=torch.float32, device=cuda_device)
    tab = tabulate(element(name), canonical_stiffness(name))
    assert tsk.supports_stiffness_kernel(op, params, tab, Xt)
    before = tsk.stiffness_pairs.launches
    got = tsk.stiffness_pairs(Xt, op, params, tab)
    again = tsk.stiffness_pairs(Xt, op, params, tab)
    torch.cuda.synchronize()
    assert tsk.stiffness_pairs.launches == before + 2
    s = op.solution_dim
    assert got.shape == (s * s, n * n, 77)
    assert rel_err(tsk.stiffness_pairs_plain(Xt, op, params, tab), got) < KERNEL_RTOL
    assert torch.equal(got, again)
    blocks = got.reshape(s, s, n, n, 77)
    for i in range(s):
        for j in range(i + 1, s):
            assert torch.equal(blocks[j, i], blocks[i, j].transpose(0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 2])
def test_csr_assembly_and_product_on_card(s, cuda_device):
    """The CSR pattern built on the card equals the CPU's; ``assemble_csr`` and the CSR product are
    bitwise repeatable on the card and equal the CPU's f64 results to f32 roundoff (1e-5)."""
    from fenris_tpu_torch.assembly import global_ as G
    from fenris_tpu_torch.sparse.csr import from_pattern

    mesh = square_mesh("tri6", 6)
    card, cpu = (G.csr_pattern(mesh.cells, mesh.num_vertices, s, device=d) for d in (cuda_device, "cpu"))
    for field in ("row_ptr", "col_indices", "scatter_indices", "rows_of_nnz", "diag_positions"):
        assert torch.equal(getattr(card, field).cpu(), getattr(cpu, field)), field
    E, nd, _ = cpu.scatter_indices.shape
    el = rng(18).standard_normal((E, nd, nd))
    el32 = torch.as_tensor(el, dtype=torch.float32, device=cuda_device)
    values = G.assemble_csr(el32, card)
    assert torch.equal(values, G.assemble_csr(el32, card))
    ref = G.assemble_csr(torch.as_tensor(el), cpu)
    assert rel_err(ref, values) < KERNEL_RTOL
    x = rng(19).standard_normal(cpu.num_cols)
    A = from_pattern(card, values)
    x32 = torch.as_tensor(x, dtype=torch.float32, device=cuda_device)
    y = A @ x32
    for _ in range(5):
        assert torch.equal(y, A @ x32)
    assert rel_err(from_pattern(cpu, ref) @ torch.as_tensor(x), y) < KERNEL_RTOL
    assert rel_err(from_pattern(cpu, ref).diagonal(), A.diagonal()) < KERNEL_RTOL


@pytest.mark.cuda
def test_solve_poisson_on_card_matches_cpu(cuda_device):
    """The CSR route, f32 on a res-8 tri6 square on the card against the CPU: solutions within 1e-4
    relative (CG at rel 1e-6 on both), errors within 1e-3."""
    from fenris_tpu_torch import fem
    from fenris_tpu_torch.quadrature import total_order

    mesh = square_mesh("tri6", 8)

    def u_exact(x):
        return torch.sin(np.pi * x[0]) * torch.sin(np.pi * x[1])

    def u_exact_grad(x):
        return np.pi * torch.stack([torch.cos(np.pi * x[0]) * torch.sin(np.pi * x[1]),
                                    torch.sin(np.pi * x[0]) * torch.cos(np.pi * x[1])])

    nd = np.flatnonzero(np.abs(mesh.points - 0.5).max(axis=1) > 0.4999)
    args = (mesh, total_order.triangle(2), total_order.triangle(6), lambda x, p: 2.0 * np.pi**2 * u_exact(x), u_exact,
            u_exact_grad, nd)
    card = fem.solve_poisson(*args, rel_tolerance=1e-6, dtype=torch.float32, device=cuda_device)
    cpu = fem.solve_poisson(*args, rel_tolerance=1e-6, dtype=torch.float32, device="cpu")
    assert card.u.device.type == "cuda"
    assert rel_err(cpu.u, card.u) < 1e-4
    assert abs(card.l2_error - cpu.l2_error) <= 1e-3 * cpu.l2_error
    assert abs(card.h1_seminorm_error - cpu.h1_seminorm_error) <= 1e-3 * cpu.h1_seminorm_error


# -- location, interpolation and aggregate assembly (plain PyTorch on the card) ---------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tet10", "quad9"])
def test_find_closest_element_on_card_matches_cpu(name, cuda_device):
    """``find_closest_element`` (grid and brute force, chunked) and ``FixedInterpolator`` in f64 on the card
    against the same calls on the CPU: element ids equal, distances, coordinates and values within 1e-12."""
    from fenris_tpu_torch import space as S

    mesh = convert_mesh(tet_box(2), name) if name == "tet10" else square_mesh(name, 4)
    g = rng(20)
    pts = np.concatenate([g.uniform(0.02, 0.98, size=(80, mesh.dim)), g.uniform(-0.4, 1.4, size=(40, mesh.dim))])
    u = g.standard_normal(mesh.num_vertices)
    idx = S.GridIndex.build(mesh)
    cpu_grid = S.find_closest_element(mesh, pts, device="cpu", index=idx)
    for kw, cpu in ((dict(index=idx), cpu_grid), (dict(index=idx, chunk_size=37), cpu_grid),
                    (dict(), S.find_closest_element(mesh, pts, device="cpu"))):
        card = S.find_closest_element(mesh, pts, device=cuda_device, **kw)
        assert card.element_indices.device.type == "cuda"
        assert torch.equal(card.element_indices.cpu(), cpu.element_indices)
        assert (card.domain_distance.cpu() - cpu.domain_distance).abs().max() <= 1e-12
        assert (card.reference_coords.cpu() - cpu.reference_coords).abs().max() <= 1e-12
    fixed = [S.FixedInterpolator.from_space_and_points(mesh, pts, with_gradients=True, index=idx, device=d)
             for d in (cuda_device, "cpu")]
    uc = torch.as_tensor(u, device=cuda_device)
    assert rel_err(fixed[1].interpolate(torch.as_tensor(u)), fixed[0].interpolate(uc)) < 1e-12
    assert rel_err(fixed[1].interpolate_gradient(torch.as_tensor(u)), fixed[0].interpolate_gradient(uc)) < 1e-12


@pytest.mark.cuda
def test_aggregate_assembly_on_card_matches_cpu(cuda_device):
    """The mixed quad/tri pattern built on the card equals the CPU's array for array; the aggregate values
    (f64 and f32) are bitwise repeatable and equal the CPU's f64 values (f64: 1e-12, f32: 1e-5)."""
    from fenris_tpu_torch.assembly import aggregate as A
    from fenris_tpu_torch.mesh.procedural import create_rectangular_uniform_quad_mesh_2d

    quads = create_rectangular_uniform_quad_mesh_2d(0.5, 1, 2, 6, (0.0, 1.0))
    tris = create_rectangular_uniform_quad_mesh_2d(0.5, 1, 2, 6, (0.5, 1.0)).split_into_triangles()
    pts = np.concatenate([quads.points, tris.points])
    uniq, inverse = np.unique(np.round(pts, 12), axis=0, return_inverse=True)
    blocks = [inverse[quads.cells.astype(np.int64)], inverse[tris.cells.astype(np.int64) + quads.num_vertices]]
    card, cpu = (A.aggregate_csr_pattern(blocks, len(uniq), 2, device=d) for d in (cuda_device, "cpu"))
    for field in ("row_ptr", "col_indices", "rows_of_nnz", "diag_positions", "scatter_indices"):
        assert torch.equal(getattr(card.pattern, field).cpu(), getattr(cpu.pattern, field)), field
    for a, b in zip(card.block_scatter, cpu.block_scatter):
        assert torch.equal(a.cpu(), b)
    g = rng(21)
    mats = [g.standard_normal((len(c), 2 * c.shape[1], 2 * c.shape[1])) for c in blocks]
    ref = A.assemble_aggregate_csr([torch.as_tensor(m) for m in mats], cpu)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, KERNEL_RTOL)):
        m_card = [torch.as_tensor(m, dtype=dtype, device=cuda_device) for m in mats]
        values = A.assemble_aggregate_csr(m_card, card)
        assert torch.equal(values, A.assemble_aggregate_csr(m_card, card))
        assert rel_err(ref, values) < tol


@pytest.mark.cuda
def test_block_dia_from_csr_on_card_feeds_band_sweep(cuda_device):
    """``block_dia_from_csr`` on the card's CSR of a tri6 square (s = 1): bands equal to the CPU's, and the
    band sweep kernel on them against the CSR product (f32, 1e-5)."""
    from fenris_tpu_torch.assembly import global_ as G
    from fenris_tpu_torch.sparse.block_dia import block_dia_from_csr
    from fenris_tpu_torch.sparse.csr import from_pattern

    mesh = square_mesh("tri6", 8)
    card, cpu = (G.csr_pattern(mesh.cells, mesh.num_vertices, 1, device=d) for d in (cuda_device, "cpu"))
    E, nd, _ = cpu.scatter_indices.shape
    el = rng(22).standard_normal((E, nd, nd))
    values = G.assemble_csr(torch.as_tensor(el, dtype=torch.float32, device=cuda_device), card)
    m = block_dia_from_csr(card, values)
    m_cpu = block_dia_from_csr(cpu, values.cpu())
    assert m.offsets == m_cpu.offsets and torch.equal(m.bands.cpu(), m_cpu.bands) and m.remainder is None
    x = torch.as_tensor(rng(23).standard_normal((1, cpu.num_rows)), dtype=torch.float32, device=cuda_device)
    before = tds.dia_sweep.launches
    y = tds.dia_sweep(m.bands, m.offsets, x)
    assert tds.dia_sweep.launches == before + 1
    assert rel_err(from_pattern(card, values) @ x[0], y[0]) < KERNEL_RTOL


# -- utils helpers and ShardedElasticity on the card ----------------------------------------


def _polar_batch(n=256, seed=31):
    """Deformation gradients F = R S (S symmetric positive definite near I), every other one reflected."""
    g = rng(seed)
    A = g.standard_normal((n, 3, 3))
    Q, _ = np.linalg.qr(g.standard_normal((n, 3, 3)))
    F = Q @ (np.eye(3) + 0.1 * (A + np.swapaxes(A, 1, 2)))
    F[::2] = F[::2] @ np.diag([1.0, 1.0, -1.0])
    return F


@pytest.mark.cuda
def test_utils_helpers_on_card_match_cpu(cuda_device):
    """rotation_svd, polar_decomposition, apd and the eigenvalue helpers in f64 on the card against the CPU:
    singular values, R, S and eigenvalues to 1e-12, U and V up to one sign per column, apd (on the F with
    det F > 0) to 1e-6; the eigenvalues also past one batch of the card's eigenvalue call."""
    import fenris_tpu_torch.utils as tu

    F = _polar_batch()
    Fc, Fg = torch.as_tensor(F), torch.as_tensor(F, device=cuda_device)
    (Uc, sc, Vc), (Ug, sg, Vg) = tu.rotation_svd(Fc), tu.rotation_svd(Fg)
    assert sg.device.type == "cuda"
    assert rel_err(sc, sg) < 1e-12
    sign = torch.sign(torch.einsum("bij,bij->bj", Ug.cpu(), Uc))
    assert rel_err(Uc * sign[:, None, :], Ug) < 1e-12 and rel_err(Vc * sign[:, None, :], Vg) < 1e-12
    for c, g in zip(tu.polar_decomposition(Fc), tu.polar_decomposition(Fg)):
        assert rel_err(c, g) < 1e-12
    # apd's fixed point is a rotation (the reflected F have none); its 30 steps leave the slowest of these
    # random rotations short of it, where the two devices' roundoff grows (8.6e-9 on an H100 80GB HBM3 at 700 W)
    proper = slice(1, None, 2)
    assert rel_err(tu.apd(Fc[proper]), tu.apd(Fg[proper])) < 1e-6
    S = Fc.transpose(1, 2) @ Fc
    assert rel_err(tu.sym_eigenvalues(S), tu.sym_eigenvalues(S.to(cuda_device))) < 1e-12
    for c, g in zip(tu.extremal_eigenvalues(S), tu.extremal_eigenvalues(S.to(cuda_device))):
        assert rel_err(c, g) < 1e-12
    assert rel_err(tu.condition_number_sym(S), tu.condition_number_sym(S.to(cuda_device))) < 1e-12
    big = S.repeat(tu._EIG_BATCH // S.shape[0] + 1, 1, 1)  # more than one batch on the card
    assert rel_err(tu.sym_eigenvalues(big), tu.sym_eigenvalues(big.to(cuda_device))) < 1e-12


@pytest.fixture
def gloo_world_of_one(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.cuda
def test_sharded_elasticity_on_card_matches_cpu(cuda_device, gloo_world_of_one):
    """ShardedElasticity at world size 1 (gloo) on cuda:0 in f64 against the same call on the CPU."""
    from fenris_tpu_torch.parallel import ShardedElasticity, make_device_mesh

    mesh = box(3)
    fixed = np.flatnonzero(mesh.points[:, 2] < 1e-12)
    mu = np.where(np.arange(mesh.num_cells) % 2 == 0, 300.0, MU)
    out = {}
    for kind in ("cpu", "cuda"):
        model = HyperelasticModel(mesh=mesh, material=NeoHookeanMaterial(), params=LameParameters(mu, LAM),
                                  dirichlet_nodes=fixed, body_force=np.array([0.0, 0.0, -5.0]),
                                  dtype=torch.float64, device=kind)
        sharded = ShardedElasticity(model, make_device_mesh(device_type=kind))
        g = rng(32)
        u = torch.as_tensor(g.uniform(-0.01, 0.01, model.space.num_dofs), device=kind) * model.free_mask
        v = torch.as_tensor(g.standard_normal(model.space.num_dofs), device=kind)
        out[kind] = [sharded.residual(u), sharded.hessian_vector_product(u, v), sharded.hessian_diagonal(u),
                     sharded.energy(u).reshape(1)]
    assert out["cuda"][0].device.type == "cuda"
    for c, g in zip(out["cpu"], out["cuda"]):
        assert rel_err(c, g) < 1e-12
