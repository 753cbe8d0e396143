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
from fenris_tpu_torch.assembly.local import tabulate
from fenris_tpu_torch.elasticity import HyperelasticModel
from fenris_tpu_torch.mesh import Mesh
from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d as box
from fenris_tpu_torch.mesh.reorder import reorder_mesh
from fenris_tpu_torch.operators import LaplaceOperator
from fenris_tpu_torch.quadrature import canonical_stiffness
from fenris_tpu_torch.reference_elements import HEX8
from fenris_tpu_torch.solid import LameParameters, LinearElasticMaterial, MaterialEllipticOperator
from fenris_tpu_torch.solid import NeoHookeanMaterial, StVKMaterial

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


# -- banded gather and scatter (csrc/banded.cu) --------------------------------------------

# (mesh, res, s, r_nodes, rowt): a box, an RCM-reordered box with one component,
# and a box with several owner blocks (ragged counts)
BANDED_CASES = {
    "box5_s3": ("box", 5, 3, 1024, 256),
    "rcm6_s1": ("rcm", 6, 1, 1024, 256),
    "box12_s3_blocks": ("box", 12, 3, 1024, 256),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BANDED_CASES))
def test_banded_kernels_match_plain_on_card(name, cuda_device):
    kind, res, s, r_nodes, rowt = BANDED_CASES[name]
    mesh = box(res) if kind == "box" else reorder_mesh(box(res))[0]
    N = int(mesh.cells.max()) + 1
    tp = tb.make_banded_plan(mesh.cells, N, s=s, r_nodes=r_nodes, rowt=rowt, device=cuda_device)
    u = torch.as_tensor(rng(12).standard_normal((N, s)), dtype=torch.float32, device=cuda_device)
    got = tb.banded_gather(tp, u)
    torch.cuda.synchronize()
    assert torch.equal(got, tb.banded_gather_plain(tp, u))
    f = torch.as_tensor(rng(13).standard_normal((tp.padded_elements, tp.n, s)), dtype=torch.float32,
                        device=cuda_device)
    got = tb.banded_scatter(tp, f)
    again = tb.banded_scatter(tp, f)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, tb.banded_scatter_plain(tp, f))


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


# -- models ---------------------------------------------------------------------------------


def _box_model(res, dtype, device, **kw):
    """tools/solve_assembled.py's model: unit box, z = 0 clamped, body force (0, 0, -4)."""
    mesh = box(res)
    return HyperelasticModel(mesh=mesh, material=kw.pop("material", NeoHookeanMaterial()),
                             params=LameParameters(MU, LAM), dirichlet_nodes=np.flatnonzero(mesh.points[:, 2] < 1e-12),
                             body_force=np.array([0.0, 0.0, -4.0]), dtype=dtype, device=device, **kw)


@pytest.mark.cuda
def test_fused_model_refuses_what_the_kernels_do_not_take(cuda_device):
    """A CUDA fused model the element-sweep kernels cannot run raises; it does not fall back."""
    kw = dict(banded=True, fused_kernels=True)
    with pytest.raises(NotImplementedError, match="fused_kernels"):
        _box_model(2, torch.float32, cuda_device, material=StVKMaterial(), **kw)
    with pytest.raises(NotImplementedError, match="fused_kernels"):
        _box_model(2, torch.float64, cuda_device, **kw)


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
