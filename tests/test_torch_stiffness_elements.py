"""Port parity: the element-stiffness kernel's plain version and arithmetic on the 3D elements.

The plain version (``stiffness_pairs_plain``) against the JAX package's
XLA pairs path (``assemble_element_elliptic_matrices_pairs(...,
pallas=False)``, which the JAX tests hold equal to the Pallas kernel) on
hex20 and tet10, f64; a float64 emulation of ``csrc/stiffness_pairs.cu``
(its tiles of node pairs, lane groups and butterfly, the scalar form of
Laplace) against them, also at rules taken in chunks and with a negative weight; the kernel's gate and
launch table for every 3D element, and that table read from the source
against its Python mirror.  The CUDA kernel itself runs only on a card
(``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import LAM, MU, rel_err, rng

import fenris_tpu.assembly.local as jlocal
import fenris_tpu.quadrature as JQ
import fenris_tpu_torch.ops.stiffness_pairs as tsk
from fenris_tpu.operators import LaplaceOperator as JaxLaplace
from fenris_tpu.reference_elements import element as jax_element
from fenris_tpu.solid import LameParameters as JaxLame
from fenris_tpu.solid import LinearElasticMaterial as JaxLinear
from fenris_tpu.solid import MaterialEllipticOperator as JaxMaterialOp
from fenris_tpu_torch.assembly.local import tabulate
from fenris_tpu_torch.mesh import procedural as TP
from fenris_tpu_torch.mesh.convert import convert_mesh
from fenris_tpu_torch.operators import LaplaceOperator
from fenris_tpu_torch.quadrature import Rule, canonical_stiffness, total_order
from fenris_tpu_torch.reference_elements import element
from fenris_tpu_torch.solid import LameParameters, LinearElasticMaterial, MaterialEllipticOperator

ELEMENTS_3D = ["tet4", "tet10", "tet20", "hex8", "hex20", "hex27"]


def operator(kind):
    if kind == "laplace":
        return (JaxLaplace(), None), (LaplaceOperator(), None)
    return ((JaxMaterialOp(JaxLinear(), dim=3), JaxLame(MU, LAM)),
            (MaterialEllipticOperator(LinearElasticMaterial(), dim=3), LameParameters(MU, LAM)))


def element_coordinates(name, seed=0):
    """Geometry coordinates ``[E, m, 3]`` of a res-2 box of the element, every node moved by up to
    15% of a cell (non-affine hexes)."""
    base = TP.create_unit_box_uniform_tet_mesh_3d(2) if name.startswith("tet") else \
        TP.create_unit_box_uniform_hex_mesh_3d(2)
    mesh = base if name in ("tet4", "hex8") else convert_mesh(base, name)
    pts = mesh.points + rng(seed).uniform(-0.075, 0.075, mesh.points.shape)
    return pts[mesh.cells[:, : element(name).geometry.num_nodes]]


def pair_of_task(t, n):
    """The kernel's task decode: task t -> pair (a, b), a <= b, row-major (node pairs, or tiles of them)."""
    a, r = 0, t
    while r >= n - a:
        r -= n - a
        a += 1
    return a, a + r


def kernel_emulation(X, op, params, tab):
    """float64 emulation of csrc/stiffness_pairs.cu.  The tiled body: ``H_q[a] = sqrt(|w_q det J_q|)
    dphi_q[a] J_q^-1 L`` (``L`` the Cholesky factor of a single s.p.d. contraction pair, else the identity),
    the points in the wrapper's order (negative weights last) and in chunks (``_chunk_points``); per chunk and
    upper T x T tile of node pairs (``_TILING``) each lane group's sum over its points (every
    ``32 / elements``-th; a point of negative weight subtracts its products), the groups' sums added in the
    butterfly's order, then the scalar ``H_a . H_b`` or ``C^p : M`` and ``C^p : Mᵀ`` added to what the
    earlier chunks stored, with the mirror blocks (an isotropic contraction's zero terms, which the kernel
    skips, add exact zeros).  Every output entry is written once a chunk.  The reference-sums form (a scalar
    row's tile side 0): ``K = |det J| (J^-1 L)(J^-1 L)ᵀ`` at the first point against the tables' sums."""
    tables, C, meta = tsk._constants(op, params, tab)
    m, n, q, d, s, sym = (meta[k] for k in ("m", "n", "q", "d", "s", "sym"))
    gd = tables[: q * m * d].reshape(q, m, d)
    dphi = tables[q * m * d : q * (m + n) * d].reshape(q, n, d)
    w = tables[q * (m + n) * d : q * (m + n) * d + q]
    J = np.einsum("qml,emk->eqkl", gd, X)
    Jinv, wdet = np.linalg.inv(J), w * np.abs(np.linalg.det(J))  # [E, q, d, d], [E, q]
    scalar = tsk._scalar_form(C)
    elems, _, T, _ = tsk._TILING[tsk._ELEMENT_OF_SHAPE[d, m, n]][2 if scalar else 1]
    qc = tsk._chunk_points(m, n, q, d, scalar)
    pairs = [(i, j) for i in range(s) for j in range(s) if not sym or i <= j]
    out = np.zeros((s * s, n * n, X.shape[0]))
    count = np.zeros((s * s, n * n), int)

    def put(a, b, M):
        """Entries (a, b) and (b, a) of every block from pair (a, b)'s sums ([E] scalar or [E, d, d])."""
        for p, (i, j) in enumerate(pairs):
            ab, ba = (M, M) if scalar else (np.einsum("kl,ekl->e", C[p], M), np.einsum("kl,elk->e", C[p], M))
            ab, ba = out[i * s + j, a * n + b] + ab, out[i * s + j, b * n + a] + ba
            rows = [(i * s + j, a, b, ab)] + ([(i * s + j, b, a, ba)] if a != b else [])
            if sym and i != j:  # the mirror block: the node transpose
                rows += [(j * s + i, b, a, ab)] + ([(j * s + i, a, b, ba)] if a != b else [])
            for r, x, y, v in rows:
                out[r, x * n + y] = v
                count[r, x * n + y] += 1

    L = tsk._cholesky(C[0]) if scalar else np.eye(d)
    if T == 0:  # the reference-sums form: [pairs, d (d + 1) / 2] after the weights
        sums = tables[q * (m + n) * d + q :].reshape(n * (n + 1) // 2, -1)
        JL = Jinv[:, 0] @ L
        K = np.abs(np.linalg.det(J[:, 0]))[:, None, None] * np.einsum("elc,ekc->elk", JL, JL)
        l, k = np.triu_indices(d)
        for p, (a, b) in enumerate(zip(*np.triu_indices(n))):
            put(a, b, K[:, l, k] @ sums[p])
        assert (count == 1).all()
        return out
    H = np.sqrt(np.abs(wdet))[..., None, None] * np.einsum("qbl,eqlk->eqbk", dphi, Jinv @ L)
    split, groups = 32 // elems, -(-n // T)
    for q0 in range(0, q, qc):
        for t in range(groups * (groups + 1) // 2):
            ga, gb = pair_of_task(t, groups)
            ra, rb = ([min(g * T + i, n - 1) for i in range(T)] for g in (ga, gb))
            sums = []
            for h in range(split):
                acc = 0.0
                for qq in range(q0 + h, min(q0 + qc, q), split):
                    ha, hb = np.sign(w[qq]) * H[:, qq, ra], H[:, qq, rb]  # [E, T, d]
                    acc = acc + (np.einsum("eic,ejc->eij", ha, hb) if scalar else np.einsum("eic,ejl->eijcl", ha, hb))
                sums.append(acc)
            o = split // 2
            while o:  # the butterfly: lane group h adds group h ^ o's sums
                sums = [sums[h] + sums[h ^ o] for h in range(split)]
                o //= 2
            for i in range(T):
                for j in range(i if ga == gb else 0, T):
                    a, b = ga * T + i, gb * T + j
                    if a < n and b < n:
                        put(a, b, sums[0][:, i, j])
    assert (count == -(-q // qc)).all()  # every entry once a chunk
    return out


@pytest.mark.parametrize("kind", ["linear", "laplace"])
@pytest.mark.parametrize("name", ["hex20", "tet10"])
def test_stiffness_plain_and_kernel_emulation_match_jax_pairs(name, kind):
    """The bench's elements (bench.py:137-270), s = 3 and s = 1, f64."""
    X = element_coordinates(name)
    (jop, jp), (op, params) = operator(kind)
    jtab = jlocal.tabulate(jax_element(name), JQ.canonical_stiffness(name))
    tab = tabulate(element(name), canonical_stiffness(name))
    ref = np.asarray(jlocal.assemble_element_elliptic_matrices_pairs(jnp.asarray(X), None, jop, jp, jtab,
                                                                     pallas=False))
    got = tsk.stiffness_pairs_plain(torch.as_tensor(X), op, params, tab)
    assert rel_err(ref, got) <= 1e-12
    assert rel_err(ref, kernel_emulation(X, op, params, tab)) <= 1e-12


@pytest.mark.parametrize("kind", ["linear", "laplace"])
@pytest.mark.parametrize("name", ["tet4", "tet20", "hex8", "hex27"])
def test_kernel_emulation_matches_plain(name, kind):
    """The other elements: the emulation against the plain version (held to JAX above), s = 3 and s = 1."""
    X = element_coordinates(name, seed=1)
    _, (op, params) = operator(kind)
    tab = tabulate(element(name), canonical_stiffness(name))
    ref = tsk.stiffness_pairs_plain(torch.as_tensor(X), op, params, tab)
    assert rel_err(ref, kernel_emulation(X, op, params, tab)) <= 1e-12


def keast_rule(name):
    """A rule with a negative weight: Keast's 5-point tetrahedron rule (degree 3), on the tets as it is and
    on hex8 mapped to [-1, 1]^3 with a sixth point of weight 0."""
    a, b = 0.5, 1 / 6
    pts = np.array([[0.25] * 3, [b, b, b], [a, b, b], [b, a, b], [b, b, a]])
    w = np.array([-2 / 15, 3 / 40, 3 / 40, 3 / 40, 3 / 40])
    if name == "hex8":
        pts, w = np.concatenate([2 * pts - 1, [[0.1, 0.2, 0.3]]]), np.concatenate([8 * w, [0.0]])
    return Rule(w, pts)


@pytest.mark.parametrize("kind", ["linear", "laplace"])
@pytest.mark.parametrize("name, rule", [("hex20", "total order 6"), ("tet20", "total order 10"), ("tet10", "keast"),
                                        ("tet20", "keast"), ("hex8", "keast")])
def test_kernel_emulation_at_chunked_and_negative_weight_rules(name, rule, kind):
    """Rules past one block's table (hex20's 34 points and tet20's 81 in two and three chunks of the matrix
    form; tet20's Laplace takes its reference sums) and with a negative weight (moved last by the wrapper,
    subtracted; in tet20's reference sums as it is): the emulation against the plain version."""
    X = element_coordinates(name, seed=3)
    _, (op, params) = operator(kind)
    ref_el = element(name)
    r = keast_rule(name) if rule == "keast" else total_order.for_domain(ref_el.geometry.domain, int(rule.split()[-1]))
    tab = tabulate(ref_el, r)
    q, m, d = tab.geo_dphi.shape
    if rule == "keast":
        w = tsk._constants(op, params, tab)[0][q * (m + tab.dphi.shape[1]) * d :][:q]
        assert (w[:-1] >= 0).all() and w[-1] < 0  # the negative weight last
    elif kind == "linear":
        assert tsk._chunk_points(m, tab.dphi.shape[1], q, d) < q
    ref = tsk.stiffness_pairs_plain(torch.as_tensor(X), op, params, tab)
    assert rel_err(ref, kernel_emulation(X, op, params, tab)) <= 1e-12


class Anisotropic(LaplaceOperator):
    """s = 1 with a constant contraction that is symmetric but not positive definite (or not symmetric):
    the kernel's matrix form at one contraction pair."""

    def __init__(self, symmetric):
        self.symmetric = symmetric
        C = np.array([[1.0, 0.3, -0.2], [0.1, -0.5, 0.4], [0.2, 0.0, 2.0]])
        self.C = 0.5 * (C + C.T) if symmetric else C

    def contraction(self, G, params):
        D = torch.as_tensor(self.C, dtype=G.dtype)[:, None, :, None]
        return D.expand(tuple(G.shape[:-2]) + tuple(D.shape))


@pytest.mark.parametrize("symmetric", [True, False])
def test_kernel_emulation_matrix_form_at_one_pair(symmetric):
    """An s = 1 contraction without a Cholesky factor takes the matrix form (tet10): against the plain
    version."""
    op = Anisotropic(symmetric)
    tab = tabulate(element("tet10"), canonical_stiffness("tet10"))
    assert not tsk._scalar_form(tsk._constants(op, None, tab)[1])
    assert tsk._scalar_form(tsk._constants(LaplaceOperator(), None, tab)[1])
    X = element_coordinates("tet10", seed=2)
    ref = tsk.stiffness_pairs_plain(torch.as_tensor(X), op, None, tab)
    assert rel_err(ref, kernel_emulation(X, op, None, tab)) <= 1e-12


def test_stiffness_kernel_takes_every_3d_element():
    """The gate at s = 1 and s = 3 and each element's launch (``launch_layout``): its table within a
    block's shared memory at the canonical rule, as many blocks an SM as the launch bound asks for, at most
    1,024 threads, tiles that cover every node, lane groups of 8, 16 or 32 elements; linear elasticity takes
    the isotropic terms of the matrix form, Laplace the scalar form (tet20 its reference sums, one node pair
    a task)."""
    for name in ELEMENTS_3D:
        tab = tabulate(element(name), canonical_stiffness(name))
        n = tab.dphi.shape[1]
        for kind in ("linear", "laplace"):
            op, params = operator(kind)[1]
            assert tsk._fits(op, tab), name
            lay = tsk.launch_layout(op, params, tab)
            sums = kind == "laplace" and name == "tet20"
            assert lay["form"] == ("sums" if sums else "scalar" if kind == "laplace" else "isotropic")
            assert 0 < lay["shared_bytes"] <= tsk._MAX_SMEM and lay["blocks_per_sm"] >= lay["launch_bound"], lay
            assert lay["threads"] <= 1024 and lay["elements"] in (8, 16, 32), lay
            groups = n if sums else -(-n // lay["tile"])
            assert groups * max(lay["tile"], 1) >= n and lay["tiles"] == groups * (groups + 1) // 2
    # 200 points of hex27 do not fit one block: five balanced chunks of 40 (matrix form) or three of 67
    assert tsk._smem_bytes(8, 27, 200, 3) > tsk._MAX_SMEM
    assert tsk._chunk_points(8, 27, 200, 3) == 40 and tsk._chunk_points(8, 27, 200, 3, True) == 67
    assert tsk._smem_bytes(8, 27, 40, 3) <= tsk._MAX_SMEM < tsk._smem_bytes(8, 27, 45, 3)


def _tiling_rows():
    """``kTiling`` of ``csrc/stiffness_pairs.cu``: element name -> (matrix form row, scalar form row)."""
    src = (Path(tsk.__file__).resolve().parent.parent / "csrc" / "stiffness_pairs.cu").read_text()
    table = re.search(r"constexpr int kTiling\[11\]\[2\]\[4\] = \{(.*?)\n\};", src, re.S).group(1)
    rows = re.findall(r"\{\{(\d+), (\d+), (\d+), (\d+)\}, \{(\d+), (\d+), (\d+), (\d+)\}\},\s*// (\w+)", table)
    shapes = re.search(r"constexpr int kShape\[11\]\[3\] = \{(.*?)\n\};", src, re.S).group(1)
    shapes = [tuple(int(x) for x in t) for t in re.findall(r"\{(\d), (\d), (\d+)\}", shapes)]
    return {name: (shape, tuple(int(x) for x in row[:4]), tuple(int(x) for x in row[4:]))
            for shape, (*row, name) in zip(shapes, rows)}


@pytest.mark.parametrize("name", ["tet4", "tet10", "tet20", "hex8", "hex20", "hex27", "quad4", "quad8", "quad9",
                                  "tri3", "tri6"])
def test_stiffness_tiling_matches_source(name):
    """The wrapper's launch table (``_TILING``: shapes, elements and warps a block, tile, launch bound) is the
    source's ``kTiling`` and ``kShape``, row for row, and each shape is the element's (d, m, n)."""
    rows = _tiling_rows()
    assert list(rows) == list(tsk._TILING)
    assert rows[name] == tsk._TILING[name]
    ref = element(name)
    assert rows[name][0] == (ref.ref_dim, ref.geometry.num_nodes, ref.num_nodes)
