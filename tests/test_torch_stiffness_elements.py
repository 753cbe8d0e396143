"""Port parity: the element-stiffness kernel's plain version and arithmetic on the 3D elements.

The plain version (``stiffness_pairs_plain``) against the JAX package's
XLA pairs path (``assemble_element_elliptic_matrices_pairs(...,
pallas=False)``, which the JAX tests hold equal to the Pallas kernel) on
hex20 and tet10, f64; a float64 emulation of ``csrc/stiffness_pairs.cu``'s
node-pair rounds and point chunks (hex20 and hex27 take their points in
chunks) against them; and the kernel's gate and chunk plan for every 3D
element.  The CUDA kernel itself runs only on a card
(``tests/test_torch_cuda.py``).
"""

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
from fenris_tpu_torch.quadrature import canonical_stiffness
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
    """The kernel's task decode: task t -> node pair (a, b), a <= b, row-major."""
    a, r = 0, t
    while r >= n - a:
        r -= n - a
        a += 1
    return a, a + r


def kernel_emulation(X, op, params, tab):
    """float64 emulation of csrc/stiffness_pairs.cu: rounds of 9 K node pairs (K = 1 when the
    gradient table fits a block, else ``_CHUNK_TASKS``), each summing ``w|det| G_q[a] G_q[b]ᵀ`` over
    the points chunk by chunk (``_chunk_points``), then ``C^p : M`` and ``C^p : Mᵀ`` and the mirror
    blocks.  Every output entry is written; NaN marks one that is not."""
    tables, C, meta = tsk._constants(op, params, tab)
    m, n, q, d, s, sym = (meta[k] for k in ("m", "n", "q", "d", "s", "sym"))
    gd = tables[: q * m * d].reshape(q, m, d)
    dphi = tables[q * m * d : q * (m + n) * d].reshape(q, n, d)
    w = tables[q * (m + n) * d :]
    J = np.einsum("qml,emk->eqkl", gd, X)
    G = np.einsum("qbl,eqlk->eqbk", dphi, np.linalg.inv(J))
    wdet = w * np.abs(np.linalg.det(J))  # [E, q]
    qc = tsk._chunk_points(m, n, q, d)
    K = 1 if qc == q else tsk._CHUNK_TASKS
    tasks = n * (n + 1) // 2
    pairs = [(i, j) for i in range(s) for j in range(s) if not sym or i <= j]
    rows = {p: i * s + j for p, (i, j) in enumerate(pairs)}
    mirrors = {p: j * s + i for p, (i, j) in enumerate(pairs) if sym and i != j}
    out = np.full((s * s, n, n, X.shape[0]), np.nan)
    seen = []
    for base in range(0, tasks, tsk._WARPS * K):
        for t in range(base, min(base + tsk._WARPS * K, tasks)):
            a, b = pair_of_task(t, n)
            seen.append((a, b))
            M = np.zeros((X.shape[0], d, d))
            for q0 in range(0, q, qc):
                for qq in range(q0, min(q0 + qc, q)):
                    M += (wdet[:, qq, None, None] * G[:, qq, a, :, None]) * G[:, qq, b, None, :]
            for p, Cp in enumerate(C):
                ab, ba = np.einsum("kl,ekl->e", Cp, M), np.einsum("kl,elk->e", Cp, M)
                out[rows[p], a, b], out[rows[p], b, a] = ab, ba
                if p in mirrors:
                    out[mirrors[p], b, a], out[mirrors[p], a, b] = ab, ba
    assert sorted(seen) == [(a, b) for a in range(n) for b in range(a, n)]  # each pair once
    return out.reshape(s * s, n * n, -1)


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


@pytest.mark.parametrize("name", ["tet4", "tet20", "hex27"])
def test_kernel_emulation_matches_plain(name):
    """The other elements: the emulation against the plain version (held to JAX above), s = 3."""
    X = element_coordinates(name, seed=1)
    _, (op, params) = operator("linear")
    tab = tabulate(element(name), canonical_stiffness(name))
    ref = tsk.stiffness_pairs_plain(torch.as_tensor(X), op, params, tab)
    assert rel_err(ref, kernel_emulation(X, op, params, tab)) <= 1e-12


def test_stiffness_kernel_takes_every_3d_element():
    """The gate at s = 1 and s = 3 and the chunk plan: one chunk where the table fits 232,448 bytes,
    else balanced chunks of at most 115,712 bytes (two blocks an SM)."""
    expect = {"tet4": 1, "tet10": 4, "tet20": 14, "hex8": 8, "hex20": 9, "hex27": 7}
    for name in ELEMENTS_3D:
        tab = tabulate(element(name), canonical_stiffness(name))
        q, m, d = tab.geo_dphi.shape
        n = tab.dphi.shape[1]
        for _, (op, params) in (operator("linear"), operator("laplace")):
            assert tsk._fits(op, tab), name
        qc = tsk._chunk_points(m, n, q, d)
        assert qc == expect[name], (name, qc)
        limit = tsk._MAX_SMEM if qc == q else tsk._CHUNK_SMEM
        assert 0 < tsk._smem_bytes(m, n, q, d) <= limit
        if qc < q:  # the fewest chunks, balanced
            chunks = -(-q // qc)
            assert 4 * tsk._smem_floats(m, n, q, -(-q // (chunks - 1)), d) > tsk._CHUNK_SMEM
    assert tsk._chunk_points(8, 200, 27, 3) == 0  # not even one point's gradients fit
