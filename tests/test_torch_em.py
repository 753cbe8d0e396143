"""Port parity: the element-minor sweeps (local_em) and the em_sweep wrappers.

The JAX ``fenris_tpu.assembly.local_em`` XLA sweeps are the reference (the
JAX tests pin its Pallas kernels to them); the port's functions run in f64
on the CPU on the same numpy inputs.  The fused banded vector and tangent
sweeps are held against JAX's banded gather (its XLA fallback on the CPU)
followed by the vector or tangent sweep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import LAM, MATERIALS, MU, rel_err, rng, to_numpy

import fenris_tpu_torch.ops.banded as tb
import fenris_tpu_torch.ops.em_sweep as tes
from fenris_tpu.assembly import local as JL
from fenris_tpu.assembly import local_em as JLE
from fenris_tpu.mesh.procedural import create_unit_box_uniform_hex_mesh_3d as jax_box
from fenris_tpu.mesh.reorder import reorder_mesh as jax_reorder_mesh
from fenris_tpu.ops import banded as jb
from fenris_tpu.quadrature.canonical import canonical_stiffness as jax_rule
from fenris_tpu.solid import LameParameters as JaxLame
from fenris_tpu.solid import MaterialEllipticOperator as JaxOp
from fenris_tpu_torch.assembly import local_em as TLE
from fenris_tpu_torch.assembly.local import tabulate
from fenris_tpu_torch.quadrature import canonical_stiffness
from fenris_tpu_torch.reference_elements import HEX8
from fenris_tpu_torch.solid import LameParameters as TorchLame
from fenris_tpu_torch.solid import MaterialEllipticOperator as TorchOp

RES = 3


def _inputs(seed=0):
    """Perturbed res-3 box geometry ``[8, 3, E]``, u ~ 1e-2 and v ~ N(0, 1) ``[8, 3, E]``."""
    mesh = jax_box(RES)
    g = rng(seed)
    pts = np.asarray(mesh.points) + g.uniform(-0.15, 0.15, np.asarray(mesh.points).shape) / RES
    X = np.transpose(pts[np.asarray(mesh.cells)], (1, 2, 0))
    E = X.shape[-1]
    return mesh, X, g.uniform(-0.01, 0.01, (8, 3, E)), g.standard_normal((8, 3, E))


def _ops(material):
    jcls, tcls = MATERIALS[material]
    return JaxOp(jcls(), dim=3), TorchOp(tcls(), dim=3)


def _tabs(mesh):
    return JL.tabulate(mesh.element, jax_rule(mesh.element)), tabulate(HEX8, canonical_stiffness("hex8"))


FUNCTIONS = {
    "vector": (JLE.assemble_element_elliptic_vectors_em, TLE.assemble_element_elliptic_vectors_em, False),
    "tangent": (JLE.assemble_element_elliptic_tangent_vectors_em, TLE.assemble_element_elliptic_tangent_vectors_em,
                True),
    "energy": (JLE.compute_element_elliptic_energy_em, TLE.compute_element_elliptic_energy_em, False),
    "diagonal": (JLE.elliptic_matrix_diagonal_em, TLE.elliptic_matrix_diagonal_em, False),
}


# the linear material's constant contraction takes the same code paths as StVK's
@pytest.mark.parametrize("material", ["neo_hookean", "stvk"])
@pytest.mark.parametrize("fn", list(FUNCTIONS))
def test_local_em_matches_jax(fn, material):
    jfn, tfn, tangent = FUNCTIONS[fn]
    mesh, X, u, v = _inputs()
    jop, top = _ops(material)
    jtab, ttab = _tabs(mesh)
    jargs = [jnp.asarray(X), jnp.asarray(u)] + ([jnp.asarray(v)] if tangent else [])
    targs = [torch.as_tensor(X), torch.as_tensor(u)] + ([torch.as_tensor(v)] if tangent else [])
    ref = jfn(*jargs, jop, JaxLame(MU, LAM), jtab)
    got = tfn(*targs, top, TorchLame(MU, LAM), ttab)
    # f64, another summation order: roundoff only
    assert rel_err(np.asarray(ref), got) < 1e-12


def test_qp_functions_match_jax():
    """One quadrature point of the vector and tangent sweeps, with two batch axes."""
    mesh, X, u, v = _inputs(1)
    jop, top = _ops("neo_hookean")
    jtab, ttab = _tabs(mesh)
    E = X.shape[-1]
    Xb, ub, vb = (a[..., : 3 * (E // 3)].reshape(*a.shape[:2], 3, E // 3) for a in (X, u, v))
    gd, dp, w = jtab.geo_dphi[2], jtab.dphi[2], float(jtab.weights[2])
    ref = JLE.elliptic_vector_qp(jnp.asarray(Xb), jnp.asarray(ub), jop, JaxLame(MU, LAM), jnp.asarray(gd),
                                 jnp.asarray(dp), w)
    got = TLE.elliptic_vector_qp(torch.as_tensor(Xb), torch.as_tensor(ub), top, TorchLame(MU, LAM),
                                 torch.as_tensor(gd), torch.as_tensor(dp), w)
    assert rel_err(np.asarray(ref), got) < 1e-12
    ref = JLE.elliptic_vector_tangent_qp(jnp.asarray(Xb), jnp.asarray(ub), jnp.asarray(vb), jop, JaxLame(MU, LAM),
                                         jnp.asarray(gd), jnp.asarray(dp), w)
    got = TLE.elliptic_vector_tangent_qp(torch.as_tensor(Xb), torch.as_tensor(ub), torch.as_tensor(vb), top,
                                         TorchLame(MU, LAM), torch.as_tensor(gd), torch.as_tensor(dp), w)
    assert rel_err(np.asarray(ref), got) < 1e-12


def test_plain_tangent_matches_jax_jvp_of_the_vector_sweep():
    mesh, X, u, v = _inputs(2)
    jop, top = _ops("neo_hookean")
    jtab, ttab = _tabs(mesh)
    _, ref = jax.jvp(
        lambda uu: JLE.assemble_element_elliptic_vectors_em(jnp.asarray(X), uu, jop, JaxLame(MU, LAM), jtab),
        (jnp.asarray(u),), (jnp.asarray(v),),
    )
    got = TLE.assemble_element_elliptic_tangent_vectors_em(
        torch.as_tensor(X), torch.as_tensor(u), torch.as_tensor(v), top, TorchLame(MU, LAM), ttab
    )
    # closed form vs forward-mode AD: f64 roundoff
    assert rel_err(np.asarray(ref), got) < 1e-10


def test_params_to_element_minor_matches_jax():
    E = 5
    mu = rng(3).standard_normal((E, 2))
    ref = JLE.params_to_element_minor(JaxLame(jnp.asarray(mu), 2.0), E)
    got = TLE.params_to_element_minor(TorchLame(torch.as_tensor(mu), 2.0), E)
    assert isinstance(got, TorchLame) and got.lam == 2.0
    assert np.array_equal(np.asarray(ref.mu), to_numpy(got.mu))
    assert TLE.params_to_element_minor(None, E) is None


def test_wrappers_take_plain_versions_on_cpu_and_refuse_other_devices():
    mesh, X, u, v = _inputs(4)
    _, top = _ops("neo_hookean")
    _, ttab = _tabs(mesh)
    params = TorchLame(MU, LAM)
    Xt, ut, vt = (torch.as_tensor(a, dtype=torch.float32) for a in (X, u, v))
    before = (tes.em_vector_sweep.launches, tes.em_vector_tangent_sweep.launches)
    tables = tes.device_tables(ttab, "cpu")  # geo_dphi [q, 8, 3], dphi [q, 8, 3], weights [q], flat f32
    q = ttab.num_points
    assert tables.dtype == torch.float32 and tables.numel() == q * (2 * 8 * 3 + 1)
    assert torch.equal(tables[-q:], torch.as_tensor(np.asarray(ttab.weights), dtype=torch.float32))
    assert torch.equal(tes.em_vector_sweep(Xt, ut, top, params, ttab, tables),
                       TLE.assemble_element_elliptic_vectors_em(Xt, ut, top, params, ttab))
    assert torch.equal(tes.em_vector_tangent_sweep(Xt, ut, vt, top, params, ttab),
                       TLE.assemble_element_elliptic_tangent_vectors_em(Xt, ut, vt, top, params, ttab))
    assert (tes.em_vector_sweep.launches, tes.em_vector_tangent_sweep.launches) == before
    meta = torch.empty((8, 3, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tes.em_vector_sweep(meta, meta, top, params, ttab)


def test_supports_is_what_the_kernels_take():
    from fenris_tpu_torch.reference_elements import element
    from fenris_tpu_torch.solid import HyperelasticMaterial

    _, ttab = _tabs(jax_box(1))
    _, nh = _ops("neo_hookean")
    for material in ("stvk", "linear"):
        assert tes.supports(_ops(material)[1], TorchLame(MU, LAM), ttab, torch.float32)
    assert tes.supports(nh, TorchLame(MU, LAM), ttab, torch.float32)
    assert tes.supports(nh, TorchLame(torch.tensor(MU), np.float64(LAM)), ttab, torch.float32)
    for name in ("tet4", "tet10", "tet20", "hex20", "hex27"):
        assert tes.supports(nh, TorchLame(MU, LAM), tabulate(element(name), canonical_stiffness(name)), torch.float32)
    assert not tes.supports(nh, TorchLame(MU, LAM), ttab, torch.float64)
    assert "f32" in tes.refusal(nh, TorchLame(MU, LAM), ttab, torch.float64)
    assert not tes.supports(TorchOp(HyperelasticMaterial(), dim=3), TorchLame(MU, LAM), ttab, torch.float32)
    # per-element [E] leaves are taken; [E, q] (per-point) leaves and [E] leaves of another length are not
    assert tes.supports(nh, TorchLame(torch.full((3,), MU), LAM), ttab, torch.float32, 3)
    assert not tes.supports(nh, TorchLame(torch.full((3, 8), MU), LAM), ttab, torch.float32, 3)
    assert "per-element [E]" in tes.refusal(nh, TorchLame(MU, np.full(4, LAM)), ttab, torch.float32, 3)
    assert not tes.supports(nh, None, ttab, torch.float32)
    quad = tabulate(element("quad4"), canonical_stiffness("quad4"))
    assert tes.supports(TorchOp(nh.material, dim=2), TorchLame(MU, LAM), quad, torch.float32)
    assert "d = 3" in tes.refusal(TorchOp(nh.material, dim=2), TorchLame(MU, LAM), ttab, torch.float32)


def _banded_inputs(res, seed):
    """RCM-reordered, perturbed res box with two owner blocks of 1,024 nodes and padding rows
    (rowt 256), its JAX and port plans, padded geometry ``[E_pad, 8, 3]``, u ~ 1e-2, v ~ N(0, 1)."""
    mesh, _ = jax_reorder_mesh(jax_box(res))
    cells, N = np.asarray(mesh.cells), mesh.num_vertices
    g = rng(seed)
    pts = np.asarray(mesh.points) + g.uniform(-0.15, 0.15, (N, 3)) / res
    jp = jb.make_banded_plan(cells, N, s=3, r_nodes=1024, rowt=256)
    tp = tb.make_banded_plan(cells, N, s=3, r_nodes=1024, rowt=256, device="cpu")
    return mesh, jp, tp, jp.pad_elements(pts[cells]), g.uniform(-0.01, 0.01, (N, 3)), g.standard_normal((N, 3))


@pytest.mark.parametrize("res", [10, 11])
def test_banded_tangent_sweep_plain_matches_jax(res):
    """The fused sweep's plain version against JAX's banded gather of u and v, then the tangent sweep."""
    mesh, jp, tp, Xp, u, v = _banded_inputs(res, 6)
    assert tp.k_blocks == 2 and tp.padded_elements > tp.num_elements and min(tp.counts) < tp.elements_per_block
    jop, top = _ops("neo_hookean")
    jtab, ttab = _tabs(mesh)
    ue, ve = (np.transpose(np.asarray(jb.gather(jp, jnp.asarray(a))), (1, 2, 0)) for a in (u, v))
    ref = JLE.assemble_element_elliptic_tangent_vectors_em(jnp.asarray(np.transpose(Xp, (1, 2, 0))), jnp.asarray(ue),
                                                           jnp.asarray(ve), jop, JaxLame(MU, LAM), jtab)
    X_band = torch.as_tensor(Xp).permute(1, 2, 0).contiguous()
    got = tes.banded_tangent_sweep_plain(tp, X_band, torch.as_tensor(u), torch.as_tensor(v), top, TorchLame(MU, LAM),
                                         ttab)
    assert got.shape == (tp.padded_elements, 8, 3)
    # f64, another summation order: roundoff only
    assert rel_err(np.transpose(np.asarray(ref), (2, 0, 1)), got) < 1e-12


@pytest.mark.parametrize("res", [10, 11])
def test_banded_vector_sweep_plain_matches_jax(res):
    """The fused residual sweep's plain version against JAX's banded gather of u, then the vector sweep."""
    mesh, jp, tp, Xp, u, _ = _banded_inputs(res, 9)
    assert tp.k_blocks == 2 and tp.padded_elements > tp.num_elements and min(tp.counts) < tp.elements_per_block
    jop, top = _ops("neo_hookean")
    jtab, ttab = _tabs(mesh)
    ue = np.transpose(np.asarray(jb.gather(jp, jnp.asarray(u))), (1, 2, 0))
    ref = JLE.assemble_element_elliptic_vectors_em(jnp.asarray(np.transpose(Xp, (1, 2, 0))), jnp.asarray(ue), jop,
                                                   JaxLame(MU, LAM), jtab)
    X_band = torch.as_tensor(Xp).permute(1, 2, 0).contiguous()
    got = tes.banded_vector_sweep_plain(tp, X_band, torch.as_tensor(u), top, TorchLame(MU, LAM), ttab)
    assert got.shape == (tp.padded_elements, 8, 3)
    # padding elements see zero displacements: zero rows
    assert not got[torch.as_tensor(tp.valid_elements()) == 0].any()
    # f64, another summation order: roundoff only
    assert rel_err(np.transpose(np.asarray(ref), (2, 0, 1)), got) < 1e-12


def test_banded_vector_sweep_takes_plain_version_on_cpu_and_refuses_other_devices():
    mesh, _, tp, Xp, u, _ = _banded_inputs(10, 10)
    _, top = _ops("neo_hookean")
    _, ttab = _tabs(mesh)
    params = TorchLame(MU, LAM)
    X_band = torch.as_tensor(Xp, dtype=torch.float32).permute(1, 2, 0).contiguous()
    ut = torch.as_tensor(u, dtype=torch.float32)
    before = tes.banded_vector_sweep.launches
    assert torch.equal(tes.banded_vector_sweep(tp, X_band, ut, top, params, ttab, tes.device_tables(ttab, "cpu")),
                       tes.banded_vector_sweep_plain(tp, X_band, ut, top, params, ttab))
    assert tes.banded_vector_sweep.launches == before
    meta = [torch.empty(a.shape, device="meta") for a in (X_band, ut)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tes.banded_vector_sweep(tp, *meta, top, params, ttab)


def test_banded_tangent_sweep_takes_plain_version_on_cpu_and_refuses_other_devices():
    mesh, _, tp, Xp, u, v = _banded_inputs(10, 7)
    _, top = _ops("neo_hookean")
    _, ttab = _tabs(mesh)
    params = TorchLame(MU, LAM)
    X_band = torch.as_tensor(Xp, dtype=torch.float32).permute(1, 2, 0).contiguous()
    ut, vt = (torch.as_tensor(a, dtype=torch.float32) for a in (u, v))
    before = tes.banded_tangent_sweep.launches
    assert torch.equal(tes.banded_tangent_sweep(tp, X_band, ut, vt, top, params, ttab, tes.device_tables(ttab, "cpu")),
                       tes.banded_tangent_sweep_plain(tp, X_band, ut, vt, top, params, ttab))
    assert tes.banded_tangent_sweep.launches == before
    meta = [torch.empty(a.shape, device="meta") for a in (X_band, ut, vt)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tes.banded_tangent_sweep(tp, *meta, top, params, ttab)
