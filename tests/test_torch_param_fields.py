"""Port parity: parameter fields, per-element ``[E]`` and per-point ``[E, q]`` material parameters.

The JAX package's leaf rules (``assembly/local.py`` ``_vmap2``,
``local_em.py`` ``_params_levels``, ``elasticity.py`` ``pad_leaf``) against
the port's on the same numpy inputs in f64: Lamé parameters of a
two-material solid on hex8 and tet10, unbanded (chunked), banded and
banded with the fused sweeps (their plain versions on the CPU) against
JAX's unbanded model, as ``tests/test_banded.py:180-220`` holds JAX's
banded model; per-point leaves on the plain path; the ``E == q``
ambiguity; the banded path's ``ValueError`` for per-point leaves; the
element matrices in the pairs layout; and ``interop`` carrying ``[E]``
arrays across.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import LAM, MU, rel_err, rng

import fenris_tpu.assembly.local as jlocal
import fenris_tpu_torch.assembly.local as tlocal
from fenris_tpu.elasticity import HyperelasticModel as JaxModel
from fenris_tpu.mesh.convert import convert_mesh as jax_convert
from fenris_tpu.mesh.procedural import create_unit_box_uniform_hex_mesh_3d as jax_box
from fenris_tpu.mesh.procedural import create_unit_box_uniform_tet_mesh_3d as jax_tet_box
from fenris_tpu.mesh.reorder import reorder_mesh as jax_reorder_mesh
from fenris_tpu.quadrature.canonical import canonical_stiffness as jax_rule
from fenris_tpu.solid import LameParameters as JaxLame
from fenris_tpu.solid import LinearElasticMaterial as JaxLinear
from fenris_tpu.solid import MaterialEllipticOperator as JaxOp
from fenris_tpu.solid import NeoHookeanMaterial as JaxNeoHookean
from fenris_tpu_torch.elasticity import HyperelasticModel as TorchModel
from fenris_tpu_torch.interop import hyperelastic_model_from_arrays, mesh_from_arrays
from fenris_tpu_torch.quadrature import canonical_stiffness
from fenris_tpu_torch.reference_elements import element
from fenris_tpu_torch.solid import LameParameters as TorchLame
from fenris_tpu_torch.solid import LinearElasticMaterial as TorchLinear
from fenris_tpu_torch.solid import MaterialEllipticOperator as TorchOp
from fenris_tpu_torch.solid import NeoHookeanMaterial as TorchNeoHookean

BODY = (0.0, 0.0, -4.0)  # tools/solve_assembled.py's load
MODES = {"unbanded": dict(chunk_size=7), "banded": dict(banded=True, chunk_size=64),
         "fused": dict(banded=True, fused_kernels=True)}


def _mesh(name):
    """RCM-reordered hex8 box 3 (27 cells) or tet10 BCC box 2 (96 cells): the same arrays in both packages."""
    mesh = jax_box(3) if name == "hex8" else jax_convert(jax_tet_box(2), "tet10")
    mesh, _ = jax_reorder_mesh(mesh)
    return mesh


def _two_materials(points, cells, seed):
    """Per-element ``(mu, lam)``: 10x stiffer where the element's centroid lies at x > 0.5, each value
    varied by up to 10%."""
    g = rng(seed)
    stiff = 1.0 + 9.0 * (np.asarray(points)[np.asarray(cells)].mean(1)[:, 0] > 0.5)
    E = len(stiff)
    return MU * stiff * g.uniform(0.9, 1.1, E), LAM * stiff * g.uniform(0.9, 1.1, E)


def _fixed(points):
    return np.flatnonzero(np.asarray(points)[:, 2] < 1e-12)


_REF = {}


def _reference(name):
    """JAX's unbanded two-material model on ``name`` and its energy, residual, Jacobi diagonal and Hessian
    action (forward-mode AD) at seeded ``(u, v)``, computed once."""
    if name not in _REF:
        mesh = _mesh(name)
        mu, lam = _two_materials(mesh.points, mesh.cells, 3)
        jm = JaxModel(mesh=mesh, material=JaxNeoHookean(), params=JaxLame(jnp.asarray(mu), jnp.asarray(lam)),
                      dirichlet_nodes=_fixed(mesh.points), body_force=lambda x, p: jnp.array(BODY, dtype=x.dtype))
        g = rng(4)
        u, v = g.uniform(-0.01, 0.01, jm.space.num_dofs), g.standard_normal(jm.space.num_dofs)
        uj = jnp.asarray(u)
        _REF[name] = dict(mesh=mesh, mu=mu, lam=lam, u=u, v=v, energy=float(jm.energy(uj)),
                          residual=np.asarray(jm.residual(uj)), diagonal=np.asarray(jm.hessian_diagonal(uj)),
                          hvp=np.asarray(jm.hessian_vector_product(uj, jnp.asarray(v))), model=jm)
    return _REF[name]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["hex8", "tet10"])
def test_per_element_params_match_jax(name, mode):
    """Per-element ``[E]`` mu and lam in the port's model (in chunks, in the banded padded order, through
    the fused sweeps' plain versions) against JAX's unbanded model."""
    ref = _reference(name)
    mesh = ref["mesh"]
    tm = TorchModel(mesh=mesh_from_arrays(np.asarray(mesh.points), np.asarray(mesh.cells), name),
                    material=TorchNeoHookean(), params=TorchLame(ref["mu"], ref["lam"]),
                    dirichlet_nodes=_fixed(mesh.points), body_force=np.asarray(BODY), dtype=torch.float64,
                    device="cpu", banded_r_nodes=1024, **MODES[mode])
    if mode != "unbanded":  # padding elements take their fillers' values
        assert tm._params_band.mu.shape == (tm._plan.padded_elements,)
        assert torch.equal(tm._params_band.mu, torch.as_tensor(ref["mu"][tm._plan.element_index]))
    u, v = torch.as_tensor(ref["u"]), torch.as_tensor(ref["v"])
    assert float(tm.energy(u)) == pytest.approx(ref["energy"], rel=1e-12)
    assert rel_err(ref["residual"], tm.residual(u)) < 1e-12
    assert rel_err(ref["diagonal"], tm.hessian_diagonal(u)) < 1e-12
    assert rel_err(ref["hvp"], tm.hessian_vector_product(u, v)) < 1e-10


def _hex8_box2():
    mesh = jax_box(2)  # 8 cells: E == q == 8 for hex8's canonical rule
    return mesh, mesh_from_arrays(np.asarray(mesh.points), np.asarray(mesh.cells), "hex8")


def test_per_point_params_match_jax():
    """``[E, q]`` mu on the unbanded plain path (27 cells, 8 points): residual, Hessian action, energy and
    element matrices against JAX."""
    jmesh = jax_box(3)
    tmesh = mesh_from_arrays(np.asarray(jmesh.points), np.asarray(jmesh.cells), "hex8")
    mu = MU * rng(5).uniform(0.5, 2.0, (jmesh.num_cells, 8))
    jm = JaxModel(mesh=jmesh, material=JaxNeoHookean(), params=JaxLame(jnp.asarray(mu), LAM),
                  dirichlet_nodes=_fixed(jmesh.points))
    tm = TorchModel(mesh=tmesh, material=TorchNeoHookean(), params=TorchLame(mu, LAM),
                    dirichlet_nodes=_fixed(tmesh.points), dtype=torch.float64, device="cpu")
    g = rng(6)
    u, v = g.uniform(-0.01, 0.01, tm.space.num_dofs), g.standard_normal(tm.space.num_dofs)
    uj, ut = jnp.asarray(u), torch.as_tensor(u)
    assert rel_err(np.asarray(jm.residual(uj)), tm.residual(ut)) < 1e-12
    assert rel_err(np.asarray(jm.hessian_vector_product(uj, jnp.asarray(v))),
                   tm.hessian_vector_product(ut, torch.as_tensor(v))) < 1e-10
    assert float(tm.energy(ut)) == pytest.approx(float(jm.energy(uj)), rel=1e-12)
    assert rel_err(np.asarray(jm.assemble_hessian_matrices(uj)), tm.assemble_hessian_matrices(ut)) < 1e-12


def test_ambiguous_leading_axis_reads_per_element():
    """With E == q (8 hex8 cells, 8 points) an ``[8]`` leaf is per element, as in JAX: the port's residual
    equals JAX's and the port's with the same values repeated over an explicit point axis."""
    jmesh, tmesh = _hex8_box2()
    mu = MU * rng(7).uniform(0.5, 2.0, 8)
    jm = JaxModel(mesh=jmesh, material=JaxNeoHookean(), params=JaxLame(jnp.asarray(mu), LAM))
    u = rng(8).uniform(-0.01, 0.01, jm.space.num_dofs)
    ut = torch.as_tensor(u)
    got = TorchModel(mesh=tmesh, material=TorchNeoHookean(), params=TorchLame(mu, LAM), dtype=torch.float64,
                     device="cpu").residual(ut)
    per_point = TorchModel(mesh=tmesh, material=TorchNeoHookean(), params=TorchLame(np.repeat(mu[:, None], 8, 1), LAM),
                           dtype=torch.float64, device="cpu").residual(ut)
    assert rel_err(np.asarray(jm.residual(jnp.asarray(u))), got) < 1e-12
    assert rel_err(per_point, got) < 1e-14


def test_per_point_params_refused_on_banded_path():
    """``[E, q]`` leaves raise ``ValueError`` on the banded path, as JAX's (tests/test_banded.py:218); the
    same leaf in ``[E]`` form builds."""
    _, tmesh = _hex8_box2()
    for params in (TorchLame(np.full((8, 8), MU), LAM), TorchLame(MU, np.full((8, 8, 1), LAM))):
        with pytest.raises(ValueError, match="per-quadrature-point"):
            TorchModel(mesh=tmesh, material=TorchNeoHookean(), params=params, dtype=torch.float64, device="cpu",
                       banded=True)
    TorchModel(mesh=tmesh, material=TorchNeoHookean(), params=TorchLame(np.full(8, MU), LAM), dtype=torch.float64,
               device="cpu", banded=True)


def test_per_element_matrices_pairs_match_jax():
    """Linear-elastic element matrices in the pairs layout with ``[E]`` parameters on tet10 (JAX's affine
    per-element path; the port's general pairs path) and on hex8, ``kernel="auto"`` on the CPU."""
    for name in ("tet10", "hex8"):
        mesh = _mesh(name)
        mu, lam = _two_materials(mesh.points, mesh.cells, 9)
        m = element(name).geometry.num_nodes
        X = np.asarray(mesh.points)[np.asarray(mesh.cells)[:, :m]]
        jtab = jlocal.tabulate(mesh.element, jax_rule(mesh.element))
        ttab = tlocal.tabulate(element(name), canonical_stiffness(name))
        ref = jlocal.assemble_element_elliptic_matrices_pairs(
            jnp.asarray(X), None, JaxOp(JaxLinear(), dim=3), JaxLame(jnp.asarray(mu), jnp.asarray(lam)), jtab)
        got = tlocal.assemble_element_elliptic_matrices_pairs(
            torch.as_tensor(X), None, TorchOp(TorchLinear(), dim=3), TorchLame(torch.as_tensor(mu), torch.as_tensor(lam)),
            ttab, kernel="auto")
        assert rel_err(np.asarray(ref), got) < 1e-12


def test_interop_carries_per_element_params():
    """A JAX model's f32 ``[E]`` parameters carried across by ``hyperelastic_model_from_arrays``: the port
    model holds them in its dtype (the f32 leaves' values) and its residual equals JAX's."""
    ref = _reference("tet10")
    mesh = ref["mesh"]
    mu32, lam32 = np.float32(ref["mu"]), np.float32(ref["lam"])
    jm = JaxModel(mesh=mesh, material=JaxNeoHookean(), params=JaxLame(jnp.asarray(mu32), jnp.asarray(lam32)),
                  dirichlet_nodes=_fixed(mesh.points), body_force=lambda x, p: jnp.array(BODY, dtype=x.dtype))
    tm = hyperelastic_model_from_arrays(
        np.asarray(mesh.points), np.asarray(mesh.cells), np.asarray(jm.params.mu), np.asarray(jm.params.lam),
        jm.dirichlet_nodes, np.asarray(BODY), element="tet10", dtype=torch.float64, device="cpu",
        banded=True, fused_kernels=True,
    )
    assert tm._params.mu.dtype == torch.float64 and torch.equal(tm._params.mu, torch.as_tensor(mu32, dtype=torch.float64))
    u = torch.as_tensor(ref["u"])
    assert rel_err(np.asarray(jm.residual(jnp.asarray(ref["u"]))), tm.residual(u)) < 1e-12
