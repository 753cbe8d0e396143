"""Port parity: the fused matrix-free model on tet10 and hex20 for every material the element sweeps take.

The port's ``HyperelasticModel(banded=True, fused_kernels=True)``, whose
element-sweep kernels take their plain versions on the CPU, runs in f64 on
tet10 (BCC res 2) and hex20 (box 2) beside JAX's ``HyperelasticModel`` on the
same mesh and numpy inputs, for the Neo-Hookean, StVK and linear-elastic
materials: one JAX model per element and material, its references computed
once.  The JAX models are unbanded: the quantities are the banded model's
(JAX's own tests hold the two together), and a banded JAX model traces for
4-10 s on the CPU, which would take this file past its 20 s of test time.
Then the port's plain element-minor sweeps against JAX's ``local_em`` on
tet4, tet20 and hex27, and one ``solve_mixed`` on tet10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import LAM, MATERIALS, MU, rel_err, rng

from fenris_tpu.assembly import local as JL
from fenris_tpu.assembly import local_em as JLE
from fenris_tpu.elasticity import HyperelasticModel as JaxModel
from fenris_tpu.mesh.convert import convert_mesh as jax_convert
from fenris_tpu.mesh.procedural import create_unit_box_uniform_hex_mesh_3d as jax_box
from fenris_tpu.mesh.procedural import create_unit_box_uniform_tet_mesh_3d as jax_tet_box
from fenris_tpu.solid import LameParameters as JaxLame
from fenris_tpu.solid import MaterialEllipticOperator as JaxOp
from fenris_tpu_torch.assembly import local_em as TLE
from fenris_tpu_torch.assembly.local import tabulate
from fenris_tpu_torch.elasticity import HyperelasticModel as TorchModel
from fenris_tpu_torch.interop import hyperelastic_model_from_arrays
from fenris_tpu_torch.mesh.convert import convert_mesh
from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d as torch_box
from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_tet_mesh_3d as torch_tet_box
from fenris_tpu_torch.optimize import NEWTON_CONVERGED
from fenris_tpu_torch.reference_elements import element
from fenris_tpu_torch.solid import LameParameters as TorchLame
from fenris_tpu_torch.solid import MaterialEllipticOperator as TorchOp

BODY = (0.0, 0.0, -4.0)  # tools/solve_assembled.py's load
RES = 2  # tet10: 96 cells, 567 dofs; hex20: 8 cells, 243 dofs
CASES = [(name, material) for name in ("tet10", "hex20") for material in MATERIALS]
INTEROP_NAMES = {"neo_hookean": "neo_hookean", "stvk": "stvk", "linear": "linear_elastic"}


def _fixed(points):
    return np.flatnonzero(np.asarray(points)[:, 2] < 1e-12)


def _jax_mesh(name, res=RES):
    return jax_convert((jax_tet_box if name.startswith("tet") else jax_box)(res), name)


def _torch_model(name, material, dtype=torch.float64):
    mesh = convert_mesh((torch_tet_box if name.startswith("tet") else torch_box)(RES), name)
    return TorchModel(mesh=mesh, material=MATERIALS[material][1](), params=TorchLame(MU, LAM),
                      dirichlet_nodes=_fixed(mesh.points), body_force=np.asarray(BODY), dtype=dtype, device="cpu",
                      banded=True, fused_kernels=True)


def _state(n, seed=0):
    g = rng(seed)
    return g.uniform(-0.01, 0.01, n), g.standard_normal(n)


_REF = {}


def _reference(name, material):
    """The JAX model of ``(name, material)`` and its f_ext, residual, Jacobi diagonal and Hessian action
    (forward-mode AD) at the seeded ``(u, v)``, computed once."""
    key = (name, material)
    if key not in _REF:
        mesh = _jax_mesh(name)
        jm = JaxModel(mesh=mesh, material=MATERIALS[material][0](), params=JaxLame(MU, LAM),
                      dirichlet_nodes=_fixed(mesh.points), body_force=lambda x, p: jnp.array(BODY, dtype=x.dtype))
        u, v = _state(jm.space.num_dofs)
        uj = jnp.asarray(u)
        _REF[key] = dict(model=jm, u=u, v=v, f_ext=np.asarray(jm._f_ext), residual=np.asarray(jm.residual(uj)),
                         diagonal=np.asarray(jm.hessian_diagonal(uj)),
                         hvp=np.asarray(jm.hessian_vector_product(uj, jnp.asarray(v))))
    return _REF[key]


@pytest.mark.parametrize("name,material", CASES)
def test_fused_model_matches_jax(name, material):
    ref = _reference(name, material)
    tm = _torch_model(name, material)
    assert tm.fused_kernels and tm._em_tables is not None and tm._plan.n == tm.mesh.element.num_nodes
    u, v = torch.as_tensor(ref["u"]), torch.as_tensor(ref["v"])
    # f64, another summation order: roundoff only
    assert rel_err(ref["f_ext"], tm._f_ext) < 1e-12
    assert rel_err(ref["residual"], tm.residual(u)) < 1e-12
    assert rel_err(ref["diagonal"], tm.hessian_diagonal(u)) < 1e-12
    # forward-mode AD (JAX) against the closed-form tangent of the fused sweep
    assert rel_err(ref["hvp"], tm.hessian_vector_product(u, v)) < 1e-10
    assert rel_err(ref["hvp"], tm.hessian_operator(u)(v)) < 1e-10


@pytest.mark.parametrize("name,material", CASES)
def test_model_carried_across_matches_jax(name, material):
    ref = _reference(name, material)
    jm = ref["model"]
    tm = hyperelastic_model_from_arrays(
        np.asarray(jm.mesh.points), np.asarray(jm.mesh.cells), jm.params.mu, jm.params.lam, jm.dirichlet_nodes,
        np.asarray(BODY), element=name, material=INTEROP_NAMES[material], dtype=torch.float64, device="cpu",
        banded=True, fused_kernels=True,
    )
    assert type(tm.material) is MATERIALS[material][1] and tm.mesh.element.name == name
    assert tm.fused_kernels and tm._plan is not None
    u, v = torch.as_tensor(ref["u"]), torch.as_tensor(ref["v"])
    assert rel_err(ref["residual"], tm.residual(u)) < 1e-12
    assert rel_err(ref["hvp"], tm.hessian_vector_product(u, v)) < 1e-10




@pytest.mark.parametrize("name", ["tet4", "tet20", "hex27"])
def test_plain_sweeps_match_jax_on_other_elements(name):
    """The element-minor vector and tangent sweeps (the kernels' plain versions) on 5 perturbed elements of
    a res-1 box against JAX's local_em in f64.  The element shapes are what is held here (every material
    runs on tet10 and hex20 above): linear elasticity on a one-point rule, and JAX's local_em op by op
    (``jax.disable_jit``), since tracing and compiling its scan over the points takes 3-5 s an element."""
    from fenris_tpu.quadrature import hexahedron_gauss as jax_gauss
    from fenris_tpu.quadrature.total_order import tetrahedron as jax_tet_rule
    from fenris_tpu_torch.quadrature import hexahedron_gauss
    from fenris_tpu_torch.quadrature.total_order import tetrahedron

    mesh = jax_box(1) if name == "hex27" else jax_tet_box(1)
    mesh = mesh if name == "tet4" else jax_convert(mesh, name)
    g = rng(4)
    m = element(name).geometry.num_nodes
    pts = np.asarray(mesh.points) + g.uniform(-0.05, 0.05, np.asarray(mesh.points).shape)
    cells = np.concatenate([np.asarray(mesh.cells)] * 5)[:5]
    X = np.transpose(pts[cells[:, :m]], (1, 2, 0))
    n = cells.shape[1]
    u, v = g.uniform(-0.01, 0.01, (n, 3, 5)), g.standard_normal((n, 3, 5))
    hex_rule = name.startswith("hex")
    jtab = JL.tabulate(mesh.element, jax_gauss(1) if hex_rule else jax_tet_rule(1))
    ttab = tabulate(element(name), hexahedron_gauss(1) if hex_rule else tetrahedron(1))
    Xt, ut, vt = (torch.as_tensor(a) for a in (X, u, v))
    Xj, uj, vj = (jnp.asarray(a) for a in (X, u, v))
    jcls, tcls = MATERIALS["linear"]
    jop, top = JaxOp(jcls(), dim=3), TorchOp(tcls(), dim=3)
    jp, tp = JaxLame(MU, LAM), TorchLame(MU, LAM)
    with jax.disable_jit():
        f_ref = JLE.assemble_element_elliptic_vectors_em(Xj, uj, jop, jp, jtab)
        hv_ref = JLE.assemble_element_elliptic_tangent_vectors_em(Xj, uj, vj, jop, jp, jtab)
    assert rel_err(f_ref, TLE.assemble_element_elliptic_vectors_em(Xt, ut, top, tp, ttab)) < 1e-12
    assert rel_err(hv_ref, TLE.assemble_element_elliptic_tangent_vectors_em(Xt, ut, vt, top, tp, ttab)) < 1e-12


def test_fused_solve_mixed_on_tet10_matches_jax():
    """The f32 fused model's solve_mixed (f64 outer residual) on tet10, Neo-Hookean, to 1e-10: the JAX
    model's relative residual of its solution <= 1e-10 and the solution within 1e-8 of JAX's f64 solve."""
    ref = _reference("tet10", "neo_hookean")
    jm = ref["model"]
    tm = _torch_model("tet10", "neo_hookean", dtype=torch.float32)
    res = tm.solve_mixed(tolerance=1e-10)
    assert res.status == NEWTON_CONVERGED and res.x.dtype == torch.float64
    x = res.x.numpy()
    r0 = float(jnp.linalg.norm(jm.residual(jnp.zeros(jm.space.num_dofs))))
    assert float(jnp.linalg.norm(jm.residual(jnp.asarray(x)))) / r0 <= 1e-10
    jres = jm.solve(tolerance=1e-12, cg_rel_tolerance=1e-10)
    assert rel_err(np.asarray(jres.x), x) < 1e-8
