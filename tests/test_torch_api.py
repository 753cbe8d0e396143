"""Port parity: the public surface of ``fenris_tpu_torch`` against ``fenris_tpu``.

Every module of the JAX package (``pkgutil.walk_packages``) is one case:
each of its public names (its ``__all__``, or else the functions and
classes it defines, and for a package also those it re-exports from its
own modules and the modules it binds under another name) must exist in the
port's module of the same path, and each function's and public method's
parameters must be the first of the port's, in the JAX package's order
(the port may add parameters after them; private parameters, ``_name``,
are not compared).  What the port does not carry over is listed in
``NOT_CARRIED_OVER`` and ``RENAMED`` with its reason; an entry that no
longer matches a difference fails ``test_every_exemption_matches``.

Then the JAX quick start written with ``import fenris_tpu_torch as ft``,
a positional ``newton_line_search`` call and ``make_device_mesh`` with its
axis, each against the JAX package on the same inputs, and the import of
the package in a fresh process (no JAX, no CUDA, no kernel build).
"""

from __future__ import annotations

import importlib
import inspect
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch_parity import rel_err

import fenris_tpu
import fenris_tpu.optimize as jax_optimize
import fenris_tpu.parallel as jax_parallel
import fenris_tpu_torch as ft

REPO = Path(__file__).resolve().parent.parent

# A key names a JAX module (and its submodules), a public name of one ("module:name", a method
# "module:Class.method"), a parameter ("module:name(parameter)") or a whole parameter list ("module:name()");
# a function or class goes by the module that defines it, wherever it is re-exported.
NOT_CARRIED_OVER = {
    "fenris_tpu.native": "host C++ builders of the CSR pattern and the RCM; the port builds both on the card",
    "fenris_tpu.ops.stiffness_kernel": "the Pallas stiffness kernel's module; the port's is ops.stiffness_pairs",
    "fenris_tpu.config:default_dtype": "JAX's process-wide x64 switch; the port takes a dtype per model or call",
    "fenris_tpu.config:default_int_dtype": "JAX's process-wide x64 switch; the port takes a dtype per model or call",
    "fenris_tpu.config:enable_x64": "JAX's process-wide x64 switch; the port takes a dtype per model or call",
    "fenris_tpu.config:MATMUL_PRECISION": "XLA's f32 matmul pin; the port turns TF32 off at import instead",
    "fenris_tpu.utils:hoist_closure": "TPU workaround: closure constants in XLA:TPU while loops",
    "fenris_tpu.utils:log1p_accurate": "TPU workaround: inexact TPU log; the port calls torch.log1p",
    "fenris_tpu.optimize:newton_cache": "XLA trace cache of the Newton loop; the port's loop runs eagerly",
    "fenris_tpu.optimize:newton_line_search(cache)": "XLA trace cache of the Newton loop",
    "fenris_tpu.optimize:mixed_precision_newton(probe)": "TPU workaround: miscompile probe of the inner solve",
    "fenris_tpu.sparse.cg:conjugate_gradient(host_loop)": "TPU workaround: host-driven CG loop",
    "fenris_tpu.sparse.cg:conjugate_gradient(validate_operator)": "TPU workaround: miscompile probe of the operator",
    "fenris_tpu.elasticity:HyperelasticModel.solve_mixed(cg_host_loop)": "TPU workaround: host-driven CG loop",
    "fenris_tpu.structured:StructuredHyperelasticModel.solve_mixed(cg_host_loop)": "TPU workaround: host CG loop",
    "fenris_tpu.sparse.block_dia:block_dia_assembly_plan(host_base)": "host numpy plan builder; the port's is on the card",
    "fenris_tpu.assembly.global_:assemble_csr(num_chunks)": "TPU memory chunking; the port sums in collision-free layers",
    "fenris_tpu.assembly.local:assemble_element_elliptic_matrices(layout)": "TPU layout: MXU reassociation",
    "fenris_tpu.assembly.local_em:assemble_element_elliptic_vectors_em(tables)": "TPU layout: lane tables",
    "fenris_tpu.assembly.local_em:assemble_element_elliptic_tangent_vectors_em(tables)": "TPU layout: lane tables",
    "fenris_tpu.sparse.dia_kernel:block_dia_operator(lanes)": "TPU layout: lane width of the packed bands",
    "fenris_tpu.sparse.dia_kernel:PackedDia": "TPU layout: packed bands of the Pallas sweep",
    "fenris_tpu.sparse.dia_kernel:PackedDiaW": "TPU layout: packed bands of the Pallas sweep",
    "fenris_tpu.sparse.dia_kernel:pack_block_dia": "TPU layout: packed bands of the Pallas sweep",
    "fenris_tpu.sparse.dia_kernel:pack_block_dia_windowed": "TPU layout: packed bands of the Pallas sweep",
    "fenris_tpu.sparse.dia_kernel:packed_dia_matvec": "TPU layout: packed bands of the Pallas sweep",
    "fenris_tpu.sparse.dia_kernel:packed_dia_matvec_cm": "TPU layout: packed bands of the Pallas sweep",
    "fenris_tpu.sparse.dia_kernel:packed_dia_matvec_wm": "TPU layout: packed bands of the Pallas sweep",
    "fenris_tpu.ops.banded:gather_blocked": "TPU layout: the 128-node window blocking",
    "fenris_tpu.ops.banded:scatter_add_blocked": "TPU layout: the 128-node window blocking",
    "fenris_tpu.ops.banded:BandedPlan.__init__()": "TPU layout: a plan's fields hold the window blocking",
    "fenris_tpu.ops.em_sweep:supports()": "TPU workaround: JAX's asks for the TPU backend; the port's for its kernels",
    "fenris_tpu.ops.structured_stencil:neo_hookean_residual_pallas": "a *_pallas name; the port's is *_stencil",
    "fenris_tpu.ops.structured_stencil:neo_hookean_hvp_pallas": "a *_pallas name; the port's is *_stencil",
    "fenris_tpu.structured:StructuredHyperelasticModel.internal_forces_pallas_grid": "a *_pallas method",
    "fenris_tpu.structured:StructuredHyperelasticModel.internal_forces_pallas": "a *_pallas method",
    "fenris_tpu.structured:StructuredHyperelasticModel.residual_pallas": "a *_pallas method",
    "fenris_tpu.structured:StructuredHyperelasticModel.hessian_vector_product_pallas": "a *_pallas method",
    "fenris_tpu.structured:StructuredHyperelasticModel.__init__(pallas_kz)": "TPU layout: Pallas z tile",
}

# JAX parameters the port takes at the same place under another name: key -> (port's name, reason)
RENAMED = {
    "fenris_tpu.sparse.dia_kernel:block_dia_operator(pallas)": ("kernel", "the port's kernels are not Pallas"),
    "fenris_tpu.elasticity:HyperelasticModel.assembled_hessian_operator(pallas)": (
        "kernel", "the port's kernels are not Pallas"),
    "fenris_tpu.structured:StructuredHyperelasticModel.__init__(pallas)": ("kernel", "the port's kernels are not Pallas"),
}


def _modules():
    return ["fenris_tpu"] + [m.name for m in pkgutil.walk_packages(fenris_tpu.__path__, "fenris_tpu.")]


MODULES = _modules()


def _port_name(name: str) -> str:
    return "fenris_tpu_torch" + name[len("fenris_tpu"):]


def _public(mod) -> list:
    """``__all__``, or else the functions and classes ``mod`` defines (a package: also those of its own modules
    it re-exports, and its modules bound under another name)."""
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    own = mod.__name__ + "." if hasattr(mod, "__path__") else None
    names = []
    for n, v in vars(mod).items():
        if n.startswith("_"):
            continue
        if inspect.ismodule(v):
            if own and v.__name__.startswith(own) and v.__name__.rsplit(".", 1)[1] != n:
                names.append(n)
        elif inspect.isfunction(v) or inspect.isclass(v):
            where = getattr(v, "__module__", "") or ""
            if where == mod.__name__ or (own and where.startswith(own)):
                names.append(n)
    return names


def _params(f):
    try:
        sig = inspect.signature(f)
    except (TypeError, ValueError):
        return None
    return [p.name for p in sig.parameters.values()
            if not p.name.startswith("_") and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _unwrap(v):
    return v.__func__ if isinstance(v, (staticmethod, classmethod)) else v


def _check_params(qual, jf, tf, faults, used):
    jp, tp = _params(jf), _params(tf)
    if jp is None:
        return
    if tp is None:
        faults.append(f"{qual}: the port's has no signature")
        return
    expect = []
    for p in jp:
        key = f"{qual}({p})"
        if key in RENAMED and p not in tp and RENAMED[key][0] in tp:
            used.add(key)
            expect.append(RENAMED[key][0])
        elif key in NOT_CARRIED_OVER and p not in tp:
            used.add(key)
        else:
            expect.append(p)
    if tp[:len(expect)] != expect:
        if f"{qual}()" in NOT_CARRIED_OVER:
            used.add(f"{qual}()")
        else:
            faults.append(f"{qual}: the JAX package's parameters {expect} do not open the port's {tp}")


def _differences(jname: str):
    """``(faults, exemptions used)`` of the JAX module ``jname`` against the port's module of the same path."""
    faults, used = [], set()
    exempt = [k for k in NOT_CARRIED_OVER if ":" not in k and (jname == k or jname.startswith(k + "."))]
    try:
        tm = importlib.import_module(_port_name(jname))
    except ModuleNotFoundError:
        if exempt:
            used.update(exempt)
        else:
            faults.append(f"{jname}: the port has no {_port_name(jname)}")
        return faults, used
    if exempt:
        return faults, used  # the port has it: the exemption is stale
    jm = importlib.import_module(jname)
    for n in _public(jm):
        jv = getattr(jm, n)
        where = getattr(jv, "__module__", None) if callable(jv) else None
        qual = f"{where if where and where.startswith('fenris_tpu') else jname}:{n}"  # a re-export: its home
        if not hasattr(tm, n):
            if qual in NOT_CARRIED_OVER:
                used.add(qual)
            else:
                faults.append(f"{qual}: the port has no {n}")
            continue
        tv = getattr(tm, n)
        if inspect.ismodule(jv):
            if not (inspect.ismodule(tv) and tv.__name__ == _port_name(jv.__name__)):
                faults.append(f"{qual}: the port's {n} is {tv!r}, not {_port_name(jv.__name__)}")
        elif inspect.isclass(jv):
            if not inspect.isclass(tv):
                faults.append(f"{qual}: the port's {n} is not a class")
                continue
            for mn, mv in vars(jv).items():
                mv = _unwrap(mv)
                if (mn.startswith("_") and mn != "__init__") or not inspect.isfunction(mv):
                    continue
                mqual = f"{qual}.{mn}"
                try:
                    tmv = _unwrap(inspect.getattr_static(tv, mn))
                except AttributeError:
                    if mqual in NOT_CARRIED_OVER:
                        used.add(mqual)
                    else:
                        faults.append(f"{mqual}: the port's {n} has no {mn}")
                    continue
                _check_params(mqual, mv, tmv, faults, used)
        elif callable(jv):
            _check_params(qual, jv, tv, faults, used)
    return faults, used


@pytest.mark.parametrize("name", MODULES)
def test_module_matches_jax(name):
    """The port's module of the same path has every public name of the JAX module, and every function and
    public method takes the JAX package's parameters first, in its order."""
    faults, _ = _differences(name)
    assert not faults, "\n".join(faults)


def test_every_exemption_matches():
    """Each entry of ``NOT_CARRIED_OVER`` and ``RENAMED`` still matches a difference of the two packages."""
    used = set()
    for name in MODULES:
        used |= _differences(name)[1]
    stale = sorted((set(NOT_CARRIED_OVER) | set(RENAMED)) - used)
    assert not stale, f"exemptions that match nothing: {stale}"


def test_root_namespace():
    """``ft.`` resolves what the JAX root exports, and the modules the quick starts reach through it."""
    assert ft.__version__ == fenris_tpu.__version__
    assert set(fenris_tpu.__all__) <= set(ft.__all__)
    assert ft.element("hex8") is ft.ELEMENTS["hex8"] and isinstance(ft.element("hex8"), ft.ReferenceElement)
    assert sorted(ft.ELEMENTS) == sorted(fenris_tpu.ELEMENTS)
    for sub in ("procedural", "convert", "refinement", "reorder"):
        assert getattr(ft.mesh, sub).__name__ == f"fenris_tpu_torch.mesh.{sub}"
    assert ft.assembly.global_assembly.__name__ == "fenris_tpu_torch.assembly.global_"


def test_import_needs_no_jax_and_no_card():
    """In a fresh process, importing the package loads neither JAX nor the JAX package, leaves CUDA
    uninitialised and builds no kernel library."""
    code = (
        "import sys, torch, fenris_tpu_torch\n"
        "b = sys.modules.get('fenris_tpu_torch.ops._build')\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'fenris_tpu.'))"
        " or m == 'fenris_tpu'), torch.cuda.is_initialized(),"
        " 0 if b is None else b.load_library.cache_info().currsize)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "[] False 0"


def test_quick_start_matches_jax():
    """``fenris_tpu/__init__.py``'s quick start written with ``ft.`` (f64, CPU, res 8): ``u`` within 1e-12
    of the JAX package's, CG iterations within one."""
    import fenris_tpu as jft

    results = {}
    for pkg in (jft, ft):
        mesh = pkg.mesh.procedural.create_unit_square_uniform_quad_mesh_2d(8)
        extra = dict(dtype=torch.float64, device="cpu") if pkg is ft else {}
        results[pkg.__name__] = pkg.fem.solve_poisson(
            mesh,
            pkg.quadrature.quadrilateral_gauss(2),
            pkg.quadrature.quadrilateral_gauss(6),
            source=lambda x, p: 1.0,
            dirichlet_nodes=mesh.find_boundary_vertices(),
            **extra,
        )
    ref, got = results["fenris_tpu"], results["fenris_tpu_torch"]
    assert got.u.dtype == torch.float64 and got.u.shape == (81,)
    assert rel_err(np.asarray(ref.u), got.u) <= 1e-12
    assert abs(got.cg_iterations - ref.cg_iterations) <= 1


def _nonlinear_system(xp, dense_solve):
    """``F(x) = atan(x) + 0.1 L x - b`` on 6 dofs (L the path Laplacian): full Newton steps from x0 = 3
    overshoot, so the line search backtracks."""
    n = 6
    L = 2.0 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    b = np.linspace(-0.5, 1.0, n)
    Lx, bx = xp.asarray(L), xp.asarray(b)

    def residual(x):
        return xp.arctan(x) + 0.1 * (Lx @ x) - bx

    def solve_jacobian(x, f):
        return dense_solve(xp.diag(1.0 / (1.0 + x * x)) + 0.1 * Lx, f)

    return residual, solve_jacobian, xp.asarray(np.full(n, 3.0))


def test_newton_line_search_positional_call_matches_jax():
    """A call in the JAX package's positional order ``(residual, solve_jacobian, x0, tolerance,
    max_iterations, line_search, c, alpha_min, max_backtracks)``: ``x`` within 1e-12, the same iterations and
    status."""
    args = (1e-12, 30, True, 1e-4, 1e-6, 14)
    jr, js, jx0 = _nonlinear_system(jnp, jnp.linalg.solve)
    ref = jax_optimize.newton_line_search(jr, js, jx0, *args)
    tr, ts, tx0 = _nonlinear_system(torch, torch.linalg.solve)
    seen = []
    got = ft.optimize.newton_line_search(tr, ts, tx0, *args, lambda k, fn: seen.append(k))
    assert int(ref.status) == got.status == ft.optimize.NEWTON_CONVERGED
    assert int(ref.iterations) == got.iterations == seen[-1] and got.iterations > 3
    assert rel_err(np.asarray(ref.x), got.x) <= 1e-12
    # a full step from x0 = 3 overshoots: without the line search Newton does not converge in 30 steps
    assert ft.optimize.newton_line_search(tr, ts, tx0, 1e-12, 30, False).status != ft.optimize.NEWTON_CONVERGED


def test_make_device_mesh_takes_jax_axis(tmp_path):
    """``make_device_mesh(None, axis)`` names the mesh's dimension as the JAX package's does (``axis`` second,
    ``device_type`` after it); a banded model sharded over a mesh of another axis name
    (``ShardedBandedElasticity(model, mesh, axis)``) gives the model's own residual (within 1e-12;
    ``test_torch_parallel.py`` holds the class against JAX's models), and over a mesh without its axis raises."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        for axis in ("dp", "x"):
            mesh = ft.parallel.make_device_mesh(None, axis, device_type="cpu")
            assert mesh.mesh_dim_names == jax_parallel.make_device_mesh(None, axis).axis_names == (axis,)
            assert mesh.size() == 1
        box = ft.mesh.procedural.create_unit_box_uniform_hex_mesh_3d(2)
        fixed = np.flatnonzero(box.points[:, 2] < 1e-12)
        model = ft.elasticity.HyperelasticModel(box, ft.solid.NeoHookeanMaterial(),
                                                ft.solid.LameParameters(384.614, 576.923), None, fixed,
                                                np.array([0.0, 0.0, -5.0]), torch.float64, banded=True, device="cpu")
        sharded = ft.parallel.banded.ShardedBandedElasticity(model, mesh, "x")
        u = torch.as_tensor(np.random.default_rng(21).uniform(-0.02, 0.02, model.space.num_dofs)) * model.free_mask
        assert rel_err(model.residual(u), sharded.residual(u)) <= 1e-12
        with pytest.raises(KeyError):  # the mesh has no dimension "dp"
            ft.parallel.banded.ShardedBandedElasticity(model, mesh)
    finally:
        dist.destroy_process_group()
