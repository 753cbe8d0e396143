"""Port parity: the sharded classes of ``fenris_tpu_torch.parallel`` at 1 and 2 ranks against JAX's single models.

The problems and tolerances are those of tests/test_parallel.py,
tests/test_parallel_structured.py and tests/test_parallel_block_dia.py,
whose sharded JAX classes are pinned there to the same single-device
models.  World size 1 runs in this process; world size 2 runs in two
processes started once for the file (``torch_parallel_worker``, which
imports no JAX), both over gloo with a file store.  The banded class is
held against JAX's unbanded model (a banded JAX model takes seconds to
trace).  Each check is its own case.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_parallel_worker as W

from fenris_tpu.elasticity import HyperelasticModel
from fenris_tpu.mesh import procedural
from fenris_tpu.solid import LameParameters, NeoHookeanMaterial
from fenris_tpu.structured import StructuredHyperelasticModel
from fenris_tpu_torch.parallel import _Comm

#: operator check -> max |port sharded - JAX single| allowed (the JAX tests' tolerances)
TOLERANCES = {
    "E.residual": 1e-12, "E.hvp": 1e-12, "E.diag": 1e-12, "E.energy": 1e-10,
    "E3.forces": 1e-12,
    "B.residual": 1e-12, "B.hvp": 1e-10,
    **{"{}{}x{}x{}.{}".format(prefix, *c, op): tol for prefix, grids in (("S", W.SHARDED_GRIDS), ("H", W.HALO_GRIDS))
       for c in grids for op, tol in (("forces", 1e-12), ("residual", 1e-12), ("hvp", 1e-11), ("diag", 1e-11))},
}
#: solve -> (Newton tolerance, max |x sharded - x of the 1-rank reference|, that reference): the single port
#: model's solve, or for the banded class (whose CPU solve takes seconds) its own 1-rank solve
SOLVES = {"E.solve": (1e-8, 1e-6, "E.solve_single"), "B.solve": (1e-9, 1e-6, "B.solve"),
          "S.solve": (1e-8, 1e-7, "S.solve_single"), "H.solve": (1e-8, 1e-7, "S.solve_single")}
REFUSALS = {1: ["D.refuses_remainder"], 2: ["D.refuses_remainder", "D.refuses_halo"]}


def _jax_structured(cells):
    return StructuredHyperelasticModel(
        cells=cells, spacing=0.25, material=NeoHookeanMaterial(), params=LameParameters(mu=100.0, lam=200.0),
        dirichlet_mask=W.structured_mask(cells), body_force=np.array([0.0, 0.0, -4.0]), dtype=jnp.float64,
    )


def _operators(m):
    """One jitted function of (u, v) giving the model's forces, residual, Hessian action and diagonal."""
    return jax.jit(lambda u, v: {"forces": m.internal_forces(u), "residual": m.residual(u),
                                 "hvp": m.hessian_vector_product(u, v), "diag": m.hessian_diagonal(u)})


def jax_references(inputs):
    """The JAX package's single-device values of every operator check, and its residual functions for the
    solves (jitted once a model: tracing, not the arithmetic, is the cost here)."""
    nh = NeoHookeanMaterial()
    j = lambda k: jnp.asarray(inputs[k])  # noqa: E731
    ref, residuals = {}, {}
    _, fixed = W.hex_box()
    E = HyperelasticModel(mesh=procedural.create_unit_box_uniform_hex_mesh_3d(2), material=nh,
                          params=LameParameters(mu=100.0, lam=200.0), dirichlet_nodes=fixed,
                          body_force=lambda x, p: jnp.array([0.0, 0.0, -5.0], dtype=x.dtype))
    got = jax.jit(lambda u, v: {"residual": E.residual(u), "hvp": E.hessian_vector_product(u, v),
                                "diag": E.hessian_diagonal(u), "energy": E.energy(u)})(j("E.u"), j("E.v"))
    ref.update({"E." + k: x for k, x in got.items()})
    residuals["E.solve"] = jax.jit(E.residual)
    _, fixed3 = W.three_cells()
    E3 = HyperelasticModel(mesh=procedural.create_rectangular_uniform_hex_mesh(1.0, 3, 1, 1, 1), material=nh,
                           params=LameParameters(mu=100.0, lam=200.0), dirichlet_nodes=fixed3)
    ref["E3.forces"] = jax.jit(E3.internal_forces)(j("E3.u"))

    box10 = procedural.create_unit_box_uniform_hex_mesh_3d(10)
    B = HyperelasticModel(mesh=box10, material=nh, params=LameParameters(mu=W.banded_mu(box10.num_cells), lam=577.0),
                          dirichlet_nodes=np.arange(121), body_force=lambda x, p: jnp.array([0.0, 0.0, -2.0]))
    got = jax.jit(lambda u, v: {"residual": B.residual(u), "hvp": B.hessian_vector_product(u, v)})(j("B.u"), j("B.v"))
    ref.update({"B." + k: x for k, x in got.items()})
    residuals["B.solve"] = jax.jit(B.residual)

    for cells in W.HALO_GRIDS:
        m = _jax_structured(cells)
        key = W.grid_key(cells)
        got = _operators(m)(j(key + ".u"), j(key + ".v"))
        for prefix, grids in (("S", W.SHARDED_GRIDS), ("H", W.HALO_GRIDS)):
            if cells in grids:
                ref.update({prefix + key[1:] + "." + k: x for k, x in got.items()})
        if cells == (4, 3, 8):
            residuals["S.solve"] = residuals["H.solve"] = jax.jit(m.residual)

    D = HyperelasticModel(mesh=box10, material=nh, params=LameParameters(mu=384.0, lam=577.0),
                          dirichlet_nodes=np.flatnonzero(box10.points[:, 2] < 1e-12),
                          body_force=lambda x, p: jnp.array([0.0, 0.0, -2.0]))
    # A v of the unconstrained tangent is the jvp of the internal forces; the CG's operator is the masked action
    ref["D.matvec"] = jax.jit(lambda u, v: jax.jvp(D.internal_forces, (u,), (v,))[1])(j("D.u"), j("D.v"))
    hvp = jax.jit(D.hessian_vector_product)
    residuals["D.cg"] = lambda x: hvp(j("D.u"), x) - jnp.where(D.free_mask, j("D.b"), 0.0)
    ref["D.b"] = jnp.where(D.free_mask, j("D.b"), 0.0)
    return {k: np.asarray(x) for k, x in ref.items()}, residuals


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(references, JAX residuals, {world size: outputs}, ranks_equal)``: the 2-rank run goes on while this
    process runs its own rank and the JAX references."""
    tmp = tmp_path_factory.mktemp("parallel")
    inputs = W.inputs_for()
    ctx, out = W.spawn(2, tmp, inputs)
    threads = torch.get_num_threads()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # JAX traces and compiles its references while this process runs its own rank
        jax_future = pool.submit(jax_references, inputs)
        try:
            # one thread, as each spawned rank: these problems are too small to share out
            torch.set_num_threads(1)
            dist.init_process_group("gloo", init_method=f"file://{tmp / 'store1'}", rank=0, world_size=1)
            try:
                one = W.compute(W.make_device_mesh(device_type="cpu"), inputs)
            finally:
                dist.destroy_process_group()
                torch.set_num_threads(threads)
            refs, residuals = jax_future.result()
        finally:
            for _ in range(30):
                if ctx.join(timeout=10):
                    break
            else:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError("the 2-rank run did not end within 300 s")
    with np.load(f"{out}.0.npz") as f0, np.load(f"{out}.1.npz") as f1:
        two = dict(f0)
        ranks_equal = {k: np.array_equal(f0[k], f1[k]) for k in f0.files}
    return refs, residuals, {1: one, 2: two}, ranks_equal


def _same_on_both_ranks(ranks_equal, world, check):
    if world == 2:
        assert ranks_equal[check], "the two ranks hold different replicated results"


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("check", sorted(TOLERANCES))
def test_sharded_matches_jax_single_model(runs, check, world):
    refs, _, outputs, ranks_equal = runs
    got, ref = outputs[world][check], refs[check]
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < TOLERANCES[check], np.abs(got - ref).max()
    _same_on_both_ranks(ranks_equal, world, check)


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("check", sorted(SOLVES))
def test_sharded_solve(runs, check, world):
    """The sharded Newton solve converges onto the JAX model's solution (its residual at x stays within twice
    the Newton tolerance) and equals the 1-rank reference of :data:`SOLVES`."""
    _, residuals, outputs, ranks_equal = runs
    tol, x_tol, single = SOLVES[check]
    x = outputs[world][check]
    assert np.linalg.norm(np.asarray(residuals[check](jnp.asarray(x)))) <= 2 * tol
    assert np.abs(x - outputs[1][single]).max() < x_tol
    _same_on_both_ranks(ranks_equal, world, check)


@pytest.mark.parametrize("world", [1, 2])
def test_sharded_block_dia_matvec(runs, world):
    """Against JAX's tangent action to the port's block-DIA parity tolerance, and against the single band
    matrix's product at tests/test_parallel_block_dia.py's rtol = atol = 1e-13."""
    refs, _, outputs, ranks_equal = runs
    got = outputs[world]["D.matvec"]
    assert np.linalg.norm(got - refs["D.matvec"]) <= 1e-12 * np.linalg.norm(refs["D.matvec"])
    np.testing.assert_allclose(got, outputs[1]["D.matvec_single"], rtol=1e-13, atol=1e-13)
    _same_on_both_ranks(ranks_equal, world, "D.matvec")


@pytest.mark.parametrize("world", [1, 2])
def test_sharded_block_dia_cg(runs, world):
    """Sharded Jacobi-PCG to 1e-10: converged, JAX's masked tangent leaves a relative residual below 1e-9, and
    the iterate is the single-process CG's to 1e-8."""
    refs, residuals, outputs, ranks_equal = runs
    x = outputs[world]["D.cg"]
    assert outputs[world]["D.cg_status"] == 0  # CG_CONVERGED
    r = np.asarray(residuals["D.cg"](jnp.asarray(x)))
    assert np.linalg.norm(r) <= 1e-9 * np.linalg.norm(refs["D.b"])
    assert np.abs(x - outputs[1]["D.cg_single"]).max() < 1e-8
    _same_on_both_ranks(ranks_equal, world, "D.cg")


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("check", ["E.step", "S.step", "H.step"])
def test_sharded_newton_step(runs, check, world):
    """One inexact Newton step from zero (the JAX tests' jitted step): finite, ``||F(0)||`` last, the 2-rank
    step the 1-rank one's to 1e-10."""
    _, _, outputs, ranks_equal = runs
    got = outputs[world][check]
    assert np.isfinite(got).all() and got[-1] > 0.0
    assert np.abs(got - outputs[1][check]).max() <= 1e-10 * np.abs(outputs[1][check]).max()
    _same_on_both_ranks(ranks_equal, world, check)


@pytest.mark.parametrize("world", [1, 2])
def test_sharded_cg_restarts_from_x0(runs, world):
    iterations, moved = runs[2][world]["D.cg_restart"]
    assert iterations == 0 and moved == 0.0


@pytest.mark.parametrize("world,check", [(w, c) for w, cs in REFUSALS.items() for c in cs])
def test_sharded_block_dia_refusals(runs, world, check):
    """A remainder (res 3, 7 diagonals) and, at 2 ranks, a halo wider than a chunk (one hex8: 4-node chunks,
    a 7-node halo) raise the JAX package's ``ValueError``s."""
    assert runs[2][world][check] == 1.0


def test_make_device_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        W.make_device_mesh(device_type="cpu")


def test_cuda_mesh_without_a_card_raises(tmp_path):
    """A CUDA mesh is refused on a machine without a card, and a mesh of another device type than the model's
    is refused by every sharded class: nothing falls back to the CPU."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="whole world"):
            W.make_device_mesh(num_devices=2, device_type="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                W.make_device_mesh()
        mesh = W.make_device_mesh(device_type="cpu")
        with pytest.raises(ValueError, match="device type 'cuda'"):
            _Comm(mesh, torch.device("cuda", 0))
    finally:
        dist.destroy_process_group()
