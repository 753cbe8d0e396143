"""The sharded classes of ``fenris_tpu_torch.parallel`` on small problems, for every rank of a gloo group.

Imports no JAX: ``tests/test_torch_parallel.py`` calls :func:`compute` in
its own process at world size 1 and starts :func:`main` in two spawned
processes at world size 2; the test compares both against the JAX
package's single-device models.  Inputs come as numpy arrays from the
parent (``inputs`` below); every output is a numpy array keyed by its
check's name, and the two ranks' outputs must agree.

Run alone:  python tests/torch_parallel_worker.py  (world size 2 against
world size 1, on the CPU).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from fenris_tpu_torch.elasticity import HyperelasticModel  # noqa: E402
from fenris_tpu_torch.mesh import procedural  # noqa: E402
from fenris_tpu_torch.parallel import ShardedElasticity, make_device_mesh  # noqa: E402
from fenris_tpu_torch.parallel.banded import ShardedBandedElasticity  # noqa: E402
from fenris_tpu_torch.parallel.block_dia import ShardedBlockDia  # noqa: E402
from fenris_tpu_torch.parallel.halo import StructuredHaloElasticity  # noqa: E402
from fenris_tpu_torch.parallel.structured import StructuredShardedElasticity  # noqa: E402
from fenris_tpu_torch.solid import LameParameters, NeoHookeanMaterial  # noqa: E402
from fenris_tpu_torch.sparse.cg import conjugate_gradient  # noqa: E402
from fenris_tpu_torch.structured import StructuredHyperelasticModel  # noqa: E402

F64 = torch.float64
#: the structured grids of tests/test_parallel_structured.py (halo: also fewer cell planes than ranks)
SHARDED_GRIDS = [(4, 3, 8), (4, 3, 5)]
HALO_GRIDS = SHARDED_GRIDS + [(3, 2, 1)]


# -- the problems (the JAX package's test problems, tests/test_parallel*.py) ----------------------


def hex_box(res=2):
    """tests/test_parallel.py's model: hex8 box, clamped at z = 0, Neo-Hookean, gravity -5."""
    mesh = procedural.create_unit_box_uniform_hex_mesh_3d(res)
    return mesh, np.flatnonzero(np.abs(mesh.points[:, 2]) < 1e-12)


def three_cells():
    """tests/test_parallel.py's padding case: 3 hex8 cells in a row, clamped at x = 0."""
    mesh = procedural.create_rectangular_uniform_hex_mesh(1.0, 3, 1, 1, 1)
    return mesh, np.flatnonzero(np.abs(mesh.points[:, 0]) < 1e-12)


def banded_mu(num_cells):
    """Per-element mu: 500 on the first half of the elements, 384 on the rest."""
    mu = np.full(num_cells, 384.0)
    mu[: num_cells // 2] = 500.0
    return mu


def structured_mask(cells):
    """Dirichlet mask of tests/test_parallel_structured.py: the z = 0 node plane clamped."""
    ncx, ncy, ncz = cells
    mask = np.zeros((ncz + 1) * (ncy + 1) * (ncx + 1) * 3, dtype=bool)
    mask[: (ncy + 1) * (ncx + 1) * 3] = True
    return mask


def grid_key(cells) -> str:
    """The inputs' key of a structured grid (both structured classes take the same inputs)."""
    return "G{}x{}x{}".format(*cells)


def port_structured(cells, device="cpu", dtype=F64):
    return StructuredHyperelasticModel(
        cells=cells, spacing=0.25, material=NeoHookeanMaterial(), params=LameParameters(mu=100.0, lam=200.0),
        dirichlet_mask=structured_mask(cells), body_force=np.array([0.0, 0.0, -4.0]), dtype=dtype, device=device,
    )


def port_models(device="cpu", dtype=F64):
    """The port's single-process models of every check, keyed by problem."""
    nh = NeoHookeanMaterial()
    mesh, fixed = hex_box()
    E = HyperelasticModel(mesh=mesh, material=nh, params=LameParameters(mu=100.0, lam=200.0), dirichlet_nodes=fixed,
                          body_force=np.array([0.0, 0.0, -5.0]), dtype=dtype, device=device)
    mesh3, fixed3 = three_cells()
    E3 = HyperelasticModel(mesh=mesh3, material=nh, params=LameParameters(mu=100.0, lam=200.0),
                           dirichlet_nodes=fixed3, dtype=dtype, device=device)
    box10 = procedural.create_unit_box_uniform_hex_mesh_3d(10)
    B = HyperelasticModel(mesh=box10, material=nh, params=LameParameters(mu=banded_mu(box10.num_cells), lam=577.0),
                          dirichlet_nodes=np.arange(121), body_force=np.array([0.0, 0.0, -2.0]), dtype=dtype,
                          device=device, banded=True, banded_r_nodes=1024, fused_kernels=True)
    D = HyperelasticModel(mesh=box10, material=nh, params=LameParameters(mu=384.0, lam=577.0),
                          dirichlet_nodes=np.flatnonzero(box10.points[:, 2] < 1e-12),
                          body_force=np.array([0.0, 0.0, -2.0]), dtype=dtype, device=device)
    return {"E": E, "E3": E3, "B": B, "D": D}


# -- the checks ---------------------------------------------------------------------------------


def _np(t):
    return t.detach().cpu().numpy()


def _refused(build, match) -> np.ndarray:
    """1.0 when ``build()`` raises ``ValueError`` whose message holds ``match``, else 0.0."""
    try:
        build()
    except ValueError as e:
        return np.float64(match in str(e))
    return np.float64(0.0)


def compute(mesh, inputs, device="cpu"):
    """Every sharded class's outputs on ``inputs`` (numpy), as a dict of numpy arrays."""
    t = lambda k: torch.as_tensor(inputs[k], device=device)  # noqa: E731
    models = port_models(device)
    out = {}

    E = ShardedElasticity(models["E"], mesh)
    u, v = t("E.u"), t("E.v")
    out["E.residual"] = _np(E.residual(u))
    out["E.hvp"] = _np(E.hessian_vector_product(u, v))
    out["E.diag"] = _np(E.hessian_diagonal(u))
    out["E.energy"] = _np(E.energy(u))
    out["E.solve"] = _np(E.solve(tolerance=1e-8).x)
    out["E.step"] = np.concatenate([_np(x).reshape(-1) for x in E.newton_step(torch.zeros_like(u))])
    out["E3.forces"] = _np(ShardedElasticity(models["E3"], mesh).internal_forces(t("E3.u")))

    B = ShardedBandedElasticity(models["B"], mesh)
    u, v = t("B.u"), t("B.v")
    out["B.residual"] = _np(B.residual(u))
    out["B.hvp"] = _np(B.hessian_vector_product(u, v))
    out["B.solve"] = _np(B.solve(tolerance=1e-9, max_newton_iterations=8).x)
    if mesh.size() == 1:
        # the single models' solves, the references of the sharded ones
        out["E.solve_single"] = _np(models["E"].solve(tolerance=1e-8).x)
        out["S.solve_single"] = _np(port_structured((4, 3, 8), device).solve(tolerance=1e-8, cg_rel_tolerance=1e-8).x)

    for cells in SHARDED_GRIDS:
        key = "S{}x{}x{}".format(*cells)
        S = StructuredShardedElasticity(port_structured(cells, device), mesh)
        u, v = t(grid_key(cells) + ".u"), t(grid_key(cells) + ".v")
        out[key + ".forces"] = _np(S.internal_forces(u))
        out[key + ".residual"] = _np(S.residual(u))
        out[key + ".hvp"] = _np(S.hessian_vector_product(u, v))
        out[key + ".diag"] = _np(S.hessian_diagonal(u))
    S = StructuredShardedElasticity(port_structured((4, 3, 8), device), mesh)
    out["S.solve"] = _np(S.solve(tolerance=1e-8, cg_rel_tolerance=1e-8).x)
    out["S.step"] = np.concatenate([_np(x).reshape(-1) for x in S.newton_step(torch.zeros(S.num_dofs, dtype=F64))])

    for cells in HALO_GRIDS:
        key = "H{}x{}x{}".format(*cells)
        H = StructuredHaloElasticity(port_structured(cells, device), mesh)
        ug, vg = H.to_grid(t(grid_key(cells) + ".u")), H.to_grid(t(grid_key(cells) + ".v"))
        out[key + ".forces"] = _np(H.to_flat(H.internal_forces(ug)))
        out[key + ".residual"] = _np(H.to_flat(H.residual(ug)))
        out[key + ".hvp"] = _np(H.to_flat(H.hessian_vector_product(ug, vg)))
        out[key + ".diag"] = _np(H.to_flat(H.hessian_diagonal(ug)))
    H = StructuredHaloElasticity(port_structured((4, 3, 8), device), mesh)
    out["H.solve"] = _np(H.to_flat(H.solve(tolerance=1e-8, cg_rel_tolerance=1e-8).x))
    step, norm = H.newton_step(H.zeros())
    out["H.step"] = np.concatenate([_np(H.to_flat(step)), _np(norm).reshape(-1)])

    Dm = models["D"]
    A = Dm.assemble_hessian_block_dia(t("D.u"))
    D = ShardedBlockDia(A, mesh)
    out["D.matvec"] = _np(D.to_flat(D @ D.to_sharded(t("D.v"))))
    out["D.matvec_single"] = _np(A @ t("D.v"))
    free = D.to_sharded(Dm.free_mask)
    b = torch.where(Dm.free_mask, t("D.b"), 0.0)
    res = D.cg(D.to_sharded(b), free_blocks=free, rel_tolerance=1e-10, max_iter=2000, check_definiteness=False)
    out["D.cg"] = _np(D.to_flat(res.x))
    out["D.cg_status"] = np.float64(res.status)
    # restarted from its own solution (to 1e-10) with a tolerance of 1e-9, CG stops at once
    again = D.cg(D.to_sharded(b), free_blocks=free, x0=res.x, rel_tolerance=1e-9, max_iter=2000,
                 check_definiteness=False)
    out["D.cg_restart"] = np.array([again.num_iterations, np.abs(_np(D.to_flat(again.x - res.x))).max()])
    if mesh.size() == 1:
        hvp, inv_diag = Dm.assembled_hessian_operator(t("D.u"))
        out["D.cg_single"] = _np(conjugate_gradient(hvp, b, preconditioner=lambda x: inv_diag * x, rel_tolerance=1e-10,
                                                    max_iter=2000, check_definiteness=False).x)
    mesh3 = procedural.create_unit_box_uniform_hex_mesh_3d(3)
    D3 = HyperelasticModel(mesh=mesh3, material=NeoHookeanMaterial(), params=LameParameters(mu=384.0, lam=577.0),
                           dtype=F64, device=device)
    zero3 = torch.zeros(D3.space.num_dofs, dtype=F64, device=device)
    A_rem = D3.assemble_hessian_block_dia(zero3, max_diagonals=7)
    out["D.refuses_remainder"] = _refused(lambda: ShardedBlockDia(A_rem, mesh), "remainder")
    if mesh.size() >= 2:
        # one hex8: 8 nodes / 2 ranks = 4-node chunks < the 7-node halo
        mesh1 = procedural.create_unit_box_uniform_hex_mesh_3d(1)
        D1 = HyperelasticModel(mesh=mesh1, material=NeoHookeanMaterial(), params=LameParameters(mu=384.0, lam=577.0),
                               dtype=F64, device=device)
        A1 = D1.assemble_hessian_block_dia(torch.zeros(D1.space.num_dofs, dtype=F64, device=device))
        out["D.refuses_halo"] = _refused(lambda: ShardedBlockDia(A1, mesh), "halo")
    return out


def inputs_for(seed=1234):
    """The numpy inputs of every check (random displacements of 1% strain and directions)."""
    rng = np.random.default_rng(seed)
    models = port_models()
    inputs = {}
    for key, m in (("E", models["E"]), ("E3", models["E3"]), ("B", models["B"]), ("D", models["D"])):
        free = m.free_mask.numpy()
        inputs[key + ".u"] = rng.uniform(-0.01, 0.01, m.space.num_dofs) * free
        inputs[key + ".v"] = rng.standard_normal(m.space.num_dofs)
    inputs["D.b"] = rng.standard_normal(models["D"].space.num_dofs)
    for cells in HALO_GRIDS:
        m = port_structured(cells)
        key = grid_key(cells)
        inputs[key + ".u"] = rng.uniform(-0.01, 0.01, m.num_dofs) * m.free_mask.numpy()
        inputs[key + ".v"] = rng.standard_normal(m.num_dofs)
    return inputs


def main(rank: int, world: int, store: str, inputs_path: str, out_path: str) -> None:
    """One rank: join the gloo group at ``file://store``, run :func:`compute`, write ``out_path.<rank>.npz``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        mesh = make_device_mesh(device_type="cpu")
        with np.load(inputs_path) as f:
            inputs = dict(f)
        np.savez(f"{out_path}.{rank}.npz", **compute(mesh, inputs))
    finally:
        dist.destroy_process_group()


def spawn(world: int, tmp: Path, inputs: dict):
    """Start ``world`` ranks of :func:`main` (``torch.multiprocessing``, spawn); returns the context to join
    and the path prefix of their outputs."""
    import torch.multiprocessing as mp

    np.savez(tmp / "inputs.npz", **inputs)
    out = tmp / "outputs"
    ctx = mp.start_processes(main, args=(world, str(tmp / "store"), str(tmp / "inputs.npz"), str(out)),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, out


if __name__ == "__main__":
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        inputs = inputs_for()
        ctx, out = spawn(2, tmp, inputs)
        while not ctx.join(timeout=300):
            pass
        dist.init_process_group("gloo", init_method=f"file://{tmp / 'store1'}", rank=0, world_size=1)
        ref = compute(make_device_mesh(device_type="cpu"), inputs)
        dist.destroy_process_group()
        with np.load(f"{out}.0.npz") as f0, np.load(f"{out}.1.npz") as f1:
            for k in f0.files:
                same = np.array_equal(f0[k], f1[k])
                err = np.abs(f0[k] - ref[k]).max() / max(np.abs(ref[k]).max(), 1e-300) if k in ref else float("nan")
                print(f"{k:24s} ranks equal: {same}  |2 ranks - 1 rank| / |1 rank| = {err:.3e}")
