"""3D Neo-Hookean cantilever under gravity, on the PyTorch/CUDA port.

The port's counterpart of examples/hyperelastic_cantilever.py: a 2x1x1
hex8 beam clamped at x = 0 (the boundary vertices on that face, found with
``Mesh.find_boundary_vertices``), loaded by gravity (0, 0, -100), E = 5e3,
nu = 0.4, solved by the matrix-free Newton-Krylov solve (exact Hessian
actions, Jacobi-preconditioned CG, Armijo line search) to 1e-4 of the
initial residual, in at most ``MAX_NEWTON_ITERATIONS`` steps (200; the
JAX example's 40 is too few at resolution 32).  In f64 (``--cpu``) that
is ``model.solve``, as in examples/hyperelastic_cantilever.py; in f32
(the card) it is ``model.solve_mixed``, whose outer residual is f64 (so
the fused vector sweep does not run): on fine meshes the f32
residual has a floor above 1e-4 of the initial one (1.4e-3 at resolution
32), which examples/hyperelastic_cantilever.py's note on the f32 floor
points to.  ``--banded`` RCM-reorders the mesh and runs the fused
element-sweep kernels through the banded layout.  It prints the cells,
dofs, Newton steps and the tip deflection, forms the deformed mesh with
``Mesh.transform_points`` and, given an output directory, writes it with
its ``displacement`` to ``cantilever.vtu`` there, as
examples/hyperelastic_cantilever.py does (the command line writes to
data/examples unless given ``--out DIR``).

Run:  python examples/hyperelastic_cantilever_torch.py [resolution] [--banded] [--cpu] [--out DIR]
      (f32 on the card by default; --cpu runs in f64 on the CPU)
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fenris_tpu_torch.config import resolve_device  # noqa: E402
from fenris_tpu_torch.elasticity import HyperelasticModel  # noqa: E402
from fenris_tpu_torch.io import FiniteElementMeshDataSetBuilder  # noqa: E402
from fenris_tpu_torch.mesh.procedural import create_rectangular_uniform_hex_mesh  # noqa: E402
from fenris_tpu_torch.mesh.reorder import reorder_mesh  # noqa: E402
from fenris_tpu_torch.solid import NeoHookeanMaterial, lame_from_young_poisson  # noqa: E402


#: Newton's cap.  examples/hyperelastic_cantilever.py caps at 40.  The line search damps the steps from the
#: unloaded beam and their number grows with the resolution (7, 16 and 26 at resolutions 1, 2 and 4 in f64 on
#: the CPU, 79 at resolution 32 in f32 on an H100), so 40 stops resolution 32 short of the tolerance.
MAX_NEWTON_ITERATIONS = 200


def main(resolution: int = 8, banded: bool = False, device="cuda", dtype=torch.float32, out_dir=None):
    """Solve the cantilever; returns ``(result, u [num_vertices, 3] in the beam's own node order, tip index)``.

    With ``out_dir``, the deformed mesh and its displacement go to ``out_dir/cantilever.vtu``.
    """
    device = resolve_device(device)
    beam = create_rectangular_uniform_hex_mesh(1.0, 2, 1, 1, resolution)
    mesh, perm = reorder_mesh(beam, device=device) if banded else (beam, None)
    boundary = mesh.find_boundary_vertices()
    clamped = boundary[np.abs(mesh.points[boundary, 0]) < 1e-12]
    model = HyperelasticModel(
        mesh=mesh,
        material=NeoHookeanMaterial(),
        params=lame_from_young_poisson(young=5e3, poisson=0.4),
        dirichlet_nodes=clamped,
        body_force=lambda x, p: torch.tensor([0.0, 0.0, -100.0], dtype=x.dtype, device=x.device),
        dtype=dtype,
        device=device,
        banded=banded,
        fused_kernels=banded,
    )
    print(f"cells: {mesh.num_cells}, dofs: {model.space.num_dofs}")

    t0 = time.perf_counter()
    if dtype == torch.float64:
        f0 = float(torch.linalg.vector_norm(model.residual(torch.zeros(model.space.num_dofs, dtype=dtype,
                                                                       device=device))))
        res = model.solve(tolerance=1e-4 * f0, max_newton_iterations=MAX_NEWTON_ITERATIONS)
    else:  # its tolerance is relative to the initial residual
        res = model.solve_mixed(tolerance=1e-4, max_newton_iterations=MAX_NEWTON_ITERATIONS)
    print(f"Newton: {res.iterations} iterations, status {res.status}, residual {float(res.residual_norm):.3e}, "
          f"{time.perf_counter() - t0:.1f}s")
    u = res.x.detach().cpu().double().numpy().reshape(-1, 3)
    if perm is not None:  # back to the beam's node order
        u_beam = np.empty_like(u)
        u_beam[perm] = u
        u = u_beam
    tip = int(np.argmax(beam.points[:, 0]))
    print(f"tip deflection: {u[tip]}")
    deformed = beam.transform_points(lambda p: p + u)
    print(f"deformed: {deformed}, tip at {deformed.points[tip]}")
    if out_dir is not None:
        path = Path(out_dir) / "cantilever.vtu"
        (
            FiniteElementMeshDataSetBuilder.from_mesh(deformed)
            .with_title("Neo-Hookean cantilever")
            .with_point_vector_attributes("displacement", u)
            .try_export(path)
        )
        print(f"wrote {path}")
    return res, u, tip


def _cli():
    argv = sys.argv[1:]
    out = "data/examples"
    if "--out" in argv:
        i = argv.index("--out")
        out = argv[i + 1]
        del argv[i : i + 2]
    args = [a for a in argv if not a.startswith("--")]
    cpu = "--cpu" in argv
    main(int(args[0]) if args else 8, banded="--banded" in argv, device="cpu" if cpu else "cuda",
         dtype=torch.float64 if cpu else torch.float32, out_dir=out)


if __name__ == "__main__":
    _cli()
