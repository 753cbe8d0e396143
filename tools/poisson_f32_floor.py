#!/usr/bin/env python3
"""The f32 floor of a Poisson solution on the MMS problem, on the CPU.

For each resolution, solves the MMS problem of ``chip_smoke.py`` with
``fem.solve_poisson_assembled`` in f32 (CG tolerance 1e-5) and in f64, and
prints the f32 solve's CG iterations, its true relative residual
``|b - A u| / |b|`` by the plain f64 operator, and the relative deviation
of its L² error from the f64 one.  The residual floor grows like 1/h²
(the f32 rounding of u through A), which is what sets the f32 CG
tolerances ``chip_smoke.py`` uses at P149.

Run from the root of a checkout:  python3 tools/poisson_f32_floor.py [RES ...]   (default 4 8 32 64)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from fenris_tpu_torch import fem  # noqa: E402
from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d  # noqa: E402
from fenris_tpu_torch.quadrature import hexahedron_gauss  # noqa: E402


def main(resolutions):
    source, u_exact, u_exact_grad, dirichlet = cs.mms_problem()
    for res in resolutions:
        mesh = create_unit_box_uniform_hex_mesh_3d(res)
        nd = dirichlet(mesh)
        args = (mesh, hexahedron_gauss(2), hexahedron_gauss(6), source, u_exact, u_exact_grad, nd)
        r32 = fem.solve_poisson_assembled(*args, rel_tolerance=1e-5, dtype=torch.float32, device="cpu")
        r64 = fem.solve_poisson_assembled(*args, rel_tolerance=1e-12, dtype=torch.float64, device="cpu")
        residual, b = cs.poisson_f64_operator(mesh, nd, "cpu")
        rel = float(torch.linalg.vector_norm(residual(r32.u)) / torch.linalg.vector_norm(b))
        print(f"res {res}: f32 CG iterations {r32.cg_iterations}, true relative residual {rel:.3e}, "
              f"L2 error deviation from f64 {abs(r32.l2_error / r64.l2_error - 1):.3e}", flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [4, 8, 32, 64])
