"""2D Poisson with bilinear quadrilaterals on the unit square, on the PyTorch/CUDA port.

The port's counterpart of examples/poisson2d.py (the reference's
examples/poisson2d.rs): manufactured solution u = sin(pi x) sin(pi y),
homogeneous Dirichlet boundary, Jacobi-preconditioned CG on the CSR
matrix (``fem.solve_poisson``) or, with ``--matrix-free``, on the banded
operator action (``fem.solve_poisson_matrix_free``).  It prints the dofs,
the CG iterations and the L² and H¹-seminorm errors.  The VTU export of
examples/poisson2d.py waits for the port's ``io`` package.

Run:  python examples/poisson2d_torch.py [resolution] [--matrix-free] [--cpu]
      (f32 on the card by default; --cpu runs in f64 on the CPU)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fenris_tpu_torch import fem, quadrature  # noqa: E402
from fenris_tpu_torch.mesh.procedural import create_unit_square_uniform_quad_mesh_2d  # noqa: E402

PI = np.pi


def u_exact(x):
    return torch.sin(PI * x[0]) * torch.sin(PI * x[1])


def u_exact_grad(x):
    return PI * torch.stack([torch.cos(PI * x[0]) * torch.sin(PI * x[1]), torch.sin(PI * x[0]) * torch.cos(PI * x[1])])


def main(resolution: int = 50, matrix_free: bool = False, device="cuda", dtype=torch.float32):
    mesh = create_unit_square_uniform_quad_mesh_2d(resolution)
    dirichlet = np.flatnonzero(np.abs(mesh.points - 0.5).max(axis=1) > 0.4999)
    solver = fem.solve_poisson_matrix_free if matrix_free else fem.solve_poisson
    result = solver(
        mesh,
        quadrature.quadrilateral_gauss(2),
        quadrature.quadrilateral_gauss(6),
        lambda x, p: 2.0 * PI * PI * u_exact(x),
        u_exact,
        u_exact_grad,
        dirichlet,
        dtype=dtype,
        device=device,
    )
    print(f"dofs:          {mesh.num_vertices}")
    print(f"CG iterations: {result.cg_iterations}")
    print(f"L2 error:      {result.l2_error:.6e}")
    print(f"H1 error:      {result.h1_seminorm_error:.6e}")
    return result


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    cpu = "--cpu" in sys.argv
    main(int(args[0]) if args else 50, matrix_free="--matrix-free" in sys.argv, device="cpu" if cpu else "cuda",
         dtype=torch.float64 if cpu else torch.float32)
