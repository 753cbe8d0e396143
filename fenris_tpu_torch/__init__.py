"""fenris_tpu_torch: the PyTorch/CUDA port of fenris_tpu.

The same finite element library as the JAX package ``fenris_tpu``, with the
same modules, names and call signatures: reference elements and quadrature,
meshes, batched local assembly, deterministic global assembly, sparse and
block-DIA solvers, hyperelastic materials, Newton solvers, multigrid,
interpolation, error estimation, geometry, sharding over
``torch.distributed`` and VTK/Gmsh I/O.  Every Pallas TPU kernel of the JAX
package has a hand-written CUDA counterpart for sm_90a (``csrc/``, built at
first use by ``ops/_build.py``), each with a plain PyTorch version that
CPU tensors take.

Quick start::

    import fenris_tpu_torch as ft

    mesh = ft.mesh.procedural.create_unit_square_uniform_quad_mesh_2d(32)
    result = ft.fem.solve_poisson(
        mesh,
        ft.quadrature.quadrilateral_gauss(2),
        ft.quadrature.quadrilateral_gauss(6),
        source=lambda x, p: 1.0,
        dirichlet_nodes=mesh.find_boundary_vertices(),
        device="cpu",  # the default is the card
    )

Entry points run on the card unless the caller passes ``device="cpu"``.
The package imports ``torch`` and numpy only; importing it neither
initialises CUDA nor builds a kernel.  ``fenris_tpu`` is its reference.
"""

from . import (  # noqa: F401  (config turns TF32 off)
    assembly,
    config,
    elasticity,
    error,
    fem,
    geometry,
    integrate,
    io,
    mesh,
    operators,
    optimize,
    parallel,
    quadrature,
    solid,
    space,
    sparse,
)
from .mesh import Mesh
from .reference_elements import ELEMENTS, ReferenceElement, element
from .solid import LameParameters, NeoHookeanMaterial
from .structured import StructuredHyperelasticModel

__version__ = "0.1.0"

__all__ = [
    "Mesh",
    "ReferenceElement",
    "ELEMENTS",
    "element",
    "assembly",
    "config",
    "elasticity",
    "error",
    "fem",
    "geometry",
    "integrate",
    "io",
    "mesh",
    "operators",
    "optimize",
    "parallel",
    "quadrature",
    "solid",
    "space",
    "sparse",
    "StructuredHyperelasticModel",
    "LameParameters",
    "NeoHookeanMaterial",
]
