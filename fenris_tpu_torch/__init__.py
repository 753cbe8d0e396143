"""fenris_tpu_torch — the PyTorch/CUDA port of fenris_tpu.

This package holds six slices of the port: the structured Neo-Hookean
Newton–Krylov solve (stencil kernels, structured multigrid), the assembled
block-DIA solve on unstructured hex8 meshes (band sweep and stiffness
kernels), the matrix-free banded solve (banded gather/scatter and fused
element-sweep kernels), with CG and Newton, and Poisson on hex8 (both
CSR-free routes of ``fem``, with ``integrate`` and ``error``) with the
unstructured geometric multigrid over a refinement hierarchy
(``mesh.refinement``, ``multigrid.GeometricMGPreconditioner``), and the 3D
higher-order elements (``reference_elements``, ``quadrature``,
``mesh.convert``: tet4/10/20, hex20/27) on the Poisson routes and the
stiffness kernel, and the 2D slice: quad and tri meshes, CSR assembly
(``assembly.global_``, ``sparse.csr``), the CSR Poisson route
``fem.solve_poisson`` and the stiffness kernel at d = 2.  Entry points run on
the card unless the caller passes ``device="cpu"``.  It imports ``torch``
and numpy only; the JAX package ``fenris_tpu`` is its reference.
"""

from . import config  # noqa: F401  (turns TF32 off)
from .solid import LameParameters, NeoHookeanMaterial
from .structured import StructuredHyperelasticModel

__all__ = ["StructuredHyperelasticModel", "LameParameters", "NeoHookeanMaterial"]
