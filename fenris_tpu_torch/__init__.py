"""fenris_tpu_torch — the PyTorch/CUDA port of fenris_tpu.

Quick start::

    from fenris_tpu_torch import fem, quadrature
    from fenris_tpu_torch.mesh.procedural import create_unit_square_uniform_quad_mesh_2d

    mesh = create_unit_square_uniform_quad_mesh_2d(32)
    result = fem.solve_poisson(
        mesh,
        quadrature.quadrilateral_gauss(2),
        quadrature.quadrilateral_gauss(6),
        source=lambda x, p: 1.0,
        dirichlet_nodes=mesh.find_boundary_vertices(),
        device="cpu",  # the default is the card
    )

This package holds the slices of the port so far: the structured Neo-Hookean
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
``fem.solve_poisson`` and the stiffness kernel at d = 2, and the slice of
mesh topology (boundary faces, cells and vertices, ``boundary_mesh``,
``keep_cells``, ``extract_surface_mesh``, vertex transforms; face
elements in ``reference_elements``), surface loads and mass matrices
(``assembly.local``, the non-square ``integrate.volume_form``),
tri3/quad4/tet4 refinement with the unstructured multigrid on those
elements, the nonlinear MMS (``solid.mms``), the SDF meshes of
``mesh.procedural`` and the small API gaps (``operators.operator_from_energy``,
the F-based material wrappers, the finite-difference approximations of
``optimize``, ``StructuredHyperelasticModel.internal_forces``/``to_mesh``), and the slice of
point location and I/O: ``space`` (inverse mapping, closest points, ``GridIndex``,
``find_closest_element``, interpolation, ``FixedInterpolator``), ``ReferenceElement.phi``/``dphi``
on tensors, ``assembly.quadrature_table`` and ``assembly.aggregate`` (mixed-element CSR),
``io`` (Gmsh MSH 4.1, VTU, checkpoints in the JAX package's layout), ``containers.NestedArray``,
``sparse.block_dia.block_dia_from_csr``/``sparse.block_ell.block_ell_from_csr``,
``EllipticOperator.has_energy`` and the Gauss-Lobatto, prism and pyramid rules, and the last slice:
``geometry`` (host numpy, with ``mesh.procedural.create_simple_stupid_sphere``), the rotation, polar and
eigenvalue helpers of ``utils``, ``profiling`` and the sharded classes of ``parallel`` on
``torch.distributed``.  Entry points run
on the card unless the caller passes ``device="cpu"``.  It imports ``torch``
and numpy only; the JAX package ``fenris_tpu`` is its reference.
"""

from . import config  # noqa: F401  (turns TF32 off)
from .solid import LameParameters, NeoHookeanMaterial
from .structured import StructuredHyperelasticModel

__all__ = ["StructuredHyperelasticModel", "LameParameters", "NeoHookeanMaterial"]
