"""Element-level and global assembly."""

from . import global_ as global_assembly
from . import local
from .global_ import (
    CsrPattern,
    apply_homogeneous_dirichlet_bc_csr,
    apply_homogeneous_dirichlet_bc_rhs,
    assemble_csr,
    assemble_scalar,
    assemble_vector,
    csr_pattern,
    element_dof_indices,
)
from .local import (
    Tabulation,
    assemble_element_elliptic_matrices,
    assemble_element_elliptic_vectors,
    assemble_element_mass_matrices,
    assemble_element_source_vectors,
    compute_element_elliptic_energy,
    tabulate,
)

__all__ = [
    "global_assembly",
    "local",
    "Tabulation",
    "tabulate",
    "assemble_element_elliptic_matrices",
    "assemble_element_elliptic_vectors",
    "assemble_element_mass_matrices",
    "assemble_element_source_vectors",
    "compute_element_elliptic_energy",
    "CsrPattern",
    "csr_pattern",
    "assemble_csr",
    "assemble_scalar",
    "assemble_vector",
    "element_dof_indices",
    "apply_homogeneous_dirichlet_bc_csr",
    "apply_homogeneous_dirichlet_bc_rhs",
]
