"""Element-level and global assembly."""

from .global_ import assemble_vector, element_dof_indices
from .local import Tabulation, tabulate

__all__ = ["Tabulation", "tabulate", "assemble_vector", "element_dof_indices"]
