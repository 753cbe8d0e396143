"""Hand-written GPU kernels of the port, with their plain PyTorch versions.

Modules: :mod:`.structured_stencil` (Neo-Hookean residual and Hessian
action on structured grids), :mod:`.dia_sweep` (block-DIA band sweep) and
:mod:`.stiffness_pairs` (constant-contraction element stiffness).
"""

from .structured_stencil import neo_hookean_hvp, neo_hookean_residual

__all__ = ["neo_hookean_residual", "neo_hookean_hvp"]
