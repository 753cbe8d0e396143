"""Hand-written GPU kernels of the port, with their plain PyTorch versions.

Modules: :mod:`.structured_stencil` (Neo-Hookean residual and Hessian
action on structured grids), :mod:`.dia_sweep` (block-DIA band sweep),
:mod:`.stiffness_pairs` (constant-contraction element stiffness),
:mod:`.banded` (banded gather and scatter of element data) and
:mod:`.em_sweep` (fused Neo-Hookean element sweeps).
"""

from .structured_stencil import neo_hookean_hvp, neo_hookean_residual

__all__ = ["neo_hookean_residual", "neo_hookean_hvp"]
