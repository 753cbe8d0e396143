"""fenris_tpu_torch — the PyTorch/CUDA port of fenris_tpu.

This package holds the structured Neo-Hookean Newton–Krylov slice: hex8
tabulation, materials, the structured stencil model with its two
hand-written CUDA kernels (residual and Hessian action), CG, Newton and
the structured multigrid preconditioner.  It imports ``torch`` and numpy
only; the JAX package ``fenris_tpu`` is its reference.
"""

from . import config  # noqa: F401  (turns TF32 off)
from .solid import LameParameters, NeoHookeanMaterial
from .structured import StructuredHyperelasticModel

__all__ = ["StructuredHyperelasticModel", "LameParameters", "NeoHookeanMaterial"]
