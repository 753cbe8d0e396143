"""Hand-written GPU kernels of the port, with their plain PyTorch versions."""

from .structured_stencil import neo_hookean_hvp, neo_hookean_residual

__all__ = ["neo_hookean_residual", "neo_hookean_hvp"]
