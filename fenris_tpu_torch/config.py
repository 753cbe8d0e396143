"""Global configuration for the PyTorch/CUDA port.

Counterpart of ``fenris_tpu/config.py``.  The port runs in the same two
precision regimes:

* **f64** — parity with the JAX reference; used by the CPU parity tests
  and by ``solve_mixed``'s outer residual;
* **f32** — the speed regime on the GPU, where the structured
  Neo-Hookean stencil kernels run.

Library code never picks a dtype or a device silently: callers pass both,
and :func:`resolve_device` refuses a CUDA request on a machine without a
card instead of falling back to the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["DEFAULT_DTYPE", "resolve_device"]

#: dtype of a model built without an explicit ``dtype`` (the speed regime)
DEFAULT_DTYPE = torch.float32

# FEM contractions must run in full f32, as the JAX package pins
# ``MATMUL_PRECISION = HIGHEST``: TF32 keeps ~3 decimal digits, which
# breaks CG's recursive residual and the line search.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
