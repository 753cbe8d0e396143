"""Block-DIA operators driven by the band-sweep kernel.

Counterpart of ``block_dia_operator`` in ``fenris_tpu/sparse/dia_kernel.py``
(:417).  The kernel itself is :func:`~..ops.dia_sweep.dia_sweep`; the TPU
packings (``PackedDia``, ``PackedDiaW``, ``pack_block_dia*``,
``_pick_lanes*``: 8-sublane padding, lane chunks, the VMEM halo window)
are TPU layout and have no counterpart: the kernel reads the band stack
as assembled.
"""

from __future__ import annotations

import torch

from ..ops.dia_sweep import dia_sweep
from .block_dia import BlockDiaMatrix, block_dia_matvec, block_dia_matvec_cm
from .block_ell import block_ell_matvec, block_ell_matvec_cm

__all__ = ["block_dia_operator", "kernel_applicable"]


def kernel_applicable(m: BlockDiaMatrix) -> bool:
    """The band-sweep kernel covers f32 CUDA bands with s in 1..3.

    The JAX gate (``_pallas_applicable``) without its TPU clauses (VMEM
    band-row budget, minimum lane count).
    """
    return m.bands.device.type == "cuda" and m.bands.dtype == torch.float32 and 1 <= m.solution_dim <= 3


def block_dia_operator(m: BlockDiaMatrix, *, kernel="auto", layout: str = "dof"):
    """A ``matvec`` closure for ``m``.

    ``kernel="auto"`` takes the band-sweep kernel where
    :func:`kernel_applicable` holds, else the plain matvec (f64 bands on
    the card take the plain path, as they take XLA in the JAX package);
    ``True`` always calls the kernel's wrapper, ``False`` never.  The
    block-ELL remainder is added after the sweep, in plain PyTorch.

    ``layout="component"``: ``[s, N]`` arrays in and out (what CG iterates
    on); ``layout="dof"``: node-major flat ``[N*s]`` vectors.
    """
    if layout not in ("dof", "component"):
        raise ValueError(f"unknown layout {layout!r}")
    use = kernel_applicable(m) if kernel == "auto" else bool(kernel)
    cm = layout == "component"
    if not use:
        return (lambda x2: block_dia_matvec_cm(m, x2)) if cm else (lambda v: block_dia_matvec(m, v))
    rem = m.remainder
    s, N = m.solution_dim, m.num_nodes

    def matvec_cm(x2):
        y2 = dia_sweep(m.bands, m.offsets, x2.contiguous())
        if rem is not None:
            y2 = y2 + block_ell_matvec_cm(rem, x2)
        return y2

    def matvec(v):
        y = dia_sweep(m.bands, m.offsets, v.reshape(N, s).T.contiguous()).T.reshape(-1)
        if rem is not None:
            y = y + block_ell_matvec(rem, v)
        return y

    return matvec_cm if cm else matvec
