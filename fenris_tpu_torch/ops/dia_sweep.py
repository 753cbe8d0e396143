"""Block-DIA band sweep (the assembled-CG SpMV): wrapper and plain version.

Counterpart of the band-sweep kernels of ``fenris_tpu/sparse/dia_kernel.py``
(``packed_dia_matvec_wm`` and its staged fallback ``packed_dia_matvec_cm``):
the component-major product

    y2[i, n] = sum_d sum_j bands[(d*s + i)*s + j, n] * x2[j, n + offsets[d]]

with ``x2`` read as zero outside ``[0, N)``, on the band stack
``[D*s*s, N]`` exactly as :func:`~..sparse.block_dia.assemble_block_dia`
lays it out.  On a CUDA tensor :func:`dia_sweep` launches the hand-written
kernel (``csrc/dia_sweep.cu``; f32, contiguous, s in {1, 2, 3}) or raises;
on a CPU tensor it runs :func:`dia_sweep_plain`.  Launches are counted in
``dia_sweep.launches``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ._build import check, load_library

__all__ = ["dia_sweep", "dia_sweep_plain"]


def dia_sweep_plain(bands: torch.Tensor, offsets: Sequence[int], x2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch band sweep: D*s*s full-length multiply-adds over shifted x slices.

    The sum per output runs over d, then j (the JAX package's
    ``block_dia_matvec_cm`` order).
    """
    s, N = x2.shape
    if not offsets:
        return torch.zeros_like(x2)
    lo = max(0, -min(offsets))
    hi = max(0, max(offsets))
    xp = F.pad(x2, (lo, hi))
    y = [x2.new_zeros(N) for _ in range(s)]
    for d, o in enumerate(offsets):
        for j in range(s):
            xs = xp[j, lo + o : lo + o + N]
            for i in range(s):
                y[i] = y[i] + bands[(d * s + i) * s + j] * xs
    return torch.stack(y, 0)


_offset_cache: dict = {}


def _device_offsets(offsets: Sequence[int], device: torch.device) -> torch.Tensor:
    """The offsets as an int32 device array, uploaded once per (offsets, device)."""
    key = (tuple(int(o) for o in offsets), device)
    t = _offset_cache.get(key)
    if t is None:
        if len(_offset_cache) > 64:
            _offset_cache.clear()
        t = _offset_cache[key] = torch.tensor(key[0], dtype=torch.int32, device=device)
    return t


def _check(bands: torch.Tensor, offsets, x2: torch.Tensor) -> None:
    for name, t in (("bands", bands), ("x2", x2)):
        if t.device.type != "cuda":
            raise ValueError(f"dia_sweep: {name} must be a CUDA or CPU tensor, not on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"dia_sweep: the kernel is f32-only, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"dia_sweep: {name} must be contiguous")
    if bands.device != x2.device:
        raise ValueError("dia_sweep: bands and x2 must be on the same device")
    if x2.dim() != 2 or not 1 <= x2.shape[0] <= 3:
        raise ValueError(f"dia_sweep: x2 must be [s, N] with s in 1..3, got {tuple(x2.shape)}")
    s, N = x2.shape
    if tuple(bands.shape) != (len(offsets) * s * s, N):
        raise ValueError(f"dia_sweep: bands must be [{len(offsets) * s * s}, {N}], got {tuple(bands.shape)}")


def dia_sweep(bands: torch.Tensor, offsets: Sequence[int], x2: torch.Tensor) -> torch.Tensor:
    """Component-major block-DIA product ``y2 [s, N]`` (see the module notes)."""
    if bands.device.type == "cpu" and x2.device.type == "cpu":
        return dia_sweep_plain(bands, offsets, x2)
    _check(bands, offsets, x2)
    s, N = x2.shape
    lib = load_library()
    offs = _device_offsets(offsets, x2.device)
    y = torch.empty_like(x2)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fenris_dia_sweep(
            bands.data_ptr(), offs.data_ptr(), len(offsets), x2.data_ptr(), y.data_ptr(), N, s, stream
        )
    check(lib, code, "dia_sweep")
    dia_sweep.launches += 1
    return y


dia_sweep.launches = 0
