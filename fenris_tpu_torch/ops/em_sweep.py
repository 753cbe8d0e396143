"""Fused element sweeps (internal forces, Hessian action): wrappers and plain versions.

Counterpart of ``fenris_tpu/ops/em_sweep.py``.  Two functions carry the
element math of the matrix-free banded path, in the element-minor layouts
of :mod:`..assembly.local_em` (``X_em [m, d, E]``, ``u_em``/``v_em``
``[n, s, E]``, output ``[n, s, E]``):

* :func:`em_vector_sweep` — element internal-force vectors (replaces the
  TPU kernel ``em_vector_sweep``);
* :func:`em_vector_tangent_sweep` — element Hessian actions with the
  closed-form tangent stress (replaces ``em_vector_tangent_sweep``).

On a CUDA tensor each wrapper launches the hand-written kernel
(``csrc/em_sweep.cu``) when :func:`supports` holds and raises otherwise;
on a CPU tensor it runs the plain version
(:func:`~..assembly.local_em.assemble_element_elliptic_vectors_em` and
:func:`~..assembly.local_em.assemble_element_elliptic_tangent_vectors_em`).
The kernel takes views with any strides, so the element-major rows of the
banded gather (``rows.permute(1, 2, 0)``) need no transposing copy; its
output has the strides of ``u_em``.  Launches are counted in
``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..assembly.local import Tabulation
from ..assembly.local_em import (
    assemble_element_elliptic_tangent_vectors_em,
    assemble_element_elliptic_vectors_em,
)
from ..solid import MaterialEllipticOperator, NeoHookeanMaterial
from ._build import check, load_library

__all__ = ["device_tables", "em_vector_sweep", "em_vector_tangent_sweep", "supports"]


def _lame_scalars(params):
    """``(mu, lam)`` as Python floats, or None unless ``params`` is a scalar Lamé pair."""
    try:
        mu, lam = params.mu, params.lam
    except AttributeError:
        return None
    vals = []
    for x in (mu, lam):
        if isinstance(x, (torch.Tensor, np.ndarray)):
            if x.ndim != 0:
                return None
            x = x.item()
        if not isinstance(x, (int, float)):
            return None
        vals.append(float(x))
    return tuple(vals)


def supports(op, params, tab: Tabulation, dtype) -> bool:
    """Whether the kernels take these inputs: f32, a Neo-Hookean material
    operator with scalar Lamé parameters, d = s = 3, and hex8 (8 geometry
    and 8 solution nodes)."""
    return (
        dtype == torch.float32
        and isinstance(op, MaterialEllipticOperator)
        and type(op.material) is NeoHookeanMaterial
        and op.dim == 3
        and op.solution_dim == 3
        and tab.geo_dphi.shape[1:] == (8, 3)
        and tab.dphi.shape[1:] == (8, 3)
        and _lame_scalars(params) is not None
    )


def device_tables(tab: Tabulation, device) -> torch.Tensor:
    """``geo_dphi``, ``dphi`` and the weights as one f32 array on ``device``: the kernels' tables.

    A model uploads them once and passes them to the wrappers.
    """
    flat = np.concatenate([np.ravel(tab.geo_dphi), np.ravel(tab.dphi), np.ravel(tab.weights)])
    return torch.as_tensor(flat.astype(np.float32), device=device)


def _check(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the element-sweep kernels are f32-only, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _launch(X_em, u_em, v_em, op, params, tab: Tabulation, tables):
    dev = X_em.device
    if dev.type != "cuda":
        raise ValueError(f"the element-sweep kernels run on CUDA or CPU tensors, not on {dev}")
    if not supports(op, params, tab, X_em.dtype):
        raise NotImplementedError(
            "the element-sweep kernels take f32 hex8 Neo-Hookean operators with scalar Lamé parameters"
        )
    E = X_em.shape[-1]
    _check(X_em, "X_em", (8, 3, E), dev)
    _check(u_em, "u_em", (8, 3, E), dev)
    if v_em is not None:
        _check(v_em, "v_em", (8, 3, E), dev)
    mu, lam = _lame_scalars(params)
    if tables is None:
        tables = device_tables(tab, dev)
    elif (tables.device, tables.dtype, tables.numel()) != (dev, torch.float32, tab.num_points * (2 * 8 * 3 + 1)):
        raise ValueError("tables: expected device_tables(tab, X_em.device)")
    out = torch.empty_like(u_em)  # dense inputs keep their strides
    strides = (ctypes.c_longlong * 12)(
        *X_em.stride(), *u_em.stride(), *(v_em if v_em is not None else u_em).stride(), *out.stride()
    )
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fenris_em_sweep(
            X_em.data_ptr(), u_em.data_ptr(), None if v_em is None else v_em.data_ptr(), out.data_ptr(),
            strides, E, tables.data_ptr(), tab.num_points, mu, lam, stream,
        )
    check(lib, code, "em_sweep")
    return out


def em_vector_sweep(X_em, u_em, op, params, tab: Tabulation, tables=None):
    """``[m, d, E]``, ``[n, s, E]`` -> element internal forces ``[n, s, E]``.

    ``tables``: :func:`device_tables` of ``tab`` on the card (uploaded per
    call when None).
    """
    if X_em.device.type == "cpu" and u_em.device.type == "cpu":
        return assemble_element_elliptic_vectors_em(X_em, u_em, op, params, tab)
    out = _launch(X_em, u_em, None, op, params, tab, tables)
    em_vector_sweep.launches += 1
    return out


def em_vector_tangent_sweep(X_em, u_em, v_em, op, params, tab: Tabulation, tables=None):
    """Element Hessian actions ``(∂f_el/∂u)[v]``, ``[n, s, E]``, closed-form tangent; ``tables`` as
    in :func:`em_vector_sweep`."""
    if X_em.device.type == "cpu" and u_em.device.type == "cpu" and v_em.device.type == "cpu":
        return assemble_element_elliptic_tangent_vectors_em(X_em, u_em, v_em, op, params, tab)
    out = _launch(X_em, u_em, v_em, op, params, tab, tables)
    em_vector_tangent_sweep.launches += 1
    return out


em_vector_sweep.launches = 0
em_vector_tangent_sweep.launches = 0
