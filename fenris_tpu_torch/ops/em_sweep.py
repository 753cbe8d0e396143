"""Fused element sweeps (internal forces, Hessian action): wrappers and plain versions.

Counterpart of ``fenris_tpu/ops/em_sweep.py``.  Two functions carry the
element math of the matrix-free banded path, in the element-minor layouts
of :mod:`..assembly.local_em` (``X_em [m, d, E]``, ``u_em``/``v_em``
``[n, s, E]``, output ``[n, s, E]``):

* :func:`em_vector_sweep` — element internal-force vectors (replaces the
  TPU kernel ``em_vector_sweep``);
* :func:`em_vector_tangent_sweep` — element Hessian actions with the
  closed-form tangent stress (replaces ``em_vector_tangent_sweep``);
* :func:`banded_tangent_sweep` — the same Hessian actions fused with the
  banded gather: node vectors ``u``, ``v [N, 3]`` in, element-major rows
  ``[E_pad, 8, 3]`` out (the matrix-free CG operator of the fused model).

On a CUDA tensor each wrapper launches the hand-written kernel
(``csrc/em_sweep.cu``) when :func:`supports` holds and raises otherwise;
on a CPU tensor it runs the plain version
(:func:`~..assembly.local_em.assemble_element_elliptic_vectors_em`,
:func:`~..assembly.local_em.assemble_element_elliptic_tangent_vectors_em`,
:func:`banded_tangent_sweep_plain`).  The two element-minor wrappers take
views with any strides, so the element-major rows of the banded gather
(``rows.permute(1, 2, 0)``) need no transposing copy; their output has the
strides of ``u_em``.  :func:`em_vector_tangent_sweep` and
:func:`banded_tangent_sweep` run one kernel body.  Launches are counted in
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
from .banded import BandedPlan, banded_gather_plain, check_index_range

__all__ = [
    "banded_tangent_sweep",
    "banded_tangent_sweep_plain",
    "device_tables",
    "em_vector_sweep",
    "em_vector_tangent_sweep",
    "supports",
]


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


def _kernel_args(X, op, params, tab: Tabulation, tables):
    """``(mu, lam, tables)`` for a launch on geometry ``X``'s device; raises on what the kernels do not take."""
    dev = X.device
    if dev.type != "cuda":
        raise ValueError(f"the element-sweep kernels run on CUDA or CPU tensors, not on {dev}")
    if not supports(op, params, tab, X.dtype):
        raise NotImplementedError(
            "the element-sweep kernels take f32 hex8 Neo-Hookean operators with scalar Lamé parameters"
        )
    if tables is None:
        tables = device_tables(tab, dev)
    elif (tables.device, tables.dtype, tables.numel()) != (dev, torch.float32, tab.num_points * (2 * 8 * 3 + 1)):
        raise ValueError("tables: expected device_tables(tab, X_em.device)")
    return (*_lame_scalars(params), tables)


def _launch(X_em, u_em, v_em, op, params, tab: Tabulation, tables):
    dev = X_em.device
    mu, lam, tables = _kernel_args(X_em, op, params, tab, tables)
    E = X_em.shape[-1]
    _check(X_em, "X_em", (8, 3, E), dev)
    _check(u_em, "u_em", (8, 3, E), dev)
    if v_em is not None:
        _check(v_em, "v_em", (8, 3, E), dev)
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


def banded_tangent_sweep_plain(plan: BandedPlan, X_band, u, v, op, params, tab: Tabulation):
    """Plain PyTorch version of :func:`banded_tangent_sweep`: two plain gathers, the plain
    tangent sweep, element-major rows ``[E_pad, 8, 3]``."""
    u_em, v_em = (banded_gather_plain(plan, a).permute(1, 2, 0) for a in (u, v))
    f = assemble_element_elliptic_tangent_vectors_em(X_band, u_em, v_em, op, params, tab)
    return f.permute(2, 0, 1).contiguous()


def banded_tangent_sweep(plan: BandedPlan, X_band, u, v, op, params, tab: Tabulation, tables=None):
    """Element Hessian actions of node vectors ``u``, ``v [N, 3]`` on the banded layout.

    Returns element-major rows ``[E_pad, 8, 3]`` (the layout
    :func:`..ops.banded.banded_scatter` reads): ``banded_gather`` of ``u``
    and ``v``, then :func:`em_vector_tangent_sweep` on the padded geometry
    ``X_band [8, 3, E_pad]``, in one kernel that reads ``u`` and ``v``
    through the plan's row → node table (padding elements see zeros, as
    the gather gives them).  ``tables`` as in :func:`em_vector_sweep`.
    """
    if all(t.device.type == "cpu" for t in (X_band, u, v)):
        return banded_tangent_sweep_plain(plan, X_band, u, v, op, params, tab)
    check_index_range(plan, 3)
    dev = X_band.device
    mu, lam, tables = _kernel_args(X_band, op, params, tab, tables)
    E = plan.padded_elements
    _check(X_band, "X_band", (8, 3, E), dev)
    _check(u, "u", (plan.num_nodes, 3), dev)
    _check(v, "v", (plan.num_nodes, 3), dev)
    if not (X_band.is_contiguous() and u.is_contiguous() and v.is_contiguous()):
        raise ValueError("banded_tangent_sweep: X_band, u and v must be contiguous")
    if plan.nodes_padded.device != dev or plan.n != 8:
        raise ValueError(f"banded_tangent_sweep: expected a hex8 banded plan on {dev}")
    out = torch.empty((E, 8, 3), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fenris_banded_tangent_sweep(
            X_band.data_ptr(), u.data_ptr(), v.data_ptr(), plan.nodes_padded.data_ptr(),
            plan.block_rows.data_ptr(), out.data_ptr(), E, plan.elements_per_block,
            tables.data_ptr(), tab.num_points, mu, lam, stream,
        )
    check(lib, code, "banded_tangent_sweep")
    banded_tangent_sweep.launches += 1
    return out


em_vector_sweep.launches = 0
em_vector_tangent_sweep.launches = 0
banded_tangent_sweep.launches = 0
