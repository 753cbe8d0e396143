"""Fused element sweeps (internal forces, Hessian action): wrappers and plain versions.

Counterpart of ``fenris_tpu/ops/em_sweep.py``.  Two functions carry the
element math of the matrix-free banded path, in the element-minor layouts
of :mod:`..assembly.local_em` (``X_em [m, d, E]``, ``u_em``/``v_em``
``[n, s, E]``, output ``[n, s, E]``):

* :func:`em_vector_sweep` — element internal-force vectors (replaces the
  TPU kernel ``em_vector_sweep``);
* :func:`em_vector_tangent_sweep` — element Hessian actions with the
  closed-form tangent stress (replaces ``em_vector_tangent_sweep``).

The fused model runs each fused with the banded gather, node vectors
``u`` (``v``) ``[N, 3]`` in and element-major rows ``[E_pad, n, 3]`` out:
:func:`banded_vector_sweep` (its residual) and :func:`banded_tangent_sweep`
(its matrix-free CG operator).

The kernels take f32, d = s = 3, the Neo-Hookean, StVK and linear-elastic
materials with scalar Lamé parameters, and the elements tet4, tet10, tet20,
hex8, hex20 and hex27 with any quadrature rule whose tables fit a block's
shared memory.  On a CUDA tensor each wrapper launches the hand-written
kernel (``csrc/em_sweep.cu``) when :func:`supports` holds and raises
``NotImplementedError`` naming what is missing otherwise;
on a CPU tensor it runs the plain version
(:func:`~..assembly.local_em.assemble_element_elliptic_vectors_em`,
:func:`~..assembly.local_em.assemble_element_elliptic_tangent_vectors_em`,
:func:`banded_vector_sweep_plain`, :func:`banded_tangent_sweep_plain`).  The
two element-minor wrappers take views with any strides, so the
element-major rows of the banded gather (``rows.permute(1, 2, 0)``) need no
transposing copy; their output has the strides of ``u_em``.  All four
wrappers run one kernel body.  Launches are counted in
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
from ..solid import LinearElasticMaterial, MaterialEllipticOperator, NeoHookeanMaterial, StVKMaterial
from ._build import check, load_library
from .banded import BandedPlan, banded_gather_plain, check_index_range

__all__ = [
    "ELEMENTS",
    "MATERIALS",
    "banded_tangent_sweep",
    "banded_tangent_sweep_plain",
    "banded_vector_sweep",
    "banded_vector_sweep_plain",
    "device_tables",
    "em_vector_sweep",
    "em_vector_tangent_sweep",
    "refusal",
    "supports",
]

#: the kernels' materials, in the order of their codes in csrc/em_sweep.cu
MATERIALS = {"neo_hookean": NeoHookeanMaterial, "stvk": StVKMaterial, "linear": LinearElasticMaterial}
#: the kernels' elements by (geometry nodes, solution nodes)
ELEMENTS = {(4, 4): "tet4", (4, 10): "tet10", (4, 20): "tet20", (8, 8): "hex8", (8, 20): "hex20", (8, 27): "hex27"}


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


def refusal(op, params, tab: Tabulation, dtype):
    """What the kernels do not take in these inputs, as a phrase, or None when they take them all."""
    if dtype != torch.float32:
        return f"f32 (got {dtype})"
    if not isinstance(op, MaterialEllipticOperator) or type(op.material) not in MATERIALS.values():
        return "a Neo-Hookean, StVK or linear-elastic material operator"
    if op.dim != 3 or op.solution_dim != 3:
        return f"d = s = 3 (got d = {op.dim}, s = {op.solution_dim})"
    m, n = tab.geo_dphi.shape[1], tab.dphi.shape[1]
    if tab.geo_dphi.shape[2] != 3 or (m, n) not in ELEMENTS:
        return f"a tet4, tet10, tet20, hex8, hex20 or hex27 element (got {m} geometry and {n} solution nodes)"
    if _lame_scalars(params) is None:
        return "scalar Lamé parameters"
    return None


def supports(op, params, tab: Tabulation, dtype) -> bool:
    """Whether the kernels take these inputs: f32, a Neo-Hookean, StVK or
    linear-elastic material operator with scalar Lamé parameters, d = s = 3,
    and one of the six 3D elements (:func:`refusal` names what is missing)."""
    return refusal(op, params, tab, dtype) is None


def device_tables(tab: Tabulation, device) -> torch.Tensor:
    """``geo_dphi [q, m, 3]``, ``dphi [q, n, 3]`` and the weights ``[q]`` as one flat f32 array on
    ``device``: the kernels' tables.

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
    """``(tables, q, m, n, material code, mu, lam)`` for a launch on geometry ``X``'s device; raises on
    what the kernels do not take."""
    dev = X.device
    if dev.type != "cuda":
        raise ValueError(f"the element-sweep kernels run on CUDA or CPU tensors, not on {dev}")
    missing = refusal(op, params, tab, X.dtype)
    if missing is not None:
        raise NotImplementedError(f"the element-sweep kernels need {missing}")
    q, m, n = tab.num_points, tab.geo_dphi.shape[1], tab.dphi.shape[1]
    if tables is None:
        tables = device_tables(tab, dev)
    elif (tables.device, tables.dtype, tables.numel()) != (dev, torch.float32, q * (3 * m + 3 * n + 1)):
        raise ValueError("tables: expected device_tables(tab, X_em.device)")
    return (tables, q, m, n, list(MATERIALS.values()).index(type(op.material)), *_lame_scalars(params))


def _launch(X_em, u_em, v_em, op, params, tab: Tabulation, tables):
    dev = X_em.device
    tables, q, m, n, material, mu, lam = _kernel_args(X_em, op, params, tab, tables)
    E = X_em.shape[-1]
    _check(X_em, "X_em", (m, 3, E), dev)
    _check(u_em, "u_em", (n, 3, E), dev)
    if v_em is not None:
        _check(v_em, "v_em", (n, 3, E), dev)
    out = torch.empty_like(u_em)  # dense inputs keep their strides
    strides = (ctypes.c_longlong * 12)(
        *X_em.stride(), *u_em.stride(), *(v_em if v_em is not None else u_em).stride(), *out.stride()
    )
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fenris_em_sweep(
            X_em.data_ptr(), u_em.data_ptr(), None if v_em is None else v_em.data_ptr(), out.data_ptr(),
            strides, E, tables.data_ptr(), q, m, n, material, mu, lam, stream,
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


def banded_vector_sweep_plain(plan: BandedPlan, X_band, u, op, params, tab: Tabulation):
    """Plain PyTorch version of :func:`banded_vector_sweep`: the plain gather, the plain vector
    sweep, element-major rows ``[E_pad, n, 3]``."""
    f = assemble_element_elliptic_vectors_em(X_band, banded_gather_plain(plan, u).permute(1, 2, 0), op, params, tab)
    return f.permute(2, 0, 1).contiguous()


def banded_tangent_sweep_plain(plan: BandedPlan, X_band, u, v, op, params, tab: Tabulation):
    """Plain PyTorch version of :func:`banded_tangent_sweep`: two plain gathers, the plain
    tangent sweep, element-major rows ``[E_pad, n, 3]``."""
    u_em, v_em = (banded_gather_plain(plan, a).permute(1, 2, 0) for a in (u, v))
    f = assemble_element_elliptic_tangent_vectors_em(X_band, u_em, v_em, op, params, tab)
    return f.permute(2, 0, 1).contiguous()


def _banded_launch(name, plan: BandedPlan, X_band, fields, op, params, tab: Tabulation, tables):
    """One launch of ``fenris_banded_sweep`` on node vectors ``fields`` (u, and v for the tangent)."""
    check_index_range(plan, 3)
    dev = X_band.device
    tables, q, m, n, material, mu, lam = _kernel_args(X_band, op, params, tab, tables)
    E = plan.padded_elements
    _check(X_band, "X_band", (m, 3, E), dev)
    for f, arg in zip(fields, ("u", "v")):
        _check(f, arg, (plan.num_nodes, 3), dev)
    if not all(t.is_contiguous() for t in (X_band, *fields)):
        raise ValueError(f"{name}: X_band and the node vectors must be contiguous")
    if plan.nodes_padded.device != dev or plan.n != n:
        raise ValueError(f"{name}: expected a banded plan of {n}-node elements on {dev}")
    u, v = fields[0], fields[1] if len(fields) > 1 else None
    out = torch.empty((E, n, 3), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fenris_banded_sweep(
            X_band.data_ptr(), u.data_ptr(), None if v is None else v.data_ptr(), plan.nodes_padded.data_ptr(),
            plan.block_rows.data_ptr(), out.data_ptr(), E, plan.elements_per_block,
            tables.data_ptr(), q, m, n, material, mu, lam, stream,
        )
    check(lib, code, name)
    return out


def banded_vector_sweep(plan: BandedPlan, X_band, u, op, params, tab: Tabulation, tables=None):
    """Element internal forces of node vector ``u [N, 3]`` on the banded layout.

    Returns element-major rows ``[E_pad, n, 3]`` (the layout
    :func:`..ops.banded.banded_scatter` reads): ``banded_gather`` of ``u``,
    then :func:`em_vector_sweep` on the padded geometry ``X_band [m, 3,
    E_pad]``, in one kernel that reads ``u`` through the plan's row → node
    table; padding elements get zero rows, as the gather gives them zero
    displacements.  ``tables`` as in :func:`em_vector_sweep`.
    """
    if X_band.device.type == "cpu" and u.device.type == "cpu":
        return banded_vector_sweep_plain(plan, X_band, u, op, params, tab)
    out = _banded_launch("banded_vector_sweep", plan, X_band, (u,), op, params, tab, tables)
    banded_vector_sweep.launches += 1
    return out


def banded_tangent_sweep(plan: BandedPlan, X_band, u, v, op, params, tab: Tabulation, tables=None):
    """Element Hessian actions of node vectors ``u``, ``v [N, 3]`` on the banded layout.

    Returns element-major rows ``[E_pad, n, 3]``: ``banded_gather`` of ``u``
    and ``v``, then :func:`em_vector_tangent_sweep` on the padded geometry,
    in one kernel, as :func:`banded_vector_sweep` (padding elements get zero
    rows).  ``tables`` as in :func:`em_vector_sweep`.
    """
    if all(t.device.type == "cpu" for t in (X_band, u, v)):
        return banded_tangent_sweep_plain(plan, X_band, u, v, op, params, tab)
    out = _banded_launch("banded_tangent_sweep", plan, X_band, (u, v), op, params, tab, tables)
    banded_tangent_sweep.launches += 1
    return out


em_vector_sweep.launches = 0
em_vector_tangent_sweep.launches = 0
banded_vector_sweep.launches = 0
banded_tangent_sweep.launches = 0
