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
``u`` (``v``) ``[N, d]`` in and element-major rows ``[E_pad, n, d]`` out:
:func:`banded_vector_sweep` (its residual) and :func:`banded_tangent_sweep`
(its matrix-free CG operator).

The kernels take f32, d = s in {2, 3}, the Neo-Hookean, StVK and
linear-elastic materials with Lamé parameters that are scalars or one value
an element (``[E]`` leaves: on the banded wrappers in the plan's padded
element order, ``E = E_pad``), and the elements tet4, tet10, tet20, hex8,
hex20, hex27, quad4, quad8, quad9, tri3 and tri6 with any quadrature rule
whose tables fit a block's shared memory.  A parameter reaches the kernel
by value (a number, or a 0-d CPU tensor), or as a device pointer (an
``[E]`` tensor, or a 0-d CUDA tensor read by the kernel: no host sync).
On a CUDA tensor each wrapper launches the hand-written
kernel (``csrc/em_sweep.cu``) when :func:`supports` holds and raises
``NotImplementedError`` naming what is missing otherwise;
on a CPU tensor it runs the plain version
(:func:`~..assembly.local_em.assemble_element_elliptic_vectors_em`,
:func:`~..assembly.local_em.assemble_element_elliptic_tangent_vectors_em`,
:func:`banded_vector_sweep_plain`, :func:`banded_tangent_sweep_plain`).  The
two element-minor wrappers take views with any strides, so the
element-major rows of the banded gather (``rows.permute(1, 2, 0)``) need no
transposing copy; their output has the strides of ``u_em``.  All four
wrappers run the same two kernels, hex8's and the general one of the other
ten elements (:func:`launch_layout` gives its launch geometry).  Launches
are counted in ``<wrapper>.launches``.
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
    "launch_layout",
    "refusal",
    "supports",
]

#: the kernels' materials, in the order of their codes in csrc/em_sweep.cu
MATERIALS = {"neo_hookean": NeoHookeanMaterial, "stvk": StVKMaterial, "linear": LinearElasticMaterial}
#: the kernels' elements by (dimension, geometry nodes, solution nodes), in the order of csrc/em_sweep.cu's
#: FENRIS_EM_ELEMENT parts
ELEMENTS = {
    (3, 4, 4): "tet4", (3, 4, 10): "tet10", (3, 4, 20): "tet20", (3, 8, 8): "hex8", (3, 8, 20): "hex20",
    (3, 8, 27): "hex27", (2, 4, 4): "quad4", (2, 4, 8): "quad8", (2, 4, 9): "quad9", (2, 3, 3): "tri3",
    (2, 3, 6): "tri6",
}


def _lame_leaf_refusal(x, num_elements):
    """Why a Lamé leaf is not a number, a 0-d array or an ``[num_elements]`` array, or None."""
    if isinstance(x, (int, float)) and not isinstance(x, bool):
        return None
    if not isinstance(x, (torch.Tensor, np.ndarray, np.number)) or np.ndim(x) > 1:
        return f"got {type(x).__name__} of shape {tuple(np.shape(x))}"
    if np.ndim(x) == 1 and num_elements is not None and x.shape[0] != num_elements:
        return f"got {tuple(x.shape)} for {num_elements} elements"
    return None


def refusal(op, params, tab: Tabulation, dtype, num_elements=None):
    """What the kernels do not take in these inputs, as a phrase, or None when they take them all.

    ``num_elements``: the element count a 1-D parameter leaf must have (any
    length when None).
    """
    if dtype != torch.float32:
        return f"f32 (got {dtype})"
    if not isinstance(op, MaterialEllipticOperator) or type(op.material) not in MATERIALS.values():
        return "a Neo-Hookean, StVK or linear-elastic material operator"
    if op.dim not in (2, 3) or op.solution_dim != op.dim:
        return f"d = s in (2, 3) (got d = {op.dim}, s = {op.solution_dim})"
    m, n = tab.geo_dphi.shape[1], tab.dphi.shape[1]
    if (tab.geo_dphi.shape[2], m, n) not in ELEMENTS or tab.geo_dphi.shape[2] != op.dim:
        return (f"a tet4, tet10, tet20, hex8, hex20, hex27, quad4, quad8, quad9, tri3 or tri6 element "
                f"(got d = {tab.geo_dphi.shape[2]} with {m} geometry and {n} solution nodes)")
    leaves = (getattr(params, "mu", None), getattr(params, "lam", None))
    for name, x in zip(("mu", "lam"), leaves):
        why = "a Lamé pair" if x is None else _lame_leaf_refusal(x, num_elements)
        if why is not None:
            return f"scalar or per-element [E] Lamé parameters ({name}: {why})"
    return None


def supports(op, params, tab: Tabulation, dtype, num_elements=None) -> bool:
    """Whether the kernels take these inputs: f32, a Neo-Hookean, StVK or
    linear-elastic material operator, d = s in {2, 3}, one of the eleven
    elements, and Lamé parameters that are scalars or ``[num_elements]``
    arrays (:func:`refusal` names what is missing)."""
    return refusal(op, params, tab, dtype, num_elements) is None


def device_tables(tab: Tabulation, device) -> torch.Tensor:
    """``geo_dphi [q, m, d]``, ``dphi [q, n, d]`` and the weights ``[q]`` as one flat f32 array on
    ``device``: the kernels' tables.

    A model uploads them once and passes them to the wrappers.
    """
    flat = np.concatenate([np.ravel(tab.geo_dphi), np.ravel(tab.dphi), np.ravel(tab.weights)])
    return torch.as_tensor(flat.astype(np.float32), device=device)


def launch_layout(op, tab: Tabulation, tangent: bool, banded: bool = True) -> dict:
    """The kernels' launch geometry on the current card for ``op``'s material on ``tab``'s element and rule:
    ``lanes`` an element, ``elements`` a tile, ``threads`` a block, ``shared_bytes`` a block and
    ``blocks_per_sm`` resident (``fenris_em_layout``; nothing is launched)."""
    lib = load_library()
    out = (ctypes.c_int * 5)()
    m, n = tab.geo_dphi.shape[1], tab.dphi.shape[1]
    material = list(MATERIALS.values()).index(type(op.material))
    check(lib, lib.fenris_em_layout(int(banded), int(tangent), tab.num_points, op.dim, m, n, material, out),
          "em_layout")
    return dict(zip(("lanes", "elements", "threads", "shared_bytes", "blocks_per_sm"), out))


def _check(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the element-sweep kernels are f32-only, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _lame_arg(x, dev):
    """One Lamé leaf (checked by :func:`refusal`) as the launchers' ``(pointer, element stride, value,
    tensor kept alive)``."""
    if isinstance(x, (int, float, np.number)) or (isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim == 0
                                                   and not (isinstance(x, torch.Tensor) and x.device == dev)):
        return None, 0, float(x), None
    t = torch.as_tensor(x, device=dev, dtype=torch.float32).contiguous()
    return t.data_ptr(), t.ndim, 0.0, t


def _kernel_args(X, op, params, tab: Tabulation, tables, E: int):
    """``(tables, q, d, m, n, material code, *mu, *lam, kept)`` for a launch on ``E`` elements on geometry
    ``X``'s device: mu and lam as ``(pointer, element stride, value)``, ``kept`` the tensors they point
    into; raises on what the kernels do not take."""
    dev = X.device
    if dev.type != "cuda":
        raise ValueError(f"the element-sweep kernels run on CUDA or CPU tensors, not on {dev}")
    missing = refusal(op, params, tab, X.dtype, E)
    if missing is not None:
        raise NotImplementedError(f"the element-sweep kernels need {missing}")
    q, m, n, d = tab.num_points, tab.geo_dphi.shape[1], tab.dphi.shape[1], op.dim
    if tables is None:
        tables = device_tables(tab, dev)
    elif (tables.device, tables.dtype, tables.numel()) != (dev, torch.float32, q * d * (m + n) + q):
        raise ValueError("tables: expected device_tables(tab, X_em.device)")
    mu, lam = (_lame_arg(x, dev) for x in (params.mu, params.lam))
    return (tables, q, d, m, n, list(MATERIALS.values()).index(type(op.material)), *mu[:3], *lam[:3],
            (mu[3], lam[3]))


def _launch(X_em, u_em, v_em, op, params, tab: Tabulation, tables):
    dev = X_em.device
    E = X_em.shape[-1]
    tables, q, d, m, n, material, *lame, kept = _kernel_args(X_em, op, params, tab, tables, E)
    _check(X_em, "X_em", (m, d, E), dev)
    _check(u_em, "u_em", (n, d, E), dev)
    if v_em is not None:
        _check(v_em, "v_em", (n, d, E), dev)
    out = torch.empty_like(u_em)  # dense inputs keep their strides
    strides = (ctypes.c_longlong * 12)(
        *X_em.stride(), *u_em.stride(), *(v_em if v_em is not None else u_em).stride(), *out.stride()
    )
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fenris_em_sweep(
            X_em.data_ptr(), u_em.data_ptr(), None if v_em is None else v_em.data_ptr(), out.data_ptr(),
            strides, E, tables.data_ptr(), q, d, m, n, material, *lame, stream,
        )
    check(lib, code, "em_sweep")
    del kept
    return out


def em_vector_sweep(X_em, u_em, op, params, tab: Tabulation, tables=None):
    """``[m, d, E]``, ``[n, s, E]`` -> element internal forces ``[n, s, E]``.

    ``params``: Lamé parameters, scalars or ``[E]`` arrays.  ``tables``:
    :func:`device_tables` of ``tab`` on the card (uploaded per call when
    None).
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
    sweep, element-major rows ``[E_pad, n, d]``."""
    f = assemble_element_elliptic_vectors_em(X_band, banded_gather_plain(plan, u).permute(1, 2, 0), op, params, tab)
    return f.permute(2, 0, 1).contiguous()


def banded_tangent_sweep_plain(plan: BandedPlan, X_band, u, v, op, params, tab: Tabulation):
    """Plain PyTorch version of :func:`banded_tangent_sweep`: two plain gathers, the plain
    tangent sweep, element-major rows ``[E_pad, n, d]``."""
    u_em, v_em = (banded_gather_plain(plan, a).permute(1, 2, 0) for a in (u, v))
    f = assemble_element_elliptic_tangent_vectors_em(X_band, u_em, v_em, op, params, tab)
    return f.permute(2, 0, 1).contiguous()


def _banded_launch(name, plan: BandedPlan, X_band, fields, op, params, tab: Tabulation, tables):
    """One launch of ``fenris_banded_sweep`` on node vectors ``fields`` (u, and v for the tangent)."""
    check_index_range(plan, plan.s)
    dev = X_band.device
    E = plan.padded_elements
    tables, q, d, m, n, material, *lame, kept = _kernel_args(X_band, op, params, tab, tables, E)
    _check(X_band, "X_band", (m, d, E), dev)
    for f, arg in zip(fields, ("u", "v")):
        _check(f, arg, (plan.num_nodes, d), dev)
    if not all(t.is_contiguous() for t in (X_band, *fields)):
        raise ValueError(f"{name}: X_band and the node vectors must be contiguous")
    if plan.nodes_padded.device != dev or (plan.n, plan.s) != (n, d):
        raise ValueError(f"{name}: expected a banded plan of {n}-node elements with {d} components on {dev}")
    u, v = fields[0], fields[1] if len(fields) > 1 else None
    out = torch.empty((E, n, d), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fenris_banded_sweep(
            X_band.data_ptr(), u.data_ptr(), None if v is None else v.data_ptr(), plan.nodes_padded.data_ptr(),
            plan.block_rows.data_ptr(), out.data_ptr(), E, plan.elements_per_block,
            tables.data_ptr(), q, d, m, n, material, *lame, stream,
        )
    check(lib, code, name)
    del kept
    return out


def banded_vector_sweep(plan: BandedPlan, X_band, u, op, params, tab: Tabulation, tables=None):
    """Element internal forces of node vector ``u [N, d]`` on the banded layout.

    Returns element-major rows ``[E_pad, n, d]`` (the layout
    :func:`..ops.banded.banded_scatter` reads): ``banded_gather`` of ``u``,
    then :func:`em_vector_sweep` on the padded geometry ``X_band [m, d,
    E_pad]``, in one kernel that reads ``u`` through the plan's row → node
    table; padding elements get zero rows, as the gather gives them zero
    displacements.  Per-element parameters are ``[E_pad]`` arrays in the
    padded element order (``plan.pad_elements``).  ``tables`` as in
    :func:`em_vector_sweep`.
    """
    if X_band.device.type == "cpu" and u.device.type == "cpu":
        return banded_vector_sweep_plain(plan, X_band, u, op, params, tab)
    out = _banded_launch("banded_vector_sweep", plan, X_band, (u,), op, params, tab, tables)
    banded_vector_sweep.launches += 1
    return out


def banded_tangent_sweep(plan: BandedPlan, X_band, u, v, op, params, tab: Tabulation, tables=None):
    """Element Hessian actions of node vectors ``u``, ``v [N, d]`` on the banded layout.

    Returns element-major rows ``[E_pad, n, d]``: ``banded_gather`` of ``u``
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
