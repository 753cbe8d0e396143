"""Banded gather/scatter of unstructured element data: wrappers and plain versions.

Counterpart of ``fenris_tpu/ops/banded.py``.  A :class:`BandedPlan` sorts
the elements by the owned node range of their smallest node (``r_nodes``
nodes per range) and pads each range's elements to one row count, exactly
as the JAX plan does; the padded row layout ``[E_pad, n, s]`` is the one
the element sweeps of the matrix-free path run on.  Two kernels move data
between node vectors ``u [N, s]`` and that layout:

* :func:`banded_gather` — ``u[nodes_padded[r]]`` per row, zero on padding
  rows, bitwise equal to ``u[cells[perm]]`` on valid rows (replaces
  ``_gather_blocked_tpu``);
* :func:`banded_scatter` — the sum of each node's valid rows, taken in
  ascending row order with no atomics, so two launches are bitwise equal
  (replaces ``_scatter_blocked_tpu``).

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/banded.cu``; f32, contiguous, fewer than 2^31 row values) or
raises; on a CPU tensor it runs
the plain version.  Launches are counted in ``<wrapper>.launches``.  An
untraced launch is called straight from Python; under a dispatch mode
(``make_fx``, as ``torch.func.linearize`` traces) or a functorch transform
it goes through a ``torch.library`` custom op with a fake implementation.  The
TPU's window blocking (one-hot matmuls over 128-node blocks, bf16 splits,
halo combine) is TPU structure and is not carried over: on the card a row
reads its node directly, and the scatter walks a node→rows map (CSR,
rows ascending) that the plan builds once on its device.

:func:`gather` and :func:`scatter_add` are the autodiff-transparent pair
(each the other's transpose, as ``linear_call`` makes them in JAX), so
``torch.func.jvp``, ``torch.func.linearize`` and ``torch.autograd`` pass
through the kernels.  They send f32 data to the kernels and any other
dtype to the plain versions, on the card too (the kernel wrappers raise on
it), as the JAX package sends non-f32 data to XLA's gather and scatter.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..assembly.global_ import ScatterPlan, scatter_add_rows, scatter_plan
from ..config import resolve_device
from ._build import check, load_library

__all__ = [
    "BandedPlan",
    "make_banded_plan",
    "gather",
    "scatter_add",
    "banded_gather",
    "banded_scatter",
    "banded_gather_plain",
    "banded_scatter_plain",
    "check_index_range",
]


@dataclass(frozen=True, eq=False)
class BandedPlan:
    """Index structure of the banded gather/scatter (host metadata, device tables).

    Row layout: block ``k`` owns rows ``[k*rows, (k+1)*rows)``; row
    ``r < counts[k] * n`` of block ``k`` is element ``perm[starts[k] + r // n]``,
    local node ``r % n``; the other rows are padding.
    """

    num_nodes: int
    s: int  # components per node
    n: int  # nodes per element
    num_elements: int  # real (unpadded) element count
    k_blocks: int  # number of owned node ranges
    rows: int  # padded rows per block (a multiple of rowt and of n)
    rowt: int  # row tile of the JAX kernels; sets the padding rule
    wa: int  # node window width in 128-node blocks (the bandwidth guard)
    elements_per_block: int  # rows // n
    perm: np.ndarray  # [E] element permutation (sorted by owner)
    counts: np.ndarray  # [k_blocks] real elements per block
    element_index: np.ndarray  # [E_pad] source element of each padded element
    nodes_padded: torch.Tensor  # [k_blocks*rows] int32 node of each row (0 on padding)
    valid_rows: torch.Tensor  # [k_blocks*rows] float64 1/0 row mask
    block_rows: torch.Tensor  # [k_blocks] int32 valid rows per block (counts * n)
    row_ptr: torch.Tensor  # [num_nodes + 1] int32 CSR offsets of the node -> rows map
    node_rows: torch.Tensor  # [nnz] int32 valid rows per node, ascending
    node_scatter: ScatterPlan  # layered scatter of the valid rows (plain version)
    valid_idx: torch.Tensor  # [nnz] int64 valid rows in ascending order

    @property
    def padded_elements(self) -> int:
        return self.k_blocks * self.elements_per_block

    def pad_elements(self, arr: np.ndarray) -> np.ndarray:
        """Permute and pad a per-element host array to the padded row layout.

        Padding elements repeat the block's first real element (the global
        first element for empty blocks), so element math on them stays
        finite; the scatter drops their rows.
        """
        return np.asarray(arr)[self.element_index]

    def valid_elements(self) -> np.ndarray:
        """``[padded_elements]`` 1.0/0.0 mask of real (non-padding) elements."""
        bp = self.elements_per_block
        return (np.arange(bp)[None, :] < self.counts[:, None]).reshape(-1).astype(np.float64)


def make_banded_plan(
    cells: np.ndarray,
    num_nodes: int,
    s: int,
    r_nodes: int = 4096,
    rowt: int = 2048,
    max_wa: int = 2048,
    device="cuda",
) -> BandedPlan:
    """Build a :class:`BandedPlan` for ``cells [E, n]`` with its tables on ``device``.

    ``r_nodes`` (a multiple of 1024) is the owned node range per block;
    ``rowt`` the JAX kernel's row tile, which sets the row padding.
    Raises ``ValueError`` if the mesh bandwidth makes the node window wider
    than ``max_wa`` 128-node blocks (reorder the mesh with reverse
    Cuthill–McKee first, :mod:`..mesh.reorder`).
    """
    dev = resolve_device(device)
    cells = np.asarray(cells)
    E, n = cells.shape
    if r_nodes % 1024:
        raise ValueError("r_nodes must be a multiple of 1024")
    cmin = cells.min(axis=1)
    owner = cmin // r_nodes
    k_blocks = max(int(owner.max()) + 1, 1) if E else 1
    perm = np.argsort(owner, kind="stable")
    cells_s = cells[perm]
    owner_s = owner[perm]
    counts = np.bincount(owner_s, minlength=k_blocks)
    bmax = max(int(counts.max()), 1)
    # rows per block: a common multiple of rowt and n
    bp = -(-(bmax * n) // rowt) * rowt // n
    while (bp * n) % rowt:
        bp += 1
    rows = bp * n
    rel = cells_s - (owner_s * r_nodes)[:, None]
    w = int(rel.max()) + 1 if E else 1
    wa = -(-w // 128)
    wa = -(-wa // 8) * 8
    if wa > max_wa:
        raise ValueError(
            f"banded window needs {wa} blocks (> {max_wa}); mesh bandwidth "
            "too large — apply reverse Cuthill-McKee reordering first"
        )

    # padded element -> source element: the block's elements, then repeats
    # of its first one (of the global first element for an empty block)
    starts = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(bp)[None, :]
    first = np.where(counts > 0, starts[:-1], 0)[:, None]
    element_index = perm[np.where(slot < counts[:, None], starts[:-1, None] + slot, first)].reshape(-1)
    # padded row -> node on the device: valid rows first in each block, in
    # element order, so they are the sorted cells in row-major order
    block_rows = torch.as_tensor((counts * n).astype(np.int32), device=dev)
    r = torch.arange(k_blocks * rows, device=dev)
    valid = (r % rows) < block_rows.long()[r // rows]
    valid_idx = torch.nonzero(valid).reshape(-1)
    nodes_t = torch.zeros(k_blocks * rows, dtype=torch.int32, device=dev)
    nodes_t[valid_idx] = torch.as_tensor(cells_s.reshape(-1).astype(np.int32), device=dev)
    # node -> rows (CSR, rows ascending within each node)
    valid_nodes = nodes_t[valid_idx].long()
    order = torch.sort(valid_nodes, stable=True).indices
    per_node = torch.bincount(valid_nodes, minlength=num_nodes)
    row_ptr = torch.zeros(num_nodes + 1, dtype=torch.int64, device=dev)
    row_ptr[1:] = torch.cumsum(per_node, 0)
    return BandedPlan(
        num_nodes=int(num_nodes),
        s=int(s),
        n=int(n),
        num_elements=int(E),
        k_blocks=k_blocks,
        rows=rows,
        rowt=rowt,
        wa=wa,
        elements_per_block=bp,
        perm=perm,
        counts=counts,
        element_index=element_index,
        nodes_padded=nodes_t,
        valid_rows=valid.to(torch.float64),
        block_rows=block_rows,
        row_ptr=row_ptr.to(torch.int32),
        node_rows=valid_idx[order].to(torch.int32),
        node_scatter=scatter_plan(valid_nodes),
        valid_idx=valid_idx,
    )


# -- plain versions ----------------------------------------------------------------


def banded_gather_plain(plan: BandedPlan, u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch gather: ``u[nodes_padded] * valid``, as ``[E_pad, n, s]``."""
    rows = u[plan.nodes_padded.long()] * plan.valid_rows.to(u.dtype)[:, None]
    return rows.reshape(plan.padded_elements, plan.n, -1)


def banded_scatter_plain(plan: BandedPlan, f_el: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch scatter: each node's valid rows added in ascending row order."""
    rows = f_el.reshape(-1, f_el.shape[-1])[plan.valid_idx]
    return scatter_add_rows(f_el.new_zeros((plan.num_nodes, f_el.shape[-1])), plan.node_scatter, rows)


# -- kernel wrappers ---------------------------------------------------------------


def check_index_range(plan: BandedPlan, s: int) -> None:
    """Raise unless the padded layout's ``rows_total * s`` values have 32-bit indices (the kernels' arithmetic)."""
    if plan.k_blocks * plan.rows * s >= 2**31:
        raise ValueError(
            f"banded layout of {plan.k_blocks * plan.rows} rows x {s} components reaches 2^31 values: "
            "the banded kernels index it with 32-bit integers"
        )


def _check(plan: BandedPlan, t: torch.Tensor, name: str, lead) -> None:
    """Device, dtype, contiguity and shape ``[*lead, s]`` checks for a kernel input."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the banded kernels run on CUDA or CPU tensors, not on {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the banded kernels are f32-only, got {t.dtype}")
    if tuple(t.shape[:-1]) != tuple(lead) or t.shape[-1] < 1:
        raise ValueError(f"{name}: expected shape [{', '.join(map(str, lead))}, s], got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if plan.nodes_padded.device != t.device:
        raise ValueError(f"{name}: the banded plan lives on {plan.nodes_padded.device}, the tensor on {t.device}")


def _check_aligned(nodes: torch.Tensor, u: torch.Tensor) -> None:
    """The gather's alignment: its int4 index loads need the plan's ``nodes`` on 16 bytes, and at s = 2 its
    float2 loads need ``u`` on 8 (a view at an odd float offset is not)."""
    if nodes.data_ptr() % 16:
        raise ValueError("banded plan: nodes_padded must be 16-byte aligned (the gather loads 4 indices as one int4)")
    if u.shape[-1] == 2 and u.data_ptr() % 8:
        raise ValueError("u: at s = 2 it must be 8-byte aligned (the gather loads a node as one float2); "
                         "pass a copy, not a view at an odd float offset")


def _on_stream(launcher, t: torch.Tensor, *args) -> int:
    """Call ``launcher(*args, stream)`` with the current stream of ``t``'s device, that device made current."""
    index = t.device.index
    if index == torch.cuda.current_device():
        return launcher(*args, torch.cuda.current_stream(index).cuda_stream)
    with torch.cuda.device(index):
        return launcher(*args, torch.cuda.current_stream(index).cuda_stream)


def _launch_gather(u: torch.Tensor, nodes: torch.Tensor, block_rows: torch.Tensor, rows: int) -> torch.Tensor:
    _check_aligned(nodes, u)
    lib = load_library()
    s = u.shape[1]
    out = u.new_empty((nodes.numel(), s))
    code = _on_stream(lib.fenris_banded_gather, u, u.data_ptr(), nodes.data_ptr(), block_rows.data_ptr(),
                      out.data_ptr(), nodes.numel(), rows, s)
    check(lib, code, "banded_gather")
    banded_gather.launches += 1
    return out


def _launch_scatter(f: torch.Tensor, row_ptr: torch.Tensor, node_rows: torch.Tensor) -> torch.Tensor:
    lib = load_library()
    s = f.shape[1]
    num_nodes = row_ptr.numel() - 1
    out = f.new_empty((num_nodes, s))
    code = _on_stream(lib.fenris_banded_scatter, f, f.data_ptr(), row_ptr.data_ptr(), node_rows.data_ptr(),
                      out.data_ptr(), num_nodes, s)
    check(lib, code, "banded_scatter")
    banded_scatter.launches += 1
    return out


# the launches as custom ops, for tracing (make_fx, torch.func.linearize) and functorch transforms
_gather_kernel = torch.library.custom_op("fenris_tpu_torch::banded_gather_kernel", _launch_gather, mutates_args=())
_scatter_kernel = torch.library.custom_op("fenris_tpu_torch::banded_scatter_kernel", _launch_scatter, mutates_args=())


@_gather_kernel.register_fake
def _(u, nodes, block_rows, rows):
    return u.new_empty((nodes.numel(), u.shape[1]))


@_scatter_kernel.register_fake
def _(f, row_ptr, node_rows):
    return f.new_empty((row_ptr.numel() - 1, f.shape[1]))


def _eager(t: torch.Tensor) -> bool:
    """True when nothing traces or transforms ``t`` (no dispatch mode, not a subclass, not a functorch-wrapped
    tensor): the launch is then called straight from Python, without the custom op's dispatch, which takes
    the host longer than the card takes to run the kernel on the 2D layouts.  The checks read torch internals:
    ``test_launches_skip_the_custom_op_only_when_untraced`` (CPU) and ``test_banded_launch_route_on_card``
    hold the decision under ``torch.func.jvp`` and ``make_fx`` against the installed torch."""
    return (type(t) is torch.Tensor and torch._C._len_torch_dispatch_stack() == 0
            and not torch._C._functorch.is_functorch_wrapped_tensor(t))


def banded_gather(plan: BandedPlan, u: torch.Tensor) -> torch.Tensor:
    """Gather node data ``u [N, s]`` into padded element rows ``[E_pad, n, s]``.

    Padding rows are zero; valid rows are bitwise ``u[cells[perm]]``.  Not
    differentiable (see :func:`gather`).
    """
    if u.device.type == "cpu":
        return banded_gather_plain(plan, u)
    check_index_range(plan, u.shape[-1])
    _check(plan, u, "u", (plan.num_nodes,))
    rows = (_launch_gather if _eager(u) else _gather_kernel)(u, plan.nodes_padded, plan.block_rows, plan.rows)
    return rows.reshape(plan.padded_elements, plan.n, -1)


def banded_scatter(plan: BandedPlan, f_el: torch.Tensor) -> torch.Tensor:
    """Sum padded element rows ``[E_pad, n, s]`` into node data ``[N, s]``.

    Padding rows are dropped; each node's rows are added in ascending row
    order, so the result is bitwise reproducible.  Not differentiable (see
    :func:`scatter_add`).
    """
    if f_el.device.type == "cpu":
        return banded_scatter_plain(plan, f_el)
    _check(plan, f_el, "f_el", (plan.padded_elements, plan.n))
    launch = _launch_scatter if _eager(f_el) else _scatter_kernel
    return launch(f_el.reshape(-1, f_el.shape[-1]), plan.row_ptr, plan.node_rows)


banded_gather.launches = 0
banded_scatter.launches = 0


# -- the differentiable pair -------------------------------------------------------


def _gather_rows(plan: BandedPlan, u: torch.Tensor) -> torch.Tensor:
    """The gather kernel for f32 data; the plain version for other dtypes (f64 on the card too),
    as the JAX package sends non-f32 data to XLA's gather."""
    return banded_gather(plan, u) if u.dtype == torch.float32 else banded_gather_plain(plan, u)


def _scatter_rows(plan: BandedPlan, f_el: torch.Tensor) -> torch.Tensor:
    """The scatter kernel for f32 data; the plain version for other dtypes."""
    return banded_scatter(plan, f_el) if f_el.dtype == torch.float32 else banded_scatter_plain(plan, f_el)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(u, plan):
        return _gather_rows(plan, u)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plan = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _scatter_rows(ctx.plan, grad.contiguous()), None

    @staticmethod
    def jvp(ctx, du, _):
        return _gather_rows(ctx.plan, du.contiguous())


class _ScatterAdd(torch.autograd.Function):
    @staticmethod
    def forward(f_el, plan):
        return _scatter_rows(plan, f_el)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plan = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _gather_rows(ctx.plan, grad.contiguous()), None

    @staticmethod
    def jvp(ctx, df, _):
        return _scatter_rows(ctx.plan, df.contiguous())


def gather(plan: BandedPlan, u: torch.Tensor) -> torch.Tensor:
    """:func:`banded_gather` (f32) or :func:`banded_gather_plain`, linear in ``u``; its transpose is
    :func:`scatter_add`."""
    return _Gather.apply(u, plan)


def scatter_add(plan: BandedPlan, f_el: torch.Tensor) -> torch.Tensor:
    """:func:`banded_scatter` (f32) or :func:`banded_scatter_plain`, linear in ``f_el``; its transpose is
    :func:`gather`."""
    return _ScatterAdd.apply(f_el, plan)
