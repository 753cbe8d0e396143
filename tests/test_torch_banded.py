"""Port parity: the banded plan, gather/scatter and RCM reordering.

The JAX ``fenris_tpu.ops.banded`` runs its XLA fallback on the CPU; the
port's wrappers take their plain versions on CPU tensors.  The CUDA
kernels' index tables (the node -> rows CSR map, the per-block valid row
counts) are checked here by emulating the kernels in numpy.
"""

import math
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err, rng, to_numpy

import fenris_tpu_torch.ops.banded as tb
from fenris_tpu.mesh.procedural import create_unit_box_uniform_hex_mesh_3d as jax_box
from fenris_tpu.mesh.reorder import reorder_mesh as jax_reorder_mesh
from fenris_tpu.mesh.reorder import reverse_cuthill_mckee as jax_rcm
from fenris_tpu.ops import banded as jb
from fenris_tpu_torch.mesh.convert import convert_mesh
from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d as torch_box
from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_tet_mesh_3d as torch_tet_box
from fenris_tpu_torch.mesh.reorder import reorder_mesh, reverse_cuthill_mckee

# (mesh, s, r_nodes, rowt): a box, an RCM-reordered box with one component,
# a box with several owner blocks (ragged counts), and a box at s = 4 (the
# kernels' any-s bodies)
CASES = {
    "box5_s3": ("box", 5, 3, 1024, 256),
    "rcm6_s1": ("rcm", 6, 1, 1024, 256),
    "box12_s3_blocks": ("box", 12, 3, 1024, 256),
    "box5_s4": ("box", 5, 4, 1024, 256),
}


def _meshes(kind, res):
    jm, tm = jax_box(res), torch_box(res)
    if kind == "rcm":
        jm, _ = jax_reorder_mesh(jm)
        tm, _ = reorder_mesh(tm, device="cpu")
    return jm, tm


_PLANS = {}


def _plans(name):
    if name not in _PLANS:
        kind, res, s, r_nodes, rowt = CASES[name]
        jm, tm = _meshes(kind, res)
        jp = jb.make_banded_plan(np.asarray(jm.cells), jm.num_vertices, s=s, r_nodes=r_nodes, rowt=rowt)
        tp = tb.make_banded_plan(tm.cells, tm.num_vertices, s=s, r_nodes=r_nodes, rowt=rowt, device="cpu")
        _PLANS[name] = (np.asarray(jm.cells), jp, tp)
    return _PLANS[name]


@pytest.mark.parametrize("name", list(CASES))
def test_plan_matches_jax(name):
    cells, jp, tp = _plans(name)
    for f in ("num_nodes", "s", "n", "num_elements", "k_blocks", "rows", "rowt", "wa", "elements_per_block",
              "padded_elements"):
        assert getattr(tp, f) == getattr(jp, f), f
    np.testing.assert_array_equal(tp.perm, jp.perm)
    np.testing.assert_array_equal(tp.counts, jp.counts)
    np.testing.assert_array_equal(to_numpy(tp.nodes_padded), np.asarray(jp.nodes_padded))
    np.testing.assert_array_equal(to_numpy(tp.valid_rows), np.asarray(jp.valid_rows).reshape(-1))
    np.testing.assert_array_equal(tp.valid_elements(), jp.valid_elements())
    arr = rng(1).standard_normal((cells.shape[0], 2, 3))
    np.testing.assert_array_equal(tp.pad_elements(arr), jp.pad_elements(arr))


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_tables_reproduce_the_plain_versions(name):
    """Numpy emulations of the two CUDA kernels, fed the plan's kernel tables, equal the plain versions bitwise."""
    _, _, tp = _plans(name)
    s, N = tp.s, tp.num_nodes
    u = rng(2).standard_normal((N, s))
    f = rng(3).standard_normal((tp.padded_elements, tp.n, s))
    # gather kernel: row r of block k is valid iff r % rows < block_rows[k]
    r = np.arange(tp.k_blocks * tp.rows)
    valid = (r % tp.rows) < to_numpy(tp.block_rows)[r // tp.rows]
    nodes = to_numpy(tp.nodes_padded)
    emulated = (u[nodes] * valid[:, None]).reshape(tp.padded_elements, tp.n, s)
    assert np.array_equal(emulated, to_numpy(tb.banded_gather(tp, torch.as_tensor(u))))
    # scatter kernel: each node sums its CSR rows in order, from zero
    ptr, node_rows = to_numpy(tp.row_ptr), to_numpy(tp.node_rows)
    assert np.all(np.diff(ptr) >= 0) and all(np.all(np.diff(node_rows[ptr[i]:ptr[i + 1]]) > 0) for i in range(N))
    rows = f.reshape(-1, s)
    emulated = np.zeros((N, s))
    for i in range(N):
        for j in node_rows[ptr[i]:ptr[i + 1]]:
            emulated[i] += rows[j]
    assert np.array_equal(emulated, to_numpy(tb.banded_scatter(tp, torch.as_tensor(f))))


def _kernel_constant(name: str) -> int:
    """``constexpr int name`` of csrc/banded.cu (the emulations below follow the source)."""
    src = (Path(tb.__file__).resolve().parent.parent / "csrc" / "banded.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("name", list(CASES))
def test_gather_kernel_tiles_reproduce_the_plan(name, s):
    """Numpy emulation of the gather kernel's tiled body at s = 1, 2, 3 (csrc/banded.cu): thread block
    (k, tile) covers rows ``[tile * 1024, (tile + 1) * 1024)`` of owner block k; thread t takes the 4 rows
    from offset ``tile0 + 4 t``, their indices one int4 load (16-byte aligned) made iff the first row is
    valid, a row valid iff its offset is below ``block_rows[k]``; at s = 1 the 4 values leave as one float4
    straight from registers, at s = 2, 3 the tile is staged in shared memory (thread t's at float4 ``t s``)
    and leaves as one contiguous float4 run.  The emulated rows equal the plain gather bitwise."""
    _, _, tp = _plans(name)
    threads, group = _kernel_constant("kThreads"), _kernel_constant("kGroupRows")
    tile = threads * group
    assert tp.rows % group == 0 and tp.k_blocks * tp.rows * s < 2**31
    k, ty, t = np.meshgrid(np.arange(tp.k_blocks), np.arange(-(-tp.rows // tile)), np.arange(threads),
                           indexing="ij")
    local = ty * tile + t * group  # first row of the thread inside the owner block, 32-bit
    inside = local < tp.rows
    k, ty, t, local = (a[inside] for a in (k, ty, t, local))
    first = k * tp.rows + local  # the int4 index load's first element
    assert np.all(first % 4 == 0)
    block_rows, nodes = to_numpy(tp.block_rows), to_numpy(tp.nodes_padded)
    row = first[:, None] + np.arange(group)  # [threads, 4]
    np.testing.assert_array_equal(np.sort(row.ravel()), np.arange(tp.k_blocks * tp.rows))  # each row once
    loaded = local < block_rows[k]
    idx = np.where(loaded[:, None], nodes[row], 0)
    valid = (local[:, None] + np.arange(group)) < block_rows[k][:, None]
    assert not np.any(valid & ~loaded[:, None])  # a valid row's index comes from its thread's load
    np.testing.assert_array_equal(valid.ravel()[np.argsort(row.ravel())], to_numpy(tp.valid_rows) > 0)
    u = rng(14).standard_normal((tp.num_nodes, s))
    vals = np.where(valid[:, :, None], u[idx], 0.0).reshape(-1, group * s)  # padding rows: zeros, u unread
    out = np.full(tp.k_blocks * tp.rows * s, np.nan)
    if s == 1:  # one float4 a thread at float (k * rows + local)
        out[first[:, None] + np.arange(4)] = vals
    else:  # staged: the tile's floats in shared memory, then one run from (k * rows + tile0) * s
        for kk, yy in {(a, b) for a, b in zip(k, ty)}:
            sel = (k == kk) & (ty == yy)
            smem = np.full(tile * s, np.nan)
            smem[(t[sel] * s * 4)[:, None] + np.arange(group * s)] = vals[sel]  # s float4 a thread
            n = min(tile, tp.rows - yy * tile) * s
            assert n % 4 == 0
            start = (kk * tp.rows + yy * tile) * s
            out[start:start + n] = smem[:n]
    assert not np.isnan(out).any()
    got = to_numpy(tb.banded_gather(tp, torch.as_tensor(u)))
    assert np.array_equal(out.reshape(tp.padded_elements, tp.n, s), got)


def _star(m):
    """A closed fan of ``m`` tri3 around node 0: node 0 has ``m`` rows, each rim node 2."""
    rim = np.arange(1, m + 1)
    return np.stack([np.zeros(m, np.int64), rim, np.roll(rim, -1)], axis=1)


# s = 3 layouts of the port alone (small, RCM'd where the element is converted or simplicial): rows a node
# vary (tet4, tet10, hex20), node 5 has no rows (gap), the node count is not a multiple of the scatter's
# window (ragged: 1,000 nodes)
SCATTER_CASES = {
    "tet4_s3": lambda: reorder_mesh(torch_tet_box(5), device="cpu")[0].cells,
    "tet10_s3": lambda: reorder_mesh(convert_mesh(torch_tet_box(3), "tet10"), device="cpu")[0].cells,
    "hex20_s3": lambda: reorder_mesh(convert_mesh(torch_box(4), "hex20"), device="cpu")[0].cells,
    "gap_s3": lambda: (lambda c: c + (c >= 5))(torch_box(3).cells),
    "ragged_s3": lambda: torch_box(9).cells,
    "star_s1": lambda: _star(200),
    "star_s2": lambda: _star(200),
    "star_s3": lambda: _star(200),
}


def _scatter_plan(name):
    if name in CASES:
        return _plans(name)[2]
    if name not in _PLANS:
        cells = np.asarray(SCATTER_CASES[name]())
        _PLANS[name] = tb.make_banded_plan(cells, int(cells.max()) + 1, s=int(name[-1]), r_nodes=1024, rowt=256,
                                           device="cpu")
    return _PLANS[name]


def _emulate_lane_walk(tp, rows, lanes):
    """The s = 3 lane walks: block b takes nodes ``[b W, b W + W)`` (W = kScatterWindow); its position p takes
    node ``b W + p`` with ``lanes`` lanes; a step of the node's walk covers ``lanes * B`` rows (B =
    kScatter3Batch), lane q loading rows ``i0 + j lanes + q`` (their indices, then their 12-byte rows), then the
    node's lanes adding the step's rows in ascending order into three f32 accumulators from 0.0; the node's
    sums go to shared memory at slot p, and the window's ``3 count`` floats leave as one run from
    ``out + 3 b W``."""
    W, B = _kernel_constant("kScatterWindow"), _kernel_constant("kScatter3Batch")
    ptr, node_rows, N = to_numpy(tp.row_ptr), to_numpy(tp.node_rows), tp.num_nodes
    out = np.full(3 * N, np.nan, np.float32)
    for base in range(0, N, W):
        count = min(W, N - base)
        smem = np.full(3 * W, np.nan, np.float32)
        for p in range(count):
            node = base + p
            acc = np.zeros(3, np.float32)
            begin, end = ptr[node], ptr[node + 1]
            for i0 in range(begin, end, lanes * B):
                slot = i0 + np.arange(B)[:, None] * lanes + np.arange(lanes)  # [j, q]: lane q's j-th row
                idx = np.where(slot < end, node_rows[np.minimum(slot, len(node_rows) - 1)], -1)
                vals = rows[np.maximum(idx, 0)]  # [j, q, 3]
                for j in range(B):
                    for q in range(lanes):  # row i0 + j lanes + q: ascending
                        if idx[j, q] >= 0:
                            acc += vals[j, q]
            assert np.isnan(smem[3 * p])
            smem[3 * p:3 * p + 3] = acc
        out[3 * base:3 * (base + count)] = smem[:3 * count]
    assert not np.isnan(out).any()
    return out.reshape(N, 3)


def _emulate_component_walk(tp, rows, batch):
    """A thread per (node, component) takes the node's CSR rows in batches of ``batch`` rows (the batch's row
    indices, then their element values, then the adds, in ascending row order from 0.0 in f32)."""
    ptr, node_rows = to_numpy(tp.row_ptr), to_numpy(tp.node_rows)
    out = np.full((tp.num_nodes, rows.shape[1]), np.nan, np.float32)
    for node in range(tp.num_nodes):
        acc = np.zeros(rows.shape[1], np.float32)
        for i0 in range(ptr[node], ptr[node + 1], batch):
            idx = node_rows[i0:min(i0 + batch, ptr[node + 1])]  # the batch's row indices
            vals = rows[idx]  # then their values
            for v in vals:  # then the adds, in order
                acc += v
        out[node] = acc
    return out


@pytest.mark.parametrize("name", [*CASES, *SCATTER_CASES])
def test_scatter_kernel_batches_reproduce_the_plain_version(name):
    """Numpy emulation of the scatter kernel's walks (csrc/banded.cu), always adding each node's rows in
    ascending row order from 0.0 in f32.  At s = 1, 2 a thread takes one node's CSR rows at one component in
    batches of ``kScatterBatch`` rows (the batch's row indices, then their element values, then the adds).  At
    s = 3 the plan's walk first, then the others: the rows walk (a thread per (node, component), one row at a
    time) and the two lane walks of :func:`_emulate_lane_walk` (1 and 4 lanes a node).  Equal to the plain scatter bitwise; the star's centre has many batches of rows."""
    tp = _scatter_plan(name)
    s = tp.s
    ptr = to_numpy(tp.row_ptr)
    if name.startswith("star"):
        assert ptr[1] - ptr[0] == 200 > 10 * _kernel_constant("kScatterBatch")
    if name == "gap_s3":
        assert ptr[6] == ptr[5]  # node 5 has no rows
    if name == "ragged_s3":
        assert tp.num_nodes % _kernel_constant("kScatterWindow") != 0
    f = rng(15).standard_normal((tp.padded_elements, tp.n, s)).astype(np.float32)
    rows = f.reshape(-1, s)
    plain = to_numpy(tb.banded_scatter_plain(tp, torch.as_tensor(f)))
    if s != 3:
        assert np.array_equal(_emulate_component_walk(tp, rows, _kernel_constant("kScatterBatch") if s <= 2 else 1),
                              plain)
        return
    walks = sorted((tb.WALK_ROWS, tb.WALK_LANE, tb.WALK_LANES), key=lambda walk: walk != tp.walk)
    for walk in walks:
        got = _emulate_component_walk(tp, rows, 1) if walk == tb.WALK_ROWS else _emulate_lane_walk(tp, rows, walk)
        assert np.array_equal(got, plain), walk


@pytest.mark.parametrize("name", ["box12_s3_blocks", "tet10_s3", "gap_s3", "ragged_s3", "star_s3"])
def test_walk_inflation_counts_warps(name):
    """``walk_inflation`` against warps counted in numpy: warps of 32 consecutive nodes, each walking its
    longest node's rows, over their mean nodes' rows; with ``sorted_windows`` each ``SCATTER_WINDOW`` (=
    csrc/banded.cu's kScatterWindow) nodes sorted by row count first, which waits on no more rows.  A plan
    made off the card takes the walk ``scatter_walk`` picks from its row counts for the H100's SMs."""
    tp = _scatter_plan(name)
    W = tb.SCATTER_WINDOW
    assert W == _kernel_constant("kScatterWindow") and tb.SCATTER_BATCH == _kernel_constant("kScatter3Batch")
    counts = np.diff(to_numpy(tp.row_ptr)).astype(np.float64)
    windows_sorted = np.concatenate([np.sort(counts[b:b + W]) for b in range(0, len(counts), W)])
    for c, sorted_windows in ((counts, False), (windows_sorted, True)):
        warps = [c[i:i + 32] for i in range(0, len(c), 32)]
        want = sum(w.max() for w in warps) / sum(w.mean() for w in warps)
        got = tb.walk_inflation(torch.as_tensor(counts), sorted_windows=sorted_windows)
        assert got == pytest.approx(want, rel=1e-12)
    counts_t = torch.as_tensor(counts)
    assert 1.0 <= tb.walk_inflation(counts_t, sorted_windows=True) <= tb.walk_inflation(counts_t)
    assert tp.walk == tb.scatter_walk(counts_t) == tb.scatter_walk(counts_t, tb.H100_SMS)


def test_scatter_walk_rule():
    """The s = 3 walk from row counts: nodes of like counts take the rows walk (hex8: 8 rows a node, the
    boundary's fewer in runs); warps of unlike counts (tet10's vertices beside its edge nodes) one lane a node;
    more than two batches of rows a node on a launch of at least ``LANES_WAVES`` waves of the card's SMs, four
    lanes; the same counts on fewer nodes, the walk their warps pick; a card of half the SMs takes four lanes
    from half the nodes."""
    uniform = torch.full((4096,), 8)
    uniform[:64] = 4
    unlike = torch.tensor([2, 2, 24, 2, 8, 2, 2, 2] * 512)
    many = -(-math.ceil(tb.LANES_WAVES * tb.H100_SMS * tb.SCATTER_WINDOW) // 4) * 4  # the first multiple of 4 past it
    tet4_like = torch.tensor([23, 22, 24, 21] * (many // 4))
    assert tb.walk_inflation(uniform) < 1.5 < tb.walk_inflation(unlike)
    assert tb.scatter_walk(uniform) == tb.WALK_ROWS
    assert tb.scatter_walk(unlike) == tb.WALK_LANE
    assert tb.scatter_walk(tet4_like) == tb.WALK_LANES
    assert tb.scatter_walk(tet4_like[:-4]) == tb.WALK_ROWS
    assert tb.scatter_walk(tet4_like[:many // 2], tb.H100_SMS // 2) == tb.WALK_LANES
    assert tb.scatter_walk(tet4_like[:many // 2 - 4], tb.H100_SMS // 2) == tb.WALK_ROWS
    assert tb.scatter_walk(torch.zeros(0, dtype=torch.int64)) == tb.WALK_ROWS


def test_kernels_refuse_layouts_past_32_bit_indices():
    """The gather and the fused tangent sweep raise, before touching memory, when the padded layout
    holds 2^31 values or more; one value fewer passes the check (then meta tensors are refused)."""
    import fenris_tpu_torch.ops.em_sweep as tes

    def fake_plan(k_blocks, rows):
        return SimpleNamespace(k_blocks=k_blocks, rows=rows, num_nodes=4, n=8, s=3, padded_elements=k_blocks * rows // 8)

    u = torch.empty((4, 3), device="meta")
    X = torch.empty((8, 3, 1), device="meta")
    big = fake_plan(2**20, 2**11)  # 2^31 rows
    with pytest.raises(ValueError, match="2\\^31"):
        tb.banded_gather(big, u)
    with pytest.raises(ValueError, match="2\\^31"):
        tes.banded_tangent_sweep(big, X, u, u, None, None, None)
    with pytest.raises(ValueError, match="2\\^31"):
        tb.banded_gather(fake_plan(1, 2**31 // 3 + 1), u)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tb.banded_gather(fake_plan(1, 2**31 // 3), u)  # 2^31 - 2 values


@pytest.mark.parametrize("name", list(CASES))
def test_gather_and_scatter_match_jax(name):
    cells, jp, tp = _plans(name)
    s = tp.s
    u = rng(4).standard_normal((tp.num_nodes, s))
    got = to_numpy(tb.gather(tp, torch.as_tensor(u)))
    assert np.array_equal(got, np.asarray(jb.gather(jp, jnp.asarray(u))))
    valid = to_numpy(tp.valid_rows) > 0
    assert np.array_equal(got.reshape(-1, s)[valid], u[cells[tp.perm].reshape(-1)])
    assert np.all(got.reshape(-1, s)[~valid] == 0.0)
    f = rng(5).standard_normal((tp.padded_elements, tp.n, s))
    # f64, another summation order: roundoff only
    assert rel_err(np.asarray(jb.scatter_add(jp, jnp.asarray(f))), tb.scatter_add(tp, torch.as_tensor(f))) < 1e-12


def test_gather_and_scatter_are_transposes():
    _, _, tp = _plans("rcm6_s1")
    u = torch.as_tensor(rng(6).standard_normal((tp.num_nodes, 1)))
    f = torch.as_tensor(rng(7).standard_normal((tp.padded_elements, tp.n, 1)))
    lhs = float(torch.sum(tb.gather(tp, u) * f))
    rhs = float(torch.sum(u * tb.scatter_add(tp, f)))
    assert lhs == pytest.approx(rhs, rel=1e-13)


def test_autodiff_through_gather_and_scatter():
    """jvp, linearize and reverse mode pass through both functions, each the other's transpose."""
    _, jp, tp = _plans("box5_s3")
    u = torch.as_tensor(rng(8).standard_normal((tp.num_nodes, 3)))
    w = torch.as_tensor(rng(9).standard_normal((tp.padded_elements, tp.n, 3)))

    def f(x):  # nonlinear in x: gather -> elementwise -> scatter
        e = tb.gather(tp, x)
        return tb.scatter_add(tp, torch.sin(e) * e)

    _, jv = torch.func.jvp(f, (u,), (u,))
    ref = jax.jvp(lambda x: jb.scatter_add(jp, jnp.sin(jb.gather(jp, x)) * jb.gather(jp, x)),
                  (jnp.asarray(u.numpy()),), (jnp.asarray(u.numpy()),))[1]
    assert rel_err(np.asarray(ref), jv) < 1e-12
    _, lin = torch.func.linearize(f, u)
    assert rel_err(to_numpy(jv), lin(u)) < 1e-13
    x = u.clone().requires_grad_()
    (g,) = torch.autograd.grad(torch.sum(tb.gather(tp, x) * w), x)
    assert torch.equal(g, tb.scatter_add(tp, w))
    y = w.clone().requires_grad_()
    (g,) = torch.autograd.grad(torch.sum(tb.scatter_add(tp, y) * u), y)
    assert torch.equal(g, tb.gather(tp, u))


def test_bandwidth_guard():
    # an element connecting node 0 to a far node forces a huge window
    cells = np.array([[0, 1, 2, 3, 4, 5, 6, 500000]], np.int64)
    for make, kw in ((jb.make_banded_plan, {}), (tb.make_banded_plan, dict(device="cpu"))):
        with pytest.raises(ValueError, match="bandwidth"):
            make(cells, 500001, s=1, max_wa=64, **kw)
    with pytest.raises(ValueError, match="1024"):
        tb.make_banded_plan(cells, 500001, s=1, r_nodes=1000, device="cpu")


def test_wrappers_take_plain_versions_on_cpu_and_refuse_other_devices():
    _, _, tp = _plans("box5_s3")
    u = torch.as_tensor(rng(10).standard_normal((tp.num_nodes, 3)))
    before = (tb.banded_gather.launches, tb.banded_scatter.launches)
    assert torch.equal(tb.banded_gather(tp, u), tb.banded_gather_plain(tp, u))
    f = tb.banded_gather(tp, u)
    assert torch.equal(tb.banded_scatter(tp, f), tb.banded_scatter_plain(tp, f))
    assert (tb.banded_gather.launches, tb.banded_scatter.launches) == before
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tb.banded_gather(tp, torch.empty((tp.num_nodes, 3), device="meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tb.banded_scatter(tp, torch.empty((tp.padded_elements, tp.n, 3), device="meta"))


def test_launches_skip_the_custom_op_only_when_untraced():
    """The kernel wrappers call their launch straight from Python on a plain tensor, and go through the
    custom op (which make_fx and functorch can trace) under a dispatch mode or a functorch transform."""
    from torch.fx.experimental.proxy_tensor import make_fx

    x = torch.zeros(3)
    seen = []
    torch.func.jvp(lambda a: seen.append(tb._eager(a)) or a, (x,), (x,))
    make_fx(lambda a: seen.append(tb._eager(a)) or a)(x)
    assert tb._eager(x) and seen == [False, False]
    assert not tb._eager(torch.empty(3, device="meta").as_subclass(torch.nn.Parameter))


def test_gather_alignment_is_checked_before_the_launch():
    """The gather's alignment rules (int4 index loads, float2 node loads at s = 2), read from the tensors'
    addresses: a view of u at an odd float offset, or of the plan's indices off 16 bytes, raises a
    ValueError that says so; aligned inputs pass."""
    _, _, tp = _plans("box5_s3")
    N, nodes = tp.num_nodes, tp.nodes_padded
    tb._check_aligned(nodes, torch.zeros((N, 2)))
    tb._check_aligned(nodes, torch.zeros(3 * N + 1)[1:].view(N, 3))
    with pytest.raises(ValueError, match="8-byte aligned"):
        tb._check_aligned(nodes, torch.zeros(2 * N + 1)[1:].view(N, 2))
    with pytest.raises(ValueError, match="16-byte aligned"):
        tb._check_aligned(torch.zeros(nodes.numel() + 1, dtype=torch.int32)[1:], torch.zeros((N, 2)))


def test_scatter_alignment_is_checked_before_the_launch():
    """The s = 3 lane walks load a row as a float and a float2: element rows at an odd float offset raise a
    ValueError that says so; the rows walk (scalar loads), other s and aligned rows pass."""
    f = torch.zeros(3 * 8 + 1)[1:].view(8, 3)
    tb._check_rows_aligned(f, tb.WALK_ROWS)
    tb._check_rows_aligned(torch.zeros((8, 3)), tb.WALK_LANES)
    tb._check_rows_aligned(torch.zeros(2 * 8 + 1)[1:].view(8, 2), tb.WALK_LANE)
    for walk in (tb.WALK_LANE, tb.WALK_LANES):
        with pytest.raises(ValueError, match="8-byte aligned"):
            tb._check_rows_aligned(f, walk)


@pytest.mark.parametrize("shuffle", [False, True], ids=["box", "shuffled"])
def test_rcm_matches_jax(shuffle):
    jm, tm = jax_box(5), torch_box(5)
    if shuffle:
        perm = rng(11).permutation(tm.num_vertices)
        jm, _ = jax_reorder_mesh(jm, perm)
        tm, _ = reorder_mesh(tm, perm)
    np.testing.assert_array_equal(reverse_cuthill_mckee(tm, device="cpu"), jax_rcm(jm))
    jr, jperm = jax_reorder_mesh(jm)
    tr, tperm = reorder_mesh(tm, device="cpu")
    np.testing.assert_array_equal(tperm, jperm)
    np.testing.assert_array_equal(tr.cells, np.asarray(jr.cells))
    np.testing.assert_array_equal(tr.points, np.asarray(jr.points))


def test_differentiable_pair_sends_only_f32_to_the_kernels(monkeypatch):
    """An f64 banded model runs on the card: ``gather``/``scatter_add`` (values and tangents) hand
    f32 data to the kernel wrappers and any other dtype to the plain versions (the wrappers raise on
    f64 CUDA tensors)."""
    _, _, tp = _plans("box5_s3")
    seen = []
    for name in ("banded_gather", "banded_scatter"):
        orig = getattr(tb, name)
        monkeypatch.setattr(tb, name, lambda plan, x, _o=orig, _n=name: seen.append((_n, x.dtype)) or _o(plan, x))
    u = torch.as_tensor(rng(20).standard_normal((tp.num_nodes, 3)))
    for dtype in (torch.float64, torch.float32):
        ud = u.to(dtype)
        rows, drows = torch.func.jvp(lambda x: tb.gather(tp, x), (ud,), (2 * ud,))
        f, df = torch.func.jvp(lambda r: tb.scatter_add(tp, r), (rows,), (drows,))
        assert torch.equal(rows, tb.banded_gather_plain(tp, ud)) and torch.equal(drows, 2 * rows)
        assert torch.equal(f, tb.banded_scatter_plain(tp, rows)) and torch.equal(df, 2 * f)
    assert sorted(set(seen)) == [("banded_gather", torch.float32), ("banded_scatter", torch.float32)]
