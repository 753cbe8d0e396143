"""Port parity: the banded plan, gather/scatter and RCM reordering.

The JAX ``fenris_tpu.ops.banded`` runs its XLA fallback on the CPU; the
port's wrappers take their plain versions on CPU tensors.  The CUDA
kernels' index tables (the node -> rows CSR map, the per-block valid row
counts) are checked here by emulating the kernels in numpy.
"""

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
from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d as torch_box
from fenris_tpu_torch.mesh.reorder import reorder_mesh, reverse_cuthill_mckee

# (mesh, s, r_nodes, rowt): a box, an RCM-reordered box with one component,
# and a box with several owner blocks (ragged counts)
CASES = {
    "box5_s3": ("box", 5, 3, 1024, 256),
    "rcm6_s1": ("rcm", 6, 1, 1024, 256),
    "box12_s3_blocks": ("box", 12, 3, 1024, 256),
}


def _meshes(kind, res):
    jm, tm = jax_box(res), torch_box(res)
    if kind == "rcm":
        jm, _ = jax_reorder_mesh(jm)
        tm, _ = reorder_mesh(tm)
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


@pytest.mark.parametrize("name", list(CASES))
def test_gather_kernel_tiles_reproduce_the_plan(name):
    """Numpy emulation of the gather kernel's grid: thread block (k, tile) covers rows
    ``[tile * 1024, (tile + 1) * 1024)`` of owner block k, a thread 4 consecutive rows, a row
    valid iff its offset in the block is below ``block_rows[k]``, a tile's rows stored as one
    contiguous run (as in csrc/banded.cu)."""
    _, _, tp = _plans(name)
    threads, rows_per_thread = 256, 4  # kThreads, kRowsPerThread
    tile = threads * rows_per_thread
    k, t, j = np.meshgrid(np.arange(tp.k_blocks), np.arange(-(-tp.rows // tile) * threads),
                          np.arange(rows_per_thread), indexing="ij")
    local = t * rows_per_thread + j  # row offset inside the owner block, 32-bit
    inside = local < tp.rows
    row = (k * tp.rows + local)[inside]
    valid = (local < to_numpy(tp.block_rows)[k])[inside]
    assert tp.k_blocks * tp.rows * tp.s < 2**31
    np.testing.assert_array_equal(np.sort(row), np.arange(tp.k_blocks * tp.rows))  # each row once
    # the s = 3 path stages a tile's rows in shared memory and stores them as one float4 run of
    # min(tile, rows - tile0) * s floats from (k * rows + tile0) * s: the runs tile the output
    kb, t0 = np.meshgrid(np.arange(tp.k_blocks), np.arange(0, tp.rows, tile), indexing="ij")
    start, length = ((kb * tp.rows + t0) * tp.s).ravel(), (np.minimum(tile, tp.rows - t0) * tp.s).ravel()
    assert tp.rows % rows_per_thread == 0 and np.all(start % 4 == 0) and np.all(length % 4 == 0)
    by_start = np.argsort(start)
    np.testing.assert_array_equal(start[by_start], np.concatenate([[0], np.cumsum(length[by_start])[:-1]]))
    assert length.sum() == tp.k_blocks * tp.rows * tp.s
    order = np.argsort(row)
    np.testing.assert_array_equal(valid[order], to_numpy(tp.valid_rows) > 0)
    nodes = to_numpy(tp.nodes_padded)
    np.testing.assert_array_equal(np.where(valid, nodes[row], 0)[order], nodes)  # padding rows hold node 0
    u = rng(14).standard_normal((tp.num_nodes, tp.s))
    out = np.zeros((tp.k_blocks * tp.rows, tp.s))
    out[row[valid]] = u[nodes[row[valid]]]  # padding rows are written as zeros, u unread
    assert np.array_equal(out.reshape(tp.padded_elements, tp.n, tp.s), to_numpy(tb.banded_gather(tp, torch.as_tensor(u))))


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


@pytest.mark.parametrize("shuffle", [False, True], ids=["box", "shuffled"])
def test_rcm_matches_jax(shuffle):
    jm, tm = jax_box(5), torch_box(5)
    if shuffle:
        perm = rng(11).permutation(tm.num_vertices)
        jm, _ = jax_reorder_mesh(jm, perm)
        tm, _ = reorder_mesh(tm, perm)
    np.testing.assert_array_equal(reverse_cuthill_mckee(tm), jax_rcm(jm))
    jr, jperm = jax_reorder_mesh(jm)
    tr, tperm = reorder_mesh(tm)
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
