#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fenris_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

It builds every kernel from ``fenris_tpu_torch/csrc`` (one nvcc per source,
all started together) and drives the port's three paths at full size:

* the structured Neo-Hookean Newton–Krylov solve (BASELINE config 5:
  128 x 128 x 64 = 1,048,576 hex8 cells, 3.25M dofs) through the stencil
  kernels: each kernel against its plain version at the full size and two
  ragged shapes, times, ``solve(preconditioner="mg")`` at the full size
  (||F|| / ||F0|| <= 1e-1, the pure-f32 floor) and ``solve_mixed`` at 32^3
  (relative ||F|| <= 1e-10);
* path A, the assembled block-DIA Neo-Hookean solve of
  tools/solve_assembled.py, uncut: res 149 = 3,307,949 hex8 cells,
  10,125,000 dofs, ``solve_mixed(assembled=True)`` with the band-sweep
  kernel in every CG iteration; plan time, assembly time and CG iterations
  per Newton step; an independent f64 model's relative residual <= 1e-10;
  the band sweep against its plain version on the full operator and on
  ragged ones; bitwise-repeatable bands and residuals;
* entry B, ``assemble_element_elliptic_matrices_pairs(kernel="auto")``
  (the JAX package's ``pallas="auto"``) on 970,299 hex8 cells (res 99),
  through the element-stiffness kernel, which is also held against its
  plain version for linear elasticity, Laplace and a ragged element count;
* path C, the matrix-free banded Neo-Hookean solve: C1 holds the banded
  gather and scatter, the fused banded tangent sweep (the CG operator:
  gather and tangent in one kernel) and the two element-minor sweeps
  against their plain versions at the res-149 padded layout (3,354,624
  padded elements) and on a res-7 box and an RCM-reordered res-11 box, the
  gather also bitwise against ``u[cells[perm]]``, and times the fused
  sweep in turns against the route it replaced (two gathers, then the
  element-minor tangent sweep); C2 runs
  ``HyperelasticModel(banded=True, fused_kernels=True).solve_mixed()`` on
  path A's problem (10,125,000 dofs) with Jacobi from
  ``hessian_diagonal``, checked by the independent f64 residual (<= 1e-10)
  and against path A's solution, with a fused sweep in every CG iteration
  and at most two gathers a Newton step; C3 RCM-reorders bench.py's unstructured
  box (res 63, 786,432 dofs), runs the f32 ``solve()`` on the fused model
  (||F|| / ||F0|| <= 1e-1) and holds one Hessian action of the unfused
  banded model (``torch.func.jvp`` through the gather/scatter pair) against
  the fused one (rel <= 5e-4), then times that ``jvp`` against
  ``torch.func.linearize`` once and its linear map per application, costed
  at the solve's CG iterations a Newton step.

Every kernel check is ``max |kernel - plain| / max |plain| <= 1e-5`` (f32
roundoff: FMA contraction and summation order) with two launches bitwise
equal.  Each path runs with every launch counter set to 0 just before it
and read just after, and fails if its kernels were not launched.  Every
phase raises on failure.  Each kernel's record carries its time, its
plain version's, one PyTorch library call's where one computes the same
function (else null), and its bound: the larger of its bytes over 3.35
TB/s and its f32 operations over 67 TFLOP/s (H100 SXM peaks), from this
run's inputs.  The card's ``nvidia-smi`` name and power limit are
printed on a line of their own; the second-to-last line of standard
output is the per-kernel JSON record, the last line the device record.
Without a CUDA device, or outside a checkout, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MU, LAM = 384.614, 576.923  # the flagship's (and tools/solve_assembled.py's) Lamé parameters
KERNEL_RTOL = 1e-5  # f32 roundoff: FMA contraction and summation order

# structured path
FULL = (128, 128, 64)
RAGGED = [(5, 4, 11), (15, 7, 5)]
# path A: tools/solve_assembled.py as it stands
RES_A = 149
CHUNK_A = 65536
BODY_A = (0.0, 0.0, -4.0)
# entry B: the element-stiffness kernel at 970,299 hex8 cells
RES_B = 99
RAGGED_B = 11  # 1,331 cells: not a multiple of the 64-element block
# path C: the matrix-free banded solve on path A's problem, kernel checks
# also on a res-7 box and an RCM-reordered res-11 box (two owner blocks of
# 1,024 nodes each), C3 at bench.py's unstructured size
RAGGED_C = [(7, False), (11, True)]
RES_C3 = 63

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per element (cell) and quadrature point that the functions
# need, counted from the kernels' source at the fewest the arithmetic allows
# (a multiply and an add are two, a division, reciprocal, comparison or
# log1p one): geometry J from node-relative coordinates 117 (7 terms an
# entry) + J^-1 and det 42 + basis gradients 120 + weight 1 = 280; grad u
# 135; Neo-Hookean kinematics (F, gamma, log1p, adjugate, det, F^-T, alpha)
# 78; stress P 27; tangent (tr(F^-1 dF) 17, F^-T dF^T 45, dF^-T 45, dP 46)
# 153; contraction (the stress scaled by the weight once 9, 24 sums of 3
# products 120, the sum over points 24) 153.  Plus, once an element, the
# node-relative coordinates: EM_OPS_PER_ELEMENT.  The structured stencils
# read a constant gradient table: grad u 135, kinematics 62, alpha 2, 1/det
# 1, then P 36 (residual) or dP 152 plus a second gradient 135 (Hessian
# action), contraction 153.
OPS_PER_QP = {
    "em_vector_sweep": 280 + 135 + 78 + 27 + 153,
    "em_vector_tangent_sweep": 280 + 2 * 135 + 78 + 153 + 153,
    "neo_hookean_residual": 135 + 62 + 2 + 1 + 36 + 153,
    "neo_hookean_hvp": 2 * 135 + 62 + 2 + 1 + 152 + 153,
}
EM_OPS_PER_ELEMENT = 21

SOURCES = {
    "structured_stencil": "fenris_tpu_torch/csrc/structured_stencil.cu",
    "dia_sweep": "fenris_tpu_torch/csrc/dia_sweep.cu",
    "stiffness_pairs": "fenris_tpu_torch/csrc/stiffness_pairs.cu",
    "banded": "fenris_tpu_torch/csrc/banded.cu",
    "em_sweep": "fenris_tpu_torch/csrc/em_sweep.cu",
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def event_ms(fn, reps=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def in_turns(run_k, run_p, reps=20, names=("kernel", "plain")):
    """Kernel and plain times in turns (plain, kernel, kernel, plain); the lower of each pair."""
    p1, k1, k2, p2 = (event_ms(run_p, reps), event_ms(run_k, reps), event_ms(run_k, reps), event_ms(run_p, reps))
    return min(k1, k2), min(p1, p2), f"{names[0]} {k1:.4f}/{k2:.4f} ms, {names[1]} {p1:.4f}/{p2:.4f} ms"


def compare(name, shape_txt, got, again, ref):
    """Kernel against plain: returns max |k - p|; raises past the limit or on a differing repeat."""
    import torch

    torch.cuda.synchronize()
    abs_err = float((got.double() - ref.double()).abs().max())
    rel = abs_err / float(ref.double().abs().max())
    same = bool(torch.equal(got, again))
    log(f"compare {name} {shape_txt}: max_abs_err={abs_err:.6e} rel={rel:.6e} "
        f"(limit {KERNEL_RTOL:g}) repeat_bitwise_equal={same}")
    check(bool(torch.isfinite(got).all()), f"{name} {shape_txt}: non-finite output")
    check(rel <= KERNEL_RTOL, f"{name} {shape_txt}: kernel vs plain rel {rel:.3e} > {KERNEL_RTOL:g}")
    check(same, f"{name} {shape_txt}: two launches on one input differ")
    return abs_err


def set_bound(k, nbytes, ops):
    """The least time the card could take: bytes over HBM bandwidth or f32 operations over peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    k["bound_ms"], k["bound_by"] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return f"bound {k['bound_ms']:.4f} ms by {k['bound_by']} ({nbytes / 1e9:.3f} GB, {ops / 1e9:.3f} GFLOP)"


def timed(fn, times):
    """``fn`` that appends its synchronised wall time to ``times``."""
    import torch

    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    return run


def ptxas_report(build_log):
    """Registers and spill bytes of the gather and tangent kernels, from the loaded library's
    ``-Xptxas -v`` log."""
    labels = {"banded_gather_kernelILi3E": "banded_gather (s = 3)",
              "tangent_kernelILb1E": "banded_tangent_sweep",
              "tangent_kernelILb0E": "em_vector_tangent_sweep (strided)"}
    if not build_log.is_file():
        log(f"ptxas: {build_log.name} not found (library built without a log); registers not reported")
        return
    label, found = None, {}
    for line in build_log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            label = next((v for k, v in labels.items() if k in m.group(1)), None)
        elif label and "spill stores" in line:
            found[label] = line.strip()
        elif label and "Used" in line and "registers" in line:
            found[label] = f"{line.split('info    :')[-1].strip()}; {found.get(label, '')}"
            label = None
    for name, txt in found.items():
        log(f"ptxas {name}: {txt}")


def reset_counts(kernels):
    for k in kernels.values():
        k["fn"].launches = 0


def free_memory():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


# -- structured path ------------------------------------------------------------


def flagship_model(cells, dtype, device, **kwargs):
    """The flagship model (fields of __graft_entry__._structured_model)."""
    import numpy as np

    from fenris_tpu_torch.solid import LameParameters, NeoHookeanMaterial
    from fenris_tpu_torch.structured import StructuredHyperelasticModel

    ncx, ncy, ncz = cells
    mask = np.zeros((ncz + 1) * (ncy + 1) * (ncx + 1) * 3, dtype=bool)
    mask[: (ncy + 1) * (ncx + 1) * 3] = True  # clamp the z = 0 node plane
    return StructuredHyperelasticModel(
        cells=cells,
        spacing=1.0 / max(cells),
        material=NeoHookeanMaterial(),
        params=LameParameters(mu=MU, lam=LAM),
        dirichlet_mask=mask,
        body_force=np.array([0.0, 0.0, -9.81]),
        dtype=dtype,
        device=device,
        **kwargs,
    )


def kernel_inputs(cells, device, seed=0):
    """u with displacement gradients ~1e-2 (u = 0.02 h U(-1, 1)) and v ~ N(0, 1)."""
    import torch

    h = 1.0 / max(cells)
    shape = (3, cells[2] + 1, cells[1] + 1, cells[0] + 1)
    g = torch.Generator(device=device).manual_seed(seed)
    u = (torch.rand(shape, generator=g, device=device) * 2.0 - 1.0) * (0.02 * h)
    v = torch.randn(shape, generator=g, device=device)
    return h, u, v


def structured_phases(kernels, dev, smi):
    import torch

    import fenris_tpu_torch.ops.structured_stencil as ss
    from fenris_tpu_torch.optimize import NEWTON_CONVERGED

    stencil = {n: k for n, k in kernels.items() if k["path"] == "structured"}
    # kernel against plain, on the card
    for cells in [FULL] + RAGGED:
        h, u, v = kernel_inputs(cells, dev)
        gp, w = ss.gp_table(h)
        for name, k in stencil.items():
            args = (u, v)[: k["nargs"]]
            got = k["fn"](*args, gp, w, MU, LAM)
            again = k["fn"](*args, gp, w, MU, LAM)
            err = compare(name, f"cells={cells}", got, again, k["plain"](*args, gp, w, MU, LAM))
            if cells == FULL:
                k["max_abs_err"] = err
        del u, v, got, again

    # times at full size
    h, u, v = kernel_inputs(FULL, dev, seed=1)
    gp, w = ss.gp_table(h)
    for name, k in stencil.items():
        args = (u, v)[: k["nargs"]]
        k["ms"], k["plain_ms"], txt = in_turns(
            lambda: k["fn"](*args, gp, w, MU, LAM), lambda: k["plain"](*args, gp, w, MU, LAM)
        )
        # inputs read and the output written once; no PyTorch call computes the stencils
        bound_txt = set_bound(k, (k["nargs"] + 1) * u.numel() * 4, OPS_PER_QP[name] * 8 * FULL[0] * FULL[1] * FULL[2])
        k["library_ms"] = None
        log(f"time {name} cells={FULL}: {txt}; {bound_txt} ({smi})")
    del u, v
    torch.cuda.synchronize()

    # the structured main path at full size
    model = flagship_model(FULL, torch.float32, dev)
    history = []

    def record(k, fn, cg):
        history.append(fn)
        cg_txt = "" if cg is None else f" cg_iters={cg.num_iterations} cg_status={cg.status}"
        log(f"  newton it {k}: |F|={fn:.6e}{cg_txt}")

    log(f"solve(mg) cells={FULL} dofs={model.num_dofs} f32:")
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = model.solve(
        preconditioner="mg", tolerance=1e-6, max_newton_iterations=4,
        cg_rel_tolerance=1e-5, cg_max_iter=200, callback=record,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k in stencil.values():
        k["launches"] = k["fn"].launches
    ratio = res.residual_norm / history[0]
    plain_model = flagship_model(FULL, torch.float32, dev, kernel=False)
    plain_ratio = float(torch.linalg.vector_norm(plain_model.residual(res.x))) / history[0]
    log(f"solve(mg): status={res.status} newton_iters={res.iterations} wall={wall:.3f} s "
        f"|F|/|F0|={ratio:.6e} plain-path |F|/|F0|={plain_ratio:.6e} "
        f"launches={{{', '.join(f'{n}: {k['launches']}' for n, k in stencil.items())}}} ({smi})")
    check(tuple(res.x.shape) == (model.num_dofs,), "solve: wrong result shape")
    check(bool(torch.isfinite(res.x).all()), "solve: non-finite displacement")
    check(all(b <= a for a, b in zip(history, history[1:])), f"solve: |F| not monotone: {history}")
    check(ratio <= 1e-1, f"solve: |F|/|F0| = {ratio:.3e} > 1e-1")
    check(plain_ratio <= 1e-1, f"solve: plain-path |F|/|F0| = {plain_ratio:.3e} > 1e-1")
    for name, k in stencil.items():
        check(k["launches"] > 0, f"solve: kernel {name} was not launched on the structured path")
    del model, plain_model, res

    # mixed precision at 32^3
    cells = (32, 32, 32)
    model = flagship_model(cells, torch.float32, dev)
    history = []
    log(f"solve_mixed(mg) cells={cells} dofs={model.num_dofs}:")
    t0 = time.perf_counter()
    res = model.solve_mixed(tolerance=1e-10, preconditioner="mg", callback=record)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rel = res.residual_norm / history[0]
    log(f"solve_mixed(mg): status={res.status} newton_iters={res.iterations} wall={wall:.3f} s "
        f"|F|/|F0|={rel:.6e} ({smi})")
    check(res.status == NEWTON_CONVERGED, f"solve_mixed: status {res.status}")
    check(bool(torch.isfinite(res.x).all()), "solve_mixed: non-finite displacement")
    check(rel <= 1e-10, f"solve_mixed: |F|/|F0| = {rel:.3e} > 1e-10")
    del model, res
    free_memory()


# -- path A: the assembled block-DIA solve -----------------------------------------


def assembled_model(res, dtype, device, chunk_size, **kwargs):
    """tools/solve_assembled.py's model: unit box, z = 0 clamped, body force (0, 0, -4)."""
    import numpy as np

    from fenris_tpu_torch.elasticity import HyperelasticModel
    from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d
    from fenris_tpu_torch.solid import LameParameters, NeoHookeanMaterial

    mesh = kwargs.pop("mesh", None) or create_unit_box_uniform_hex_mesh_3d(res)
    return HyperelasticModel(
        mesh=mesh,
        material=NeoHookeanMaterial(),
        params=LameParameters(mu=MU, lam=LAM),
        dirichlet_nodes=np.flatnonzero(mesh.points[:, 2] < 1e-12),
        body_force=np.array(BODY_A),
        dtype=dtype,
        device=device,
        chunk_size=chunk_size,
        **kwargs,
    )


def displacement(model, seed):
    """u = 0.01 h U(-1, 1) on the free dofs (h the cell size)."""
    import torch

    g = torch.Generator(device=model.device).manual_seed(seed)
    h = 1.0 / round(model.mesh.num_cells ** (1.0 / 3.0))
    u = (torch.rand(model.space.num_dofs, generator=g, device=model.device, dtype=model.dtype) * 2 - 1) * (0.01 * h)
    return torch.where(model.free_mask, u, 0.0)


def sweep_compare(m, shape_txt, dev, seed=0):
    """The band sweep (and the full operator) against the plain versions on one operator."""
    import torch

    import fenris_tpu_torch.ops.dia_sweep as ds
    from fenris_tpu_torch.sparse.block_dia import block_dia_matvec_cm
    from fenris_tpu_torch.sparse.dia_kernel import block_dia_operator

    g = torch.Generator(device=dev).manual_seed(seed)
    x2 = torch.randn((m.solution_dim, m.num_nodes), generator=g, device=dev)
    err = compare("dia_sweep", shape_txt, ds.dia_sweep(m.bands, m.offsets, x2),
                  ds.dia_sweep(m.bands, m.offsets, x2), ds.dia_sweep_plain(m.bands, m.offsets, x2))
    if m.remainder is not None:
        op = block_dia_operator(m, layout="component", kernel=True)
        compare("dia_sweep+remainder operator", shape_txt, op(x2), op(x2), block_dia_matvec_cm(m, x2))
    return err, x2


def csr_library_ms(m, x2, ref, smi):
    """Time of cuSPARSE's CSR product (``torch.sparse_csr_tensor @ x``) on the same operator.

    The yardstick only: the port never calls it.  Every band entry becomes a
    CSR entry (D*s per row, zero where the shifted column leaves [0, N)).
    """
    import torch

    D, s, N = len(m.offsets), m.solution_dim, m.num_nodes
    dev = x2.device
    cols_n = torch.arange(N, device=dev)[None, :] + torch.tensor(m.offsets, device=dev)[:, None]  # [D, N]
    inside = (cols_n >= 0) & (cols_n < N)
    vals = (m.bands.reshape(D, s, s, N) * inside[:, None, None, :]).permute(1, 3, 0, 2).reshape(-1)  # (i, n, d, j)
    cols = torch.arange(s, device=dev)[None, None, :] * N + cols_n.clamp(0, N - 1).T[:, :, None]  # [N, D, s]
    cols = cols[None].expand(s, N, D, s).reshape(-1)
    crow = torch.arange(s * N + 1, device=dev) * (D * s)
    A = torch.sparse_csr_tensor(crow, cols, vals, size=(s * N, s * N))
    del vals, cols, cols_n, inside
    x = x2.reshape(-1, 1)
    y = (A @ x).reshape(s, N)
    torch.cuda.synchronize()
    rel = float((y.double() - ref.double()).abs().max() / ref.double().abs().max())
    ms = min(event_ms(lambda: A @ x, reps=10), event_ms(lambda: A @ x, reps=10))
    log(f"library dia_sweep: cuSPARSE CSR product, nnz {A.values().numel()}: {ms:.4f} ms, rel vs kernel {rel:.3e} ({smi})")
    del A, y, ref
    free_memory()
    return ms


def path_a_setup(dev, smi):
    import torch

    t0 = time.perf_counter()
    model = assembled_model(RES_A, torch.float32, dev, CHUNK_A)
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = model.block_dia_plan()
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    expand = model.block_dia_expand_plan()
    torch.cuda.synchronize()
    t_expand = time.perf_counter() - t0
    log(f"path A model res={RES_A}: {model.mesh.num_cells} hex8, {model.space.num_dofs} dofs, "
        f"chunk {model.chunk_size}; model set-up {t_model:.3f} s; assembly plan {t_plan:.3f} s "
        f"(D={plan.num_diagonals}, rem_k={plan.rem_k}, fill={plan.fill:.4f}); expand plan {t_expand:.3f} s "
        f"(classes={expand.num_classes}, coverage={expand.coverage}) ({smi})")
    check(plan.num_diagonals == 27 and plan.rem_k == 0, "path A: the box operator must be exact 27-diagonal DIA")
    check(expand is not None and expand.slow_idx is None, "path A: the box must be one slot class")
    return model, t_plan + t_expand


def band_sweep_phases(k, model, dev, smi):
    """Kernel vs plain on the full res-149 operator and ragged ones; determinism of assembly and residual."""
    import torch

    import fenris_tpu_torch.ops.dia_sweep as ds
    from fenris_tpu_torch.assembly.local import assemble_element_elliptic_matrices
    from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d
    from fenris_tpu_torch.operators import LaplaceOperator
    from fenris_tpu_torch.sparse.block_dia import assemble_block_dia, band_expand_plan, block_dia_assembly_plan

    u = displacement(model, seed=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = model.assemble_hessian_block_dia(u)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    log(f"assembly at res {RES_A}: {t_asm:.3f} s, bands {tuple(m.bands.shape)} "
        f"({m.bands.numel() * 4 / 1e9:.3f} GB f32)")
    k["max_abs_err"], x2 = sweep_compare(m, f"res={RES_A} N={m.num_nodes} s=3 D={m.num_diagonals}", dev)
    k["ms"], k["plain_ms"], txt = in_turns(
        lambda: ds.dia_sweep(m.bands, m.offsets, x2), lambda: ds.dia_sweep_plain(m.bands, m.offsets, x2)
    )
    gbps = m.bands.numel() * 4 / (k["ms"] * 1e-3) / 1e9
    bound_txt = set_bound(k, (m.bands.numel() + 2 * x2.numel()) * 4, 2 * m.bands.numel())
    log(f"time dia_sweep res={RES_A}: {txt}; bands streamed at {gbps:.1f} GB/s; {bound_txt} ({smi})")
    k["library_ms"] = csr_library_ms(m, x2, ds.dia_sweep(m.bands, m.offsets, x2), smi)

    # determinism: bands and residuals bitwise repeatable
    again = model.assemble_hessian_block_dia(u)
    same_bands = bool(torch.equal(m.bands, again.bands))
    del again
    r1, r2 = model.residual(u), model.residual(u)
    model64 = assembled_model(RES_A, torch.float64, dev, 32768, mesh=model.mesh)
    u64 = u.double()
    r3, r4 = model64.residual(u64), model64.residual(u64)
    same_res = bool(torch.equal(r1, r2)) and bool(torch.equal(r3, r4))
    log(f"determinism at res {RES_A}: bands bitwise equal={same_bands}, "
        f"f32 and f64 residuals bitwise equal={same_res}")
    check(same_bands, "two band assemblies on one u differ")
    check(same_res, "two residuals on one u differ")
    del m, r1, r2, r3, r4, model64, u64, x2
    free_memory()

    # ragged operators: N not a multiple of the block, s = 1, a remainder
    small = assembled_model(6, torch.float32, dev, None)
    sweep_compare(small.assemble_hessian_block_dia(displacement(small, 4)), "res=6 N=343 s=3", dev, 1)
    sweep_compare(small.assemble_hessian_block_dia(displacement(small, 5), max_diagonals=20),
                  "res=6 N=343 s=3 max_diagonals=20 (remainder)", dev, 2)
    mesh = create_unit_box_uniform_hex_mesh_3d(8)
    lap = assembled_model(8, torch.float32, dev, None, mesh=mesh)
    plan1 = block_dia_assembly_plan(mesh.cells, mesh.num_vertices, 1, device=dev)
    A_el = assemble_element_elliptic_matrices(lap.space.X_geo, None, LaplaceOperator(), None, lap.tab)
    m1 = assemble_block_dia(plan1, A_el, expand=band_expand_plan(mesh.cells, plan1, device=dev))
    sweep_compare(m1, "res=8 N=729 s=1 (Laplace)", dev, 3)


def path_a_solve(kernels, model, plan_s, dev, smi):
    """Path A's solve and its independent f64 check; returns the f64 solution."""
    import torch

    from fenris_tpu_torch.optimize import NEWTON_CONVERGED

    asm_times, inner_times = [], []
    # instance attributes shadow the methods for this solve only
    model.assemble_hessian_block_dia = timed(model.assemble_hessian_block_dia, asm_times)
    model._assembled_cg = timed(model._assembled_cg, inner_times)
    history, cg_iters = [], []

    def record(k, fn, cg):
        history.append(fn)
        if cg is not None:
            cg_iters.append(cg.num_iterations)
        cg_txt = "" if cg is None else f" cg_iters={cg.num_iterations} cg_status={cg.status}"
        asm_txt = "" if cg is None else f" assembly={asm_times[-1]:.3f} s"
        log(f"  newton it {k}: |F|={fn:.6e}{cg_txt}{asm_txt}")

    log(f"path A: solve_mixed(assembled=True) res={RES_A} dofs={model.space.num_dofs}:")
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = model.solve_mixed(tolerance=1e-10, cg_rel_tolerance=1e-4, max_newton_iterations=30,
                            assembled=True, callback=record)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels["dia_sweep"]["fn"].launches
    kernels["dia_sweep"]["launches"] = launches
    del model.assemble_hessian_block_dia, model._assembled_cg
    peak = torch.cuda.max_memory_allocated() / 1e9
    t_asm, t_inner = sum(asm_times), sum(inner_times)
    log(f"path A: status={res.status} newton_iters={res.iterations} cg_iters={cg_iters} "
        f"assembly_s={[round(t, 3) for t in asm_times]} wall={wall:.3f} s (plan {plan_s:.3f} s before it) "
        f"|F|/|F0|={res.residual_norm / history[0]:.6e} dia_sweep launches={launches} "
        f"peak memory {peak:.2f} GB ({smi})")
    log(f"path A breakdown: assembly {t_asm:.3f} s, CG {t_inner - t_asm:.3f} s "
        f"({(t_inner - t_asm) / max(sum(cg_iters), 1) * 1e3:.3f} ms per iteration), "
        f"f64 residuals and Newton {wall - t_inner:.3f} s of {wall:.3f} s wall")
    check(res.status == NEWTON_CONVERGED, f"path A: status {res.status}")
    check(bool(torch.isfinite(res.x).all()), "path A: non-finite displacement")
    check(launches > 0, "path A: the band-sweep kernel was not launched")
    check(launches >= sum(cg_iters), f"path A: {launches} band sweeps for {sum(cg_iters)} CG iterations")

    # independent f64 check: a fresh model from the same fields (tools/solve_assembled.py:85-102)
    x64 = res.x.detach().double()
    del res
    free_memory()
    t0 = time.perf_counter()
    fresh = assembled_model(RES_A, torch.float64, dev, 8192, mesh=model.mesh)
    true_r = float(torch.linalg.vector_norm(fresh.residual(x64)))
    r0 = float(torch.linalg.vector_norm(fresh.residual(torch.zeros_like(x64))))
    uz_min = float(x64.reshape(-1, 3)[:, 2].min())
    log(f"path A independent f64 residual: {true_r:.6e} (r0 {r0:.6e}, rel {true_r / r0:.6e}, "
        f"tip uz min {uz_min:.6e}; {time.perf_counter() - t0:.3f} s)")
    check(true_r / r0 <= 1e-10, f"path A: independent relative residual {true_r / r0:.3e} > 1e-10")
    del fresh
    free_memory()
    return x64


# -- path C: the matrix-free banded solve -------------------------------------------------


def banded_kernel_checks(kernels, model, shape_txt, dev, seed, smi=None):
    """The banded-path kernels against their plain versions on one fused model's layout.

    With ``smi`` also times them (kernel, plain, library call) and sets
    their bounds, from these inputs, and times the fused tangent sweep
    against the route it replaced (two gathers, then the element-minor
    tangent sweep on the gathered rows).
    """
    import torch

    import fenris_tpu_torch.ops.banded as bd
    import fenris_tpu_torch.ops.em_sweep as es
    from fenris_tpu_torch.assembly.local_em import (
        assemble_element_elliptic_tangent_vectors_em,
        assemble_element_elliptic_vectors_em,
    )

    plan, X, tables = model._plan, model._X_band, model._em_tables
    op, params, tab = model.operator, model.params, model.tab
    N, n, pe = plan.num_nodes, plan.n, plan.padded_elements
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((N, 3), generator=g, device=dev)
    valid = plan.valid_rows > 0
    # padding rows nonzero, as on the main path (the sweep of the repeated
    # element): kernel and plain version must both drop them
    f_el = torch.randn((pe, n, 3), generator=g, device=dev)
    u = displacement(model, seed).reshape(N, 3)
    v = torch.randn((N, 3), generator=g, device=dev)
    u_em = bd.banded_gather(plan, u).permute(1, 2, 0)  # element-major rows, as the gather writes them
    v_em = bd.banded_gather(plan, v).permute(1, 2, 0)
    errs = {}

    # gather: bitwise equal to the plain version and to u[cells[perm]] on valid rows
    got, again, ref = bd.banded_gather(plan, w), bd.banded_gather(plan, w), bd.banded_gather_plain(plan, w)
    errs["banded_gather"] = compare("banded_gather", shape_txt, got, again, ref)
    cells_perm = torch.as_tensor(model.mesh.cells[plan.perm].reshape(-1), dtype=torch.int64, device=dev)
    exact = bool(torch.equal(got, ref)) and bool(torch.equal(got.reshape(-1, 3)[valid], w[cells_perm]))
    log(f"banded_gather {shape_txt}: bitwise equal to the plain version and to u[cells[perm]]: {exact}")
    check(exact, f"banded_gather {shape_txt}: not bitwise equal to u[cells[perm]]")
    del got, again, ref, cells_perm
    got, again, ref = bd.banded_scatter(plan, f_el), bd.banded_scatter(plan, f_el), bd.banded_scatter_plain(plan, f_el)
    errs["banded_scatter"] = compare("banded_scatter", shape_txt, got, again, ref)
    log(f"banded_scatter {shape_txt}: bitwise equal to the plain version (same row order): {bool(torch.equal(got, ref))}")
    del got, again, ref
    # the fused tangent sweep (the main path's CG operator) on the node vectors
    fused = lambda: es.banded_tangent_sweep(plan, X, u, v, op, params, tab, tables)  # noqa: E731
    errs["em_vector_tangent_sweep"] = compare(
        "banded_tangent_sweep", shape_txt, fused(), fused(), es.banded_tangent_sweep_plain(plan, X, u, v, op, params, tab))
    # the element-minor sweeps on element-major rows; on the small shapes contiguous element-minor arrays too
    layouts = [("element-major rows", u_em, v_em)]
    if smi is None:
        layouts.append(("element-minor", u_em.contiguous(), v_em.contiguous()))
    for layout, ue, ve in layouts:
        txt = f"{shape_txt} {layout}"
        errs["em_vector_sweep"] = compare(
            "em_vector_sweep", txt, es.em_vector_sweep(X, ue, op, params, tab, tables),
            es.em_vector_sweep(X, ue, op, params, tab, tables),
            assemble_element_elliptic_vectors_em(X, ue, op, params, tab))
        compare("em_vector_tangent_sweep", txt, es.em_vector_tangent_sweep(X, ue, ve, op, params, tab, tables),
                es.em_vector_tangent_sweep(X, ue, ve, op, params, tab, tables),
                assemble_element_elliptic_tangent_vectors_em(X, ue, ve, op, params, tab))
    free_memory()
    if smi is None:
        return
    for name, err in errs.items():
        kernels[name]["max_abs_err"] = err
    q, nv = tab.num_points, plan.node_rows.numel()  # nv: the valid rows
    idx = plan.nodes_padded.long()
    # index_add_'s padding rows go to 4096 spare rows past the N nodes (spread, so its atomics do not
    # pile onto one address)
    spare = torch.arange(pe * n, device=dev) % 4096 + N
    idx_spare = torch.where(valid, idx, spare)
    # bytes the functions need: the gather reads u, the valid rows' node indices and the per-block
    # row counts and writes every row (padding rows are zeros); the scatter reads the valid rows
    # and its CSR map and writes the nodes
    runs = {
        "banded_gather": (lambda: bd.banded_gather(plan, w), lambda: bd.banded_gather_plain(plan, w),
                          lambda: torch.index_select(w, 0, idx),
                          (pe * n * 3 + nv + plan.block_rows.numel() + N * 3) * 4, 0),
        "banded_scatter": (lambda: bd.banded_scatter(plan, f_el), lambda: bd.banded_scatter_plain(plan, f_el),
                           lambda: torch.zeros((N + 4096, 3), device=dev).index_add_(0, idx_spare,
                                                                                     f_el.reshape(-1, 3)),
                           (nv * 3 + plan.row_ptr.numel() + nv + N * 3) * 4, nv * 3),
        # the element-minor vector sweep cannot tell padding elements from others: all pe are its work
        "em_vector_sweep": (lambda: es.em_vector_sweep(X, u_em, op, params, tab, tables),
                            lambda: assemble_element_elliptic_vectors_em(X, u_em, op, params, tab), None,
                            (X.numel() + 2 * u_em.numel()) * 4,
                            (OPS_PER_QP["em_vector_sweep"] * q + EM_OPS_PER_ELEMENT) * pe),
        # the fused sweep: the valid elements' X and node indices, u and v read once, every row written
        # once; the arithmetic of the valid elements only (a padding element's rows are zeros)
        "em_vector_tangent_sweep": (fused, lambda: es.banded_tangent_sweep_plain(plan, X, u, v, op, params, tab),
                                    None, (3 * nv + nv + plan.block_rows.numel() + 2 * N * 3 + pe * n * 3) * 4,
                                    (OPS_PER_QP["em_vector_tangent_sweep"] * q + EM_OPS_PER_ELEMENT)
                                    * plan.num_elements),
    }
    for name, (run_k, run_p, run_lib, nbytes, ops) in runs.items():
        k = kernels[name]
        reps = 20 if name.startswith("banded") else 5
        k["ms"], k["plain_ms"], txt = in_turns(run_k, run_p, reps=reps)
        k["library_ms"] = None
        if run_lib is not None:
            k["library_ms"] = min(event_ms(run_lib, reps), event_ms(run_lib, reps))
            txt += f", library {k['library_ms']:.4f} ms"
            if name == "banded_gather":
                txt += f" (kernel faster than index_select: {k['ms'] < k['library_ms']})"
        log(f"time {name} {shape_txt}: {txt}; {set_bound(k, nbytes, ops)} ({smi})")
        free_memory()

    # the fused sweep against the route it replaced, in turns: two gathers, then the element-minor
    # tangent sweep on the gathered element-major rows
    def old_route():
        ue, ve = (bd.banded_gather(plan, a).permute(1, 2, 0) for a in (u, v))
        return es.em_vector_tangent_sweep(X, ue, ve, op, params, tab, tables)

    fused_ms, old_ms, txt = in_turns(fused, old_route, reps=10, names=("fused", "old route"))
    strided_ms = min(event_ms(lambda: es.em_vector_tangent_sweep(X, u_em, v_em, op, params, tab, tables), 10)
                     for _ in range(2))
    log(f"time banded_tangent_sweep {shape_txt}: {txt} (fused faster: {fused_ms < old_ms}); the element-minor "
        f"tangent sweep alone on element-major rows {strided_ms:.4f} ms ({smi})")
    free_memory()


def path_c_kernels(kernels, model, dev, smi):
    """C1: the kernels at the res-149 layout (timed), then on the ragged boxes."""
    import torch

    from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d
    from fenris_tpu_torch.mesh.reorder import reorder_mesh

    plan = model._plan
    banded_kernel_checks(kernels, model, f"res={RES_A} E_pad={plan.padded_elements} blocks={plan.k_blocks}", dev, 11,
                         smi)
    for res, rcm in RAGGED_C:
        mesh = create_unit_box_uniform_hex_mesh_3d(res)
        if rcm:
            mesh, _ = reorder_mesh(mesh)
        small = assembled_model(res, torch.float32, dev, None, mesh=mesh, banded=True, fused_kernels=True,
                                banded_r_nodes=1024)
        p = small._plan
        banded_kernel_checks(kernels, small, f"res={res}{' rcm' if rcm else ''} E={small.mesh.num_cells} "
                             f"E_pad={p.padded_elements} blocks={p.k_blocks}", dev, 12 + res)


def path_c_solve(kernels, model, plan_s, x_a, dev, smi):
    """C2: solve_mixed on the fused banded model at res 149; the independent f64 check."""
    import torch

    from fenris_tpu_torch.optimize import NEWTON_CONVERGED

    inner_times, diag_times = [], []
    # instance attributes shadow the methods for this solve only
    model._matrix_free_cg = timed(model._matrix_free_cg, inner_times)
    model.hessian_diagonal = timed(model.hessian_diagonal, diag_times)
    history, cg_iters = [], []

    def record(k, fn, cg):
        history.append(fn)
        if cg is not None:
            cg_iters.append(cg.num_iterations)
        cg_txt = "" if cg is None else (f" cg_iters={cg.num_iterations} cg_status={cg.status} "
                                        f"diag={diag_times[-1]:.3f} s inner={inner_times[-1]:.3f} s")
        log(f"  newton it {k}: |F|={fn:.6e}{cg_txt}")

    path = ("banded_gather", "banded_scatter", "em_vector_tangent_sweep")
    log(f"path C2: solve_mixed(banded=True, fused_kernels=True) res={RES_A} dofs={model.space.num_dofs}:")
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = model.solve_mixed(tolerance=1e-10, cg_rel_tolerance=1e-4, max_newton_iterations=30, callback=record)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: kernels[name]["fn"].launches for name in path}
    for name in path:
        kernels[name]["launches"] = launches[name]
    del model._matrix_free_cg, model.hessian_diagonal
    peak = torch.cuda.max_memory_allocated() / 1e9
    t_inner, t_diag, iters = sum(inner_times), sum(diag_times), max(sum(cg_iters), 1)
    log(f"path C2: status={res.status} newton_iters={res.iterations} cg_iters={cg_iters} wall={wall:.3f} s "
        f"(plan {plan_s:.3f} s before it) |F|/|F0|={res.residual_norm / history[0]:.6e} launches={launches} "
        f"em_vector_sweep launches={kernels['em_vector_sweep']['fn'].launches} peak memory {peak:.2f} GB ({smi})")
    log(f"path C2 breakdown: Jacobi diagonals {t_diag:.3f} s, CG {t_inner - t_diag:.3f} s "
        f"({(t_inner - t_diag) / iters * 1e3:.3f} ms per iteration), "
        f"f64 residuals and Newton {wall - t_inner:.3f} s of {wall:.3f} s wall")
    check(res.status == NEWTON_CONVERGED, f"path C2: status {res.status}")
    check(bool(torch.isfinite(res.x).all()), "path C2: non-finite displacement")
    for name in path:
        check(launches[name] > 0, f"path C2: kernel {name} was not launched")
    check(launches["em_vector_tangent_sweep"] >= sum(cg_iters),
          f"path C2: {launches['em_vector_tangent_sweep']} tangent sweeps for {sum(cg_iters)} CG iterations")
    # the fused operator reads u and v itself: the gather runs for the Jacobi diagonal only
    check(launches["banded_gather"] <= 2 * len(cg_iters),
          f"path C2: {launches['banded_gather']} gathers for {len(cg_iters)} Newton steps (limit 2 a step)")

    x64 = res.x.detach().double()
    del res
    free_memory()
    t0 = time.perf_counter()
    fresh = assembled_model(RES_A, torch.float64, dev, 8192, mesh=model.mesh)
    true_r = float(torch.linalg.vector_norm(fresh.residual(x64)))
    r0 = float(torch.linalg.vector_norm(fresh.residual(torch.zeros_like(x64))))
    diff = float(torch.linalg.vector_norm(x64 - x_a) / torch.linalg.vector_norm(x_a))
    log(f"path C2 independent f64 residual: {true_r:.6e} (r0 {r0:.6e}, rel {true_r / r0:.6e}); "
        f"relative difference from path A's solution {diff:.6e}; {time.perf_counter() - t0:.3f} s")
    check(true_r / r0 <= 1e-10, f"path C2: independent relative residual {true_r / r0:.3e} > 1e-10")
    del fresh, x64
    free_memory()


def path_c3(kernels, dev, smi):
    """C3: the f32 solve() on the RCM-reordered res-63 box; the unfused Hessian action."""
    import torch

    from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d
    from fenris_tpu_torch.mesh.reorder import reorder_mesh

    t0 = time.perf_counter()
    mesh, _ = reorder_mesh(create_unit_box_uniform_hex_mesh_3d(RES_C3))
    t_reorder = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = assembled_model(RES_C3, torch.float32, dev, None, mesh=mesh, banded=True, fused_kernels=True)
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    plan = model._plan
    log(f"path C3 res={RES_C3}: {mesh.num_cells} hex8, {model.space.num_dofs} dofs; RCM {t_reorder:.3f} s; "
        f"model with banded plan {t_model:.3f} s (blocks={plan.k_blocks}, E_pad={plan.padded_elements}, "
        f"window {plan.wa} x 128 nodes)")
    history, cg_iters = [], []

    def record(k, fn, cg):
        history.append(fn)
        if cg is not None:
            cg_iters.append(cg.num_iterations)
        cg_txt = "" if cg is None else f" cg_iters={cg.num_iterations} cg_status={cg.status}"
        log(f"  newton it {k}: |F|={fn:.6e}{cg_txt}")

    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = model.solve(max_newton_iterations=4, cg_rel_tolerance=1e-4, callback=record)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k9 = kernels["em_vector_sweep"]
    k9["launches"] = k9["fn"].launches
    ratio = res.residual_norm / history[0]
    log(f"path C3 solve(): status={res.status} newton_iters={res.iterations} wall={wall:.3f} s "
        f"|F|/|F0|={ratio:.6e} em_vector_sweep launches={k9['launches']} ({smi})")
    check(tuple(res.x.shape) == (model.space.num_dofs,) and bool(torch.isfinite(res.x).all()),
          "path C3: wrong or non-finite displacement")
    check(ratio <= 1e-1, f"path C3: |F|/|F0| = {ratio:.3e} > 1e-1")
    check(k9["launches"] > 0, "path C3: the vector-sweep kernel was not launched")

    # the unfused banded route: torch.func.jvp through the gather/scatter pair
    unfused = assembled_model(RES_C3, torch.float32, dev, None, mesh=mesh, banded=True)
    g = torch.Generator(device=dev).manual_seed(21)
    v = torch.randn(model.space.num_dofs, generator=g, device=dev)
    hv_fused = model.hessian_vector_product(res.x, v)
    before = kernels["banded_gather"]["fn"].launches
    hv_jvp = unfused.hessian_vector_product(res.x, v)
    torch.cuda.synchronize()
    rel = float((hv_jvp - hv_fused).abs().max() / hv_fused.abs().max())
    gathers = kernels["banded_gather"]["fn"].launches - before
    log(f"path C3 unfused Hessian action (torch.func.jvp, {gathers} gather launches) vs fused: rel {rel:.6e} "
        f"(limit 5e-4)")
    check(gathers > 0, "path C3: the unfused Hessian action did not go through the gather kernel")
    check(rel <= 5e-4, f"path C3: unfused vs fused Hessian action rel {rel:.3e} > 5e-4")
    unfused_operator_choice(unfused, res.x, v, hv_jvp, cg_iters, smi)
    del model, unfused, res
    free_memory()


def unfused_operator_choice(model, u, v, hv_jvp, cg_iters, smi):
    """The unfused CG operator: ``jvp`` per application (what ``hessian_operator`` does) against
    ``torch.func.linearize`` once per Newton step and its linear map per application (what the
    JAX package does), costed at C3's CG iterations a step."""
    import torch

    free = model.free_mask
    t_jvp = event_ms(lambda: model.hessian_vector_product(u, v), reps=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, lin = torch.func.linearize(model.internal_forces, u)
    torch.cuda.synchronize()
    t_trace = (time.perf_counter() - t0) * 1e3
    apply_lin = lambda: torch.where(free, lin(torch.where(free, v, 0.0)), v)  # noqa: E731
    rel = float((apply_lin() - hv_jvp).abs().max() / hv_jvp.abs().max())
    t_lin = event_ms(apply_lin, reps=5)
    check(rel <= KERNEL_RTOL, f"path C3: linearized vs jvp Hessian action rel {rel:.3e} > {KERNEL_RTOL:g}")
    k = sum(cg_iters) / max(len(cg_iters), 1)
    even = t_trace / (t_jvp - t_lin) if t_jvp > t_lin else float("inf")
    log(f"path C3 unfused operator res={RES_C3}: jvp {t_jvp:.4f} ms an application; linearize {t_trace:.3f} ms "
        f"once, then {t_lin:.4f} ms an application (rel {rel:.6e} from jvp); at {k:.1f} CG iterations a Newton "
        f"step: jvp {k * t_jvp:.3f} ms, linearize {t_trace + k * t_lin:.3f} ms; break-even {even:.1f} "
        f"iterations ({smi})")
    del lin
    free_memory()


# -- entry B: element stiffness ----------------------------------------------------------


def stiffness_phases(kernels, dev, smi):
    import numpy as np
    import torch

    import fenris_tpu_torch.ops.stiffness_pairs as sp
    from fenris_tpu_torch.assembly.local import assemble_element_elliptic_matrices_pairs, tabulate
    from fenris_tpu_torch.fem import FemSpace
    from fenris_tpu_torch.mesh import Mesh
    from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d
    from fenris_tpu_torch.operators import LaplaceOperator
    from fenris_tpu_torch.quadrature import canonical_stiffness
    from fenris_tpu_torch.reference_elements import HEX8
    from fenris_tpu_torch.solid import LameParameters, LinearElasticMaterial, MaterialEllipticOperator

    k = kernels["stiffness_pairs"]
    tab = tabulate(HEX8, canonical_stiffness("hex8"))
    cases = {
        "linear": (MaterialEllipticOperator(LinearElasticMaterial(), dim=3), LameParameters(mu=MU, lam=LAM)),
        "laplace": (LaplaceOperator(), None),
    }
    ragged = create_unit_box_uniform_hex_mesh_3d(RAGGED_B)
    pts = ragged.points + np.random.default_rng(0).uniform(-0.2, 0.2, ragged.points.shape) / RAGGED_B
    Xr = FemSpace.create(Mesh(pts, ragged.cells, HEX8), 3, torch.float32, dev).X_geo
    for name, (op, params) in cases.items():
        compare("stiffness_pairs", f"{name} E={Xr.shape[0]} (perturbed)", sp.stiffness_pairs(Xr, op, params, tab),
                sp.stiffness_pairs(Xr, op, params, tab), sp.stiffness_pairs_plain(Xr, op, params, tab))
    X = FemSpace.create(create_unit_box_uniform_hex_mesh_3d(RES_B), 3, torch.float32, dev).X_geo
    E = X.shape[0]
    for name, (op, params) in cases.items():
        got = sp.stiffness_pairs(X, op, params, tab)
        again = sp.stiffness_pairs(X, op, params, tab)
        ref = sp.stiffness_pairs_plain(X, op, params, tab)
        err = compare("stiffness_pairs", f"{name} res={RES_B} E={E} out {got.numel() * 4 / 1e9:.3f} GB", got, again, ref)
        del got, again, ref
        free_memory()
        ms, plain_ms, txt = in_turns(
            lambda: sp.stiffness_pairs(X, op, params, tab), lambda: sp.stiffness_pairs_plain(X, op, params, tab), reps=5
        )
        log(f"time stiffness_pairs {name} res={RES_B}: {txt}; {E / (ms * 1e-3) / 1e6:.1f} M elements/s ({smi})")
        if name == "linear":
            k["max_abs_err"], k["ms"], k["plain_ms"] = err, ms, plain_ms
            # X read and the pairs written once; operations of the projector
            # products, 2 n^2 (d^2 q) per element and unique (i <= j) pair
            q = tab.num_points
            log(f"stiffness_pairs linear res={RES_B}: "
                + set_bound(k, (X.numel() + 9 * 64 * E) * 4, 2 * 64 * 9 * q * 6 * E))
            k["library_ms"] = None
        free_memory()

    # entry B: the public element-stiffness entry point with kernel="auto"
    op, params = cases["linear"]
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    A = assemble_element_elliptic_matrices_pairs(X, None, op, params, tab, kernel="auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k["launches"] = k["fn"].launches
    log(f"entry B: assemble_element_elliptic_matrices_pairs(kernel='auto') res={RES_B}: {tuple(A.shape)} in "
        f"{wall * 1e3:.3f} ms, stiffness_pairs launches={k['launches']} ({smi})")
    check(tuple(A.shape) == (9, 64, E) and bool(torch.isfinite(A).all()), "entry B: wrong or non-finite output")
    check(k["launches"] > 0, "entry B: the stiffness kernel was not launched")
    del A, X
    free_memory()


def main() -> int:
    if not (ROOT / "fenris_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: fenris_tpu_torch/ not found next to this script; run it in a checkout")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures the port on a GPU")
    sys.path.insert(0, str(ROOT))
    import fenris_tpu_torch.ops.banded as bd
    import fenris_tpu_torch.ops.dia_sweep as ds
    import fenris_tpu_torch.ops.em_sweep as es
    import fenris_tpu_torch.ops.stiffness_pairs as sp
    import fenris_tpu_torch.ops.structured_stencil as ss
    from fenris_tpu_torch.ops._build import build_log, load_library
    from fenris_tpu_torch.ops.banded import make_banded_plan

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # -- card and build ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    load_library()
    log(f"build: {time.perf_counter() - t0:.3f} s (nvcc, sm_90a, {len(SOURCES)} sources in parallel)")
    ptxas_report(build_log())

    kernels = {
        "neo_hookean_residual": dict(
            fn=ss.neo_hookean_residual, plain=ss.neo_hookean_residual_plain, nargs=1, path="structured",
            source=SOURCES["structured_stencil"], replaces="fenris_tpu/ops/structured_stencil.py:421",
        ),
        "neo_hookean_hvp": dict(
            fn=ss.neo_hookean_hvp, plain=ss.neo_hookean_hvp_plain, nargs=2, path="structured",
            source=SOURCES["structured_stencil"], replaces="fenris_tpu/ops/structured_stencil.py:319",
        ),
        "dia_sweep": dict(
            fn=ds.dia_sweep, path="A", source=SOURCES["dia_sweep"],
            replaces="fenris_tpu/sparse/dia_kernel.py:380 and fenris_tpu/sparse/dia_kernel.py:186",
        ),
        "stiffness_pairs": dict(
            fn=sp.stiffness_pairs, path="B", source=SOURCES["stiffness_pairs"],
            replaces="fenris_tpu/ops/stiffness_kernel.py:162",
        ),
        "banded_gather": dict(
            fn=bd.banded_gather, path="C", source=SOURCES["banded"], replaces="fenris_tpu/ops/banded.py:285",
        ),
        "banded_scatter": dict(
            fn=bd.banded_scatter, path="C", source=SOURCES["banded"], replaces="fenris_tpu/ops/banded.py:346",
        ),
        # the tangent sweep as the main path launches it: fused with the banded gather
        "em_vector_tangent_sweep": dict(
            fn=es.banded_tangent_sweep, path="C", source=SOURCES["em_sweep"],
            replaces="fenris_tpu/ops/em_sweep.py:251",
        ),
        "em_vector_sweep": dict(
            fn=es.em_vector_sweep, path="C", source=SOURCES["em_sweep"], replaces="fenris_tpu/ops/em_sweep.py:233",
        ),
    }
    phases = [
        ("structured path", lambda: structured_phases(kernels, dev, smi)),
        ("entry B", lambda: stiffness_phases(kernels, dev, smi)),
    ]
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        log(f"phase {name}: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    model, plan_s = path_a_setup(dev, smi)
    band_sweep_phases(kernels["dia_sweep"], model, dev, smi)
    log(f"phase band sweep and determinism: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    x_a = path_a_solve(kernels, model, plan_s, dev, smi)
    log(f"phase path A: {time.perf_counter() - t0:.3f} s")
    del model
    free_memory()

    t0 = time.perf_counter()
    model = assembled_model(RES_A, torch.float32, dev, None, banded=True, fused_kernels=True)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    plan = model._plan
    t0 = time.perf_counter()
    make_banded_plan(model.mesh.cells, plan.num_nodes, 3, r_nodes=model.banded_r_nodes, device=dev)
    torch.cuda.synchronize()
    log(f"path C model res={RES_A}: set-up {plan_s:.3f} s; the banded plan alone, built again, "
        f"{time.perf_counter() - t0:.3f} s (blocks={plan.k_blocks}, E_pad={plan.padded_elements}, "
        f"rows/block={plan.rows}, window {plan.wa} x 128 nodes, chunk {model.chunk_size})")
    t0 = time.perf_counter()
    path_c_kernels(kernels, model, dev, smi)
    log(f"phase path C1: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    path_c_solve(kernels, model, plan_s, x_a, dev, smi)
    log(f"phase path C2: {time.perf_counter() - t0:.3f} s")
    del model, x_a
    free_memory()
    t0 = time.perf_counter()
    path_c3(kernels, dev, smi)
    log(f"phase path C3: {time.perf_counter() - t0:.3f} s")
    log(f"total: {time.perf_counter() - t_start:.3f} s ({smi})")

    record_line = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": k["source"],
                "replaces": k["replaces"],
                "launches": k["launches"],
                "max_abs_err": k["max_abs_err"],
                "ms": k["ms"],
                "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"],
                "library_ms": k["library_ms"],
            }
            for name, k in kernels.items()
        ]
    }
    print(json.dumps(record_line), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
