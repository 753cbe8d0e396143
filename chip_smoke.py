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
  plain version for linear elasticity, Laplace and a ragged element count.

Every kernel check is ``max |kernel - plain| / max |plain| <= 1e-5`` (f32
roundoff: FMA contraction and summation order) with two launches bitwise
equal.  Each path runs with every launch counter set to 0 just before it
and read just after, and fails if its kernels were not launched.  Every
phase raises on failure.  The second-to-last line of standard output is
the per-kernel JSON record, the last line the device record.  Without a
CUDA device, or outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
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

SOURCES = {
    "structured_stencil": "fenris_tpu_torch/csrc/structured_stencil.cu",
    "dia_sweep": "fenris_tpu_torch/csrc/dia_sweep.cu",
    "stiffness_pairs": "fenris_tpu_torch/csrc/stiffness_pairs.cu",
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


def in_turns(run_k, run_p, reps=20):
    """Kernel and plain times in turns (plain, kernel, kernel, plain); the lower of each pair."""
    p1, k1, k2, p2 = (event_ms(run_p, reps), event_ms(run_k, reps), event_ms(run_k, reps), event_ms(run_p, reps))
    return min(k1, k2), min(p1, p2), f"kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms"


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
        log(f"time {name} cells={FULL}: {txt} ({smi})")
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
    log(f"time dia_sweep res={RES_A}: {txt}; bands streamed at {gbps:.1f} GB/s ({smi})")

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
    import torch

    from fenris_tpu_torch.optimize import NEWTON_CONVERGED

    asm_times, inner_times = [], []

    def timed(fn, times):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out

        return run

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
    del fresh, x64
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
    import fenris_tpu_torch.ops.dia_sweep as ds
    import fenris_tpu_torch.ops.stiffness_pairs as sp
    import fenris_tpu_torch.ops.structured_stencil as ss
    from fenris_tpu_torch.ops._build import load_library

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # -- card and build ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    load_library()
    log(f"build: {time.perf_counter() - t0:.3f} s (nvcc, sm_90a, {len(SOURCES)} sources in parallel)")

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
    path_a_solve(kernels, model, plan_s, dev, smi)
    log(f"phase path A: {time.perf_counter() - t0:.3f} s")
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
