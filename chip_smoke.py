#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fenris_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

It builds every kernel from ``fenris_tpu_torch/csrc`` (one nvcc per source,
all started together), runs the card tests (``tests/test_torch_cuda.py``,
JAX-free, in a pytest subprocess without ``tests/conftest.py``; every test
must pass and none skip) and drives the port's three paths at full size:

* the structured Neo-Hookean Newton–Krylov solve (BASELINE config 5:
  128 x 128 x 64 = 1,048,576 hex8 cells, 3.25M dofs) through the stencil
  kernels (one z-marching body, ``nh_march``): each kernel against its
  plain version at the full size and four ragged shapes down to one cell,
  each also for one launch that allocates only its output, times,
  ``solve(preconditioner="mg")`` at the full size
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
  plain version for linear elasticity, Laplace and a ragged element count,
  and, with the plain version, against an f64 evaluation of the same f32
  coordinates;
* a CG-count diagnostic at res 80: the first Newton step's CG iterations
  on seven operators (assembled f32 with the band-sweep kernel and with
  the plain band matvec, the fused matrix-free kernel and its plain
  version, assembled in f64, f64 element matrices in f32 bands, and the
  f32 assembly with node-relative J); and the f64 banded model (plain
  gather and scatter on the card) against the unbanded one;
* path C, the matrix-free banded Neo-Hookean solve: C1 holds the banded
  gather and scatter, the fused banded tangent sweep (the CG operator:
  gather and tangent in one kernel), the fused banded vector sweep (the
  residual: gather and internal forces in one kernel; padding rows zero)
  and the two element-minor sweeps against their plain versions at the
  res-149 padded layout (3,354,624 padded elements) and on a res-7 box and
  an RCM-reordered res-11 box, the gather also bitwise against
  ``u[cells[perm]]``, and times each fused sweep in turns against the
  route it replaced (gathers, then the element-minor sweep); C2 runs
  ``HyperelasticModel(banded=True, fused_kernels=True).solve_mixed()`` on
  path A's problem (10,125,000 dofs) with Jacobi from
  ``hessian_diagonal``, checked by the independent f64 residual (<= 1e-10)
  and against path A's solution, with a fused sweep in every CG iteration
  and at most two gathers a Newton step; C3 RCM-reorders bench.py's unstructured
  box (res 63, 786,432 dofs), runs the f32 ``solve()`` on the fused model
  (||F|| / ||F0|| <= 1e-1), checks that one residual launches the fused
  vector sweep and no gather, times that sweep against the route it
  replaced at this layout, and holds one Hessian action of the unfused
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
run's inputs.  ``ptxas`` lines (registers, shared memory, spills) of the
stencil, gather, sweep and stiffness kernels are printed, and a spill in
any of them fails the run.  The card's ``nvidia-smi`` name and power limit are
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
# ragged: a tile, a slab and the last node on each axis of the Hessian-action kernel (32 x 10 nodes,
# 13 layers a block), and a one-cell grid
RAGGED = [(5, 4, 11), (15, 7, 5), (33, 9, 17), (1, 1, 1)]
# path A: tools/solve_assembled.py as it stands
RES_A = 149
CHUNK_A = 65536
BODY_A = (0.0, 0.0, -4.0)
# entry B: the element-stiffness kernel at 970,299 hex8 cells
RES_B = 99
RAGGED_B = 11  # 1,331 cells: not a multiple of the kernel's 32-element block
# path C: the matrix-free banded solve on path A's problem, kernel checks
# also on a res-7 box and an RCM-reordered res-11 box (two owner blocks of
# 1,024 nodes each), C3 at bench.py's unstructured size
RAGGED_C = [(7, False), (11, True)]
RES_C3 = 63
RES_DIAG = 80  # the CG-count diagnostic: 512,000 cells, 1,594,323 dofs
CARD_TESTS_TIMEOUT_S = 300

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
# node-relative coordinates: EM_OPS_PER_ELEMENT.  The structured stencils:
# stencil_ops.
OPS_PER_QP = {
    "em_vector_sweep": 280 + 135 + 78 + 27 + 153,
    "em_vector_tangent_sweep": 280 + 2 * 135 + 78 + 153 + 153,
}
EM_OPS_PER_ELEMENT = 21


def stencil_ops(cells, hvp):
    """f32 operations of the structured residual (``hvp=False``) or Hessian action on ``cells`` hex8
    cells of a uniform grid, the fewer of two forms.  Per cell and point, in both: kinematics (F, gamma,
    log1p, adjugate, det) 62, alpha 2, 1/det 1, then the weighted stress w P 30 (the weight folded into
    its two scalar factors, w alpha / det 2 and w mu 1, then 9 entries of a product and a multiply-add)
    or its tangent w dP 155 (dP 152 and the weight folded into its three scalar factors mu, ca, cb 3).
    Dense form, per point: the gradient from the constant table, 135 a field (9 sums of 8 products), and
    the contraction 144 (24 sums of 3 products 120, the sum over points 24).  Tensor-product form (what
    the stencil kernels do), per cell: the gradient at all 8 points 252 a field (for each derivative and
    component 4 edge differences, then two 1-D interpolations of 4 values at 3 operations each: 28), and
    the contraction 300 (the sums of point pairs into the 36-entry adjoint table 36, its two adjoint
    interpolations 216, the signed sums of 3 edge values into the 24 node values 48)."""
    fields, stress = (2, 155) if hvp else (1, 30)
    point = 62 + 2 + 1 + stress
    dense = 8 * (fields * 135 + point + 144)
    tensor_product = fields * 252 + 8 * point + 300
    return cells * min(dense, tensor_product)


def stiffness_ops(E, m, n, q, s, sym):
    """f32 operations of the element-stiffness function for hex-type elements (d = 3), the fewest its
    arithmetic allows.  Per element and point: J from node-relative coordinates d^2 (2m - 3), J^-1 and
    det 42, the weight 1, the gradients G = dphi J^-1 n d (2d - 1), G scaled by w|det| n d; per element
    the node-relative coordinates (m - 1) d.  Then the fewer of two forms of the block entries needed
    (all n^2 of an off-diagonal pair, the n (n + 1) / 2 upper ones of a symmetric operator's diagonal
    pair): per point t = (w|det| G) C^ij, P n d (2d - 1), and t . G summed over points and d, 2 q d - 1
    an entry; or, as the kernel does, M_ab = sum_q w|det| G_a G_b^T once per node pair a <= b,
    d^2 (2q - 1), and C^ij : M, 2 d^2 - 1 an entry."""
    d = 3
    pairs = s * (s + 1) // 2 if sym else s * s
    entries = (s * (s - 1) // 2 * n * n + s * n * (n + 1) // 2) if sym else s * s * n * n
    geometry = q * (d * d * (2 * m - 3) + 42 + 1 + n * d * (2 * d - 1) + n * d) + (m - 1) * d
    per_point = q * pairs * n * d * (2 * d - 1) + entries * (2 * q * d - 1)
    node_pairs = n * (n + 1) // 2 * d * d * (2 * q - 1) + entries * (2 * d * d - 1)
    return E * (geometry + min(per_point, node_pairs))


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


# mangled-name fragment -> label of the kernels ptxas_report reads (the stiffness kernels by pattern)
PTXAS_LABELS = {"nh_marchILb1E": "neo_hookean_hvp (nh_march<true>)",
                "nh_marchILb0E": "neo_hookean_residual (nh_march<false>)",
                "banded_gather_kernelILi3E": "banded_gather (s = 3)",
                "sweep_kernelILb1ELb1E": "banded_tangent_sweep (sweep_kernel<true, true>)",
                "sweep_kernelILb1ELb0E": "banded_vector_sweep (sweep_kernel<true, false>)",
                "sweep_kernelILb0ELb1E": "em_vector_tangent_sweep (sweep_kernel<false, true>, strided)",
                "sweep_kernelILb0ELb0E": "em_vector_sweep (sweep_kernel<false, false>, strided)"}


def ptxas_report(build_log):
    """Registers, shared memory and spill bytes of the stencil, gather, sweep and stiffness kernels,
    from the loaded library's ``-Xptxas -v`` log; returns ``{label: ptxas text}``."""
    if not build_log.is_file():
        log(f"ptxas: {build_log.name} not found (library built without a log); registers not reported")
        return {}
    label, found = None, {}
    for line in build_log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            label = next((v for k, v in PTXAS_LABELS.items() if k in m.group(1)), None)
            st = re.search(r"stiffness_pairs_kernelILi(\d)ELi(\d)E", m.group(1))
            if st:
                label = f"stiffness_pairs (d = {st.group(1)}, {st.group(2)} pairs)"
        elif label and "spill stores" in line:
            found[label] = line.strip()
        elif label and "Used" in line and "registers" in line:
            found[label] = f"{line.split('info    :')[-1].strip()}; {found.get(label, '')}"
            label = None
    for name, txt in found.items():
        log(f"ptxas {name}: {txt}")
    return found


def reset_counts(kernels):
    for k in kernels.values():
        k["fn"].launches = 0


def free_memory():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def card_tests():
    """``tests/test_torch_cuda.py`` in a pytest subprocess, JAX-free and without ``tests/conftest.py``;
    fails unless it exits 0 with tests passed and none skipped or failed."""
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "--noconftest",
           "-o", "markers=cuda: needs a card", "tests/test_torch_cuda.py"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=CARD_TESTS_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    summary = lines[-1] if lines else "(no output)"
    log(f"card tests (tests/test_torch_cuda.py): {summary} [exit {proc.returncode}, "
        f"{time.perf_counter() - t0:.3f} s]")
    if proc.returncode != 0:
        log("\n".join(lines[-40:] + proc.stderr.strip().splitlines()[-20:]))
    check(proc.returncode == 0, f"card tests exited {proc.returncode}")
    passed = re.search(r"(\d+) passed", summary)
    check(passed is not None and int(passed.group(1)) > 0, "card tests: no test passed")
    check(not re.search(r"skipped|failed|error", summary), f"card tests: {summary}")


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
            if cells == FULL:
                # one launch, no scratch: the call allocates its output and nothing else
                del got, again
                free_memory()
                torch.cuda.reset_peak_memory_stats()
                m0, n0 = torch.cuda.memory_allocated(), k["fn"].launches
                got = k["fn"](*args, gp, w, MU, LAM)
                torch.cuda.synchronize()
                extra, out_bytes = torch.cuda.max_memory_allocated() - m0, -(-got.numel() * 4 // 512) * 512
                log(f"{name} cells={cells}: one call allocates {extra} bytes of device memory (its output "
                    f"{out_bytes}) in {k['fn'].launches - n0} launch")
                check(extra <= out_bytes, f"{name}: the call allocates more than its output")
                again = got
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
        bound_txt = set_bound(k, (k["nargs"] + 1) * u.numel() * 4,
                              stencil_ops(FULL[0] * FULL[1] * FULL[2], hvp=k["nargs"] == 2))
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


def f64_banded_check(kernels, dev):
    """An f64 banded model on the card (plain gather and scatter) against the unbanded f64 model;
    an f32 banded residual launches the gather and scatter kernels."""
    import torch

    plain = assembled_model(6, torch.float64, dev, None)
    banded = assembled_model(6, torch.float64, dev, None, mesh=plain.mesh, banded=True)
    u = displacement(plain, seed=31)
    reset_counts(kernels)
    rel_r = float((banded.residual(u) - plain.residual(u)).abs().max() / plain.residual(u).abs().max())
    rel_d = float((banded.hessian_diagonal(u) - plain.hessian_diagonal(u)).abs().max()
                  / plain.hessian_diagonal(u).abs().max())
    f64_launches = kernels["banded_gather"]["fn"].launches + kernels["banded_scatter"]["fn"].launches
    banded32 = assembled_model(6, torch.float32, dev, None, mesh=plain.mesh, banded=True)
    banded32.residual(u.float())
    torch.cuda.synchronize()
    g32, s32 = kernels["banded_gather"]["fn"].launches, kernels["banded_scatter"]["fn"].launches
    log(f"f64 banded model res=6 on the card: residual rel {rel_r:.3e}, Jacobi diagonal rel {rel_d:.3e} against "
        f"the unbanded f64 model (limit 1e-12), kernel launches {f64_launches}; f32 banded residual: "
        f"banded_gather launches={g32}, banded_scatter launches={s32}")
    check(rel_r <= 1e-12 and rel_d <= 1e-12, "f64 banded model differs from the unbanded one")
    check(f64_launches == 0, "the f64 banded model launched an f32 kernel")
    check(g32 > 0 and s32 > 0, "the f32 banded residual did not launch the gather and scatter kernels")


def cg_count_diagnostic(dev, smi):
    """The first Newton step's CG iterations on path A's problem at res 80 (u = 0, the f32 residual as
    right-hand side, Jacobi, relative tolerance 1e-4) seven ways: assembled with the band-sweep
    kernel and with the plain band matvec; the fused matrix-free operator (C2) with its kernel; (a)
    assembled in f64 (f64 bands, the plain band matvec, CG in f64); (b) element matrices computed in
    f64 and cast to f32 before the f32 band assembly, with the band-sweep kernel; (c) the f32 assembly
    with the element tangent's J taken relative to each element's first node (as ``local_em`` and the
    em kernels take it), with the band-sweep kernel; (d) the fused operator's plain version
    (``banded_tangent_sweep_plain``) in f32."""
    from unittest import mock

    import torch

    import fenris_tpu_torch.elasticity as el
    import fenris_tpu_torch.ops.em_sweep as es
    from fenris_tpu_torch.sparse.cg import conjugate_gradient

    model = assembled_model(RES_DIAG, torch.float32, dev, CHUNK_A)
    u0 = torch.zeros(model.space.num_dofs, device=dev)
    f = model.residual(u0)
    pairs = el.assemble_element_elliptic_matrices_pairs
    counts = {}

    def assembled_cg(name, m, kernel):
        hvp2, inv_diag2 = m.assembled_hessian_operator(u0.to(m.dtype), layout="component", kernel=kernel)
        rhs = f.to(m.dtype).reshape(-1, 3).T.contiguous()
        cg = conjugate_gradient(hvp2, rhs, preconditioner=lambda v: inv_diag2 * v,
                                rel_tolerance=1e-4, max_iter=2000, check_definiteness=False)
        counts[name] = (cg.num_iterations, cg.status)

    assembled_cg("band-sweep kernel", model, True)
    assembled_cg("plain band matvec", model, False)
    fused = assembled_model(RES_DIAG, torch.float32, dev, None, mesh=model.mesh, banded=True, fused_kernels=True)
    cg = fused._matrix_free_cg(u0, f, None, 1e-4, 2000)
    counts["fused matrix-free kernel"] = (cg.num_iterations, cg.status)
    model64 = assembled_model(RES_DIAG, torch.float64, dev, CHUNK_A, mesh=model.mesh)
    assembled_cg("(a) assembled f64, plain band matvec", model64, False)
    del model64
    free_memory()
    f64_elements = lambda X, u_el, *a: pairs(X.double(), u_el.double(), *a).float()  # noqa: E731
    with mock.patch.object(el, "assemble_element_elliptic_matrices_pairs", f64_elements):
        assembled_cg("(b) f64 element matrices in f32 bands, band-sweep kernel", model, True)
    node_relative = lambda X, u_el, *a: pairs(X - X[:, :1], u_el, *a)  # noqa: E731
    with mock.patch.object(el, "assemble_element_elliptic_matrices_pairs", node_relative):
        assembled_cg("(c) f32 assembly, node-relative J, band-sweep kernel", model, True)
    plain_sweep = lambda plan, X, u, v, op, params, tab, tables: es.banded_tangent_sweep_plain(  # noqa: E731
        plan, X, u, v, op, params, tab)
    with mock.patch.object(es, "banded_tangent_sweep", plain_sweep):
        cg = fused._matrix_free_cg(u0, f, None, 1e-4, 2000)
    counts["(d) fused plain version f32"] = (cg.num_iterations, cg.status)
    for name, (it, st) in counts.items():
        log(f"CG-count diagnostic res={RES_DIAG} dofs={model.space.num_dofs}, first Newton step: {name}: "
            f"{it} iterations (status {st}) ({smi})")
    del model, fused
    free_memory()


# -- path C: the matrix-free banded solve -------------------------------------------------


def banded_kernel_checks(kernels, model, shape_txt, dev, seed, smi=None):
    """The banded-path kernels against their plain versions on one fused model's layout.

    With ``smi`` also times them (kernel, plain, library call) and sets
    their bounds, from these inputs, and times each fused sweep against the
    route it replaced (gathers, then the element-minor sweep on the gathered
    rows).
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
    # the fused vector sweep (the main path's residual); padding elements get zero rows
    fused_vec = lambda: es.banded_vector_sweep(plan, X, u, op, params, tab, tables)  # noqa: E731
    got = fused_vec()
    compare("banded_vector_sweep", shape_txt, got, fused_vec(), es.banded_vector_sweep_plain(plan, X, u, op, params, tab))
    padding = ~valid.reshape(pe, n)[:, 0]
    zero_pad = not bool(got[padding].any())
    log(f"banded_vector_sweep {shape_txt}: {int(padding.sum())} padding elements, their rows zero: {zero_pad}")
    check(zero_pad, f"banded_vector_sweep {shape_txt}: a padding element's row is not zero")
    del got
    # the element-minor sweeps on element-major rows; on the small shapes contiguous element-minor arrays too
    layouts = [("element-major rows", u_em, v_em)]
    if smi is None:
        layouts.append(("element-minor", u_em.contiguous(), v_em.contiguous()))
    for layout, ue, ve in layouts:
        txt = f"{shape_txt} {layout}"
        compare("em_vector_sweep", txt, es.em_vector_sweep(X, ue, op, params, tab, tables),
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
    vector_sweep_turns(model, u, shape_txt, smi)


def vector_sweep_bytes(plan):
    """Bytes the fused vector sweep needs: the valid elements' X (24 floats) and node indices, the per-block
    row counts, u once, and every row written once."""
    nv = plan.node_rows.numel()
    return (3 * nv + nv + plan.block_rows.numel() + plan.num_nodes * 3 + plan.padded_elements * plan.n * 3) * 4


def vector_sweep_ops(plan, q):
    """f32 operations of the fused vector sweep: the valid elements' (a padding element's rows are zeros)."""
    return (OPS_PER_QP["em_vector_sweep"] * q + EM_OPS_PER_ELEMENT) * plan.num_elements


def vector_sweep_turns(model, u, shape_txt, smi, record=None):
    """The fused vector sweep (one kernel) in turns against the route it replaced on ``model``'s layout:
    the banded gather, then the element-minor vector sweep on the gathered element-major rows.  With
    ``record`` (the kernel's record) also its error, its time against its plain version's, and its bound."""
    import fenris_tpu_torch.ops.banded as bd
    import fenris_tpu_torch.ops.em_sweep as es

    plan, X, tables = model._plan, model._X_band, model._em_tables
    op, params, tab = model.operator, model.params, model.tab

    def old_route():
        return es.em_vector_sweep(X, bd.banded_gather(plan, u).permute(1, 2, 0), op, params, tab, tables)

    fused = lambda: es.banded_vector_sweep(plan, X, u, op, params, tab, tables)  # noqa: E731
    plain = lambda: es.banded_vector_sweep_plain(plan, X, u, op, params, tab)  # noqa: E731
    fused_ms, old_ms, txt = in_turns(fused, old_route, reps=10, names=("fused", "old route"))
    bound = {} if record is None else record
    bound_txt = set_bound(bound, vector_sweep_bytes(plan), vector_sweep_ops(plan, tab.num_points))
    log(f"time banded_vector_sweep {shape_txt}: {txt} (fused faster: {fused_ms < old_ms}); {bound_txt}, "
        f"{bound['bound_ms'] / fused_ms * 100:.1f}% of it ({smi})")
    if record is not None:
        got, ref = fused(), plain()
        record["max_abs_err"] = compare("banded_vector_sweep", shape_txt, got, fused(), ref)
        # both f32 versions against an f64 evaluation: the stress cancels to O(strain) at small strains
        ref64 = es.banded_vector_sweep_plain(plan, X.double(), u.double(), op, params, tab)
        scale = float(ref64.abs().max())
        log(f"banded_vector_sweep {shape_txt} against f64 on the same f32 inputs: kernel "
            f"{float((got.double() - ref64).abs().max()) / scale:.3e}, plain "
            f"{float((ref.double() - ref64).abs().max()) / scale:.3e}")
        del got, ref, ref64
        record["ms"], record["plain_ms"], txt = in_turns(fused, plain, reps=5)
        record["library_ms"] = None  # no PyTorch call computes the element forces
        log(f"time em_vector_sweep {shape_txt}: {txt}; {bound_txt} ({smi})")
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
        f"banded_vector_sweep launches={kernels['em_vector_sweep']['fn'].launches} peak memory {peak:.2f} GB ({smi})")
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
        f"|F|/|F0|={ratio:.6e} banded_vector_sweep launches={k9['launches']} ({smi})")
    check(tuple(res.x.shape) == (model.space.num_dofs,) and bool(torch.isfinite(res.x).all()),
          "path C3: wrong or non-finite displacement")
    check(ratio <= 1e-1, f"path C3: |F|/|F0| = {ratio:.3e} > 1e-1")
    check(k9["launches"] > 0, "path C3: the vector-sweep kernel was not launched")

    # one residual: the fused vector sweep reads u itself, so no gather runs
    reset_counts(kernels)
    model.residual(res.x)
    torch.cuda.synchronize()
    counts = {n: kernels[n]["fn"].launches for n in ("banded_gather", "em_vector_sweep", "banded_scatter")}
    log(f"path C3 one residual: launches banded_gather={counts['banded_gather']}, "
        f"banded_vector_sweep={counts['em_vector_sweep']}, banded_scatter={counts['banded_scatter']}")
    check(counts == {"banded_gather": 0, "em_vector_sweep": 1, "banded_scatter": 1},
          f"path C3: one residual launched {counts} (expected no gather, one sweep, one scatter)")
    vector_sweep_turns(model, res.x.reshape(-1, 3), f"res={RES_C3} rcm E={mesh.num_cells} "
                       f"E_pad={plan.padded_elements} blocks={plan.k_blocks}", smi, record=k9)

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


def stiffness_accuracy(sp, X, op, params, tab, got, ref):
    """The kernel, its plain version and the plain version on node-relative coordinates (J formed
    from X - X[:, :1], which is J exactly, with fewer rounding errors) against an f64 evaluation of
    the same f32 coordinates: max |x - f64| / max |f64|."""
    import torch

    ref64 = sp.stiffness_pairs_plain(X.double(), op, params, tab)
    scale = float(ref64.abs().max())
    rel = lambda a: float((a.double() - ref64).abs().max()) / scale  # noqa: E731
    k_rel, p_rel = rel(got), rel(ref)
    rel_x = sp.stiffness_pairs_plain(X - X[:, :1], op, params, tab)
    r_rel, r_vs_p = rel(rel_x), float((rel_x.double() - ref.double()).abs().max()) / float(ref.double().abs().max())
    del ref64, rel_x
    torch.cuda.synchronize()
    log(f"stiffness_pairs linear res={RES_B} against f64 on the same f32 coordinates: kernel {k_rel:.3e}, plain "
        f"{p_rel:.3e}, plain on node-relative coordinates {r_rel:.3e} (that one against the plain version "
        f"{r_vs_p:.3e}; the kernel forms J as the plain version does)")


def stiffness_row_padding(sp, X, op, params, tab, smi):
    """The kernel with its output rows E floats apart (E odd at res 99: each warp's 128-byte store run
    straddles two lines) against rows a multiple of 32 floats apart, as the wrapper lays them out; in
    turns, one launch each, straight through the library (not counted as launches)."""
    import numpy as np
    import torch

    from fenris_tpu_torch.ops._build import load_library

    tables, C, meta = sp._constants(op, params, tab)
    tables_d = torch.as_tensor(tables, dtype=torch.float32, device=X.device)
    cf = np.ascontiguousarray(C, dtype=np.float32)
    E, lib = X.shape[0], load_library()
    padded = -(-E // 32) * 32
    out = torch.empty(meta["s"] ** 2 * meta["n"] ** 2 * padded, device=X.device)

    def run(ld):
        code = lib.fenris_stiffness_pairs(X.data_ptr(), tables_d.data_ptr(), cf.ctypes.data, out.data_ptr(), E, ld,
                                          meta["m"], meta["n"], meta["q"], meta["d"], meta["s"], meta["sym"],
                                          torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"stiffness_pairs: CUDA error {code}")

    _, _, txt = in_turns(lambda: run(padded), lambda: run(E), reps=10,
                         names=(f"rows {padded} floats apart", f"rows {E} floats apart"))
    log(f"stiffness_pairs linear res={RES_B} output row stride: {txt} ({smi})")
    del out


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
    q, m = tab.num_points, X.shape[1]
    for name, (op, params) in cases.items():
        got = sp.stiffness_pairs(X, op, params, tab)
        again = sp.stiffness_pairs(X, op, params, tab)
        ref = sp.stiffness_pairs_plain(X, op, params, tab)
        err = compare("stiffness_pairs", f"{name} res={RES_B} E={E} out {got.numel() * 4 / 1e9:.3f} GB", got, again, ref)
        del again
        if name == "linear":
            stiffness_accuracy(sp, X, op, params, tab, got, ref)
        del got, ref
        free_memory()
        ms, plain_ms, txt = in_turns(
            lambda: sp.stiffness_pairs(X, op, params, tab), lambda: sp.stiffness_pairs_plain(X, op, params, tab), reps=5
        )
        # X read and the pairs written once; the fewest operations (stiffness_ops)
        s = op.solution_dim
        rec = {}
        bound_txt = set_bound(rec, (X.numel() + s * s * 64 * E) * 4, stiffness_ops(E, m, 8, q, s, op.symmetric))
        log(f"time stiffness_pairs {name} res={RES_B}: {txt}; {E / (ms * 1e-3) / 1e6:.1f} M elements/s; "
            f"{bound_txt}, {rec['bound_ms'] / ms * 100:.1f}% of it ({smi})")
        if name == "linear":
            k.update(rec, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None)
            stiffness_row_padding(sp, X, op, params, tab, smi)
        free_memory()
    log(f"stiffness_pairs shared memory a block: {sp._smem_bytes(m, 8, q, 3)} bytes (hex8)")

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
    found = ptxas_report(build_log())
    for prefix in ("stiffness_pairs", *PTXAS_LABELS.values()):
        entries = {n: t for n, t in found.items() if n.startswith(prefix)}
        check(len(entries) > 0 and all("0 bytes spill stores, 0 bytes spill loads" in t for t in entries.values()),
              f"{prefix}: ptxas reports spills or no entry: {entries}")
    t0 = time.perf_counter()
    card_tests()
    log(f"phase card tests: {time.perf_counter() - t0:.3f} s")

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
        # the vector sweep as the main path launches it: fused with the banded gather
        "em_vector_sweep": dict(
            fn=es.banded_vector_sweep, path="C", source=SOURCES["em_sweep"],
            replaces="fenris_tpu/ops/em_sweep.py:233",
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
    cg_count_diagnostic(dev, smi)
    f64_banded_check(kernels, dev)
    log(f"phase CG-count diagnostic and f64 banded check: {time.perf_counter() - t0:.3f} s")

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
