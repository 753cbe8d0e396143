#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fenris_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

It builds the stencil kernels from ``fenris_tpu_torch/csrc`` and drives
the port's main path, the structured Neo-Hookean Newton–Krylov solve,
at the flagship size (BASELINE config 5: 128 x 128 x 64 = 1,048,576 hex8
cells, 3.25M dofs, random-free loads from the model's body force):

1. card name and power limit; kernel build time;
2. each kernel against its plain PyTorch version on the card at the full
   size and two ragged shapes (max |kernel - plain| / max |plain| <= 1e-5),
   and two launches on one input bitwise equal;
3. kernel and plain times at the full size (CUDA events);
4. ``solve(preconditioner="mg")`` at the full size in f32: finite result,
   ||F|| non-increasing, ||F|| / ||F0|| <= 1e-1 (the pure-f32 floor), the
   same bound for an independent plain-path residual of the result, and
   every kernel of the path launched;
5. ``solve_mixed(preconditioner="mg")`` at 32^3: relative ||F|| <= 1e-10.

Every phase raises on failure.  The second-to-last line of standard
output is the per-kernel JSON record, the last line the device record.
Without a CUDA device, or outside a checkout, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MU, LAM = 384.614, 576.923  # the flagship's Lamé parameters
FULL = (128, 128, 64)
RAGGED = [(5, 4, 11), (15, 7, 5)]
KERNEL_RTOL = 1e-5  # f32 roundoff: FMA contraction and summation order
SOURCE = "fenris_tpu_torch/csrc/structured_stencil.cu"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


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


def main() -> int:
    if not (ROOT / "fenris_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: fenris_tpu_torch/ not found next to this script; run it in a checkout")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures the port on a GPU")
    sys.path.insert(0, str(ROOT))
    import fenris_tpu_torch.ops.structured_stencil as ss
    from fenris_tpu_torch.ops._build import load_library
    from fenris_tpu_torch.optimize import NEWTON_CONVERGED

    dev = torch.device("cuda", 0)

    # -- 1. card and build ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    load_library()
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc, sm_90a)", flush=True)

    kernels = {
        "neo_hookean_residual": dict(
            fn=ss.neo_hookean_residual, plain=ss.neo_hookean_residual_plain, nargs=1,
            replaces="fenris_tpu/ops/structured_stencil.py:421",
        ),
        "neo_hookean_hvp": dict(
            fn=ss.neo_hookean_hvp, plain=ss.neo_hookean_hvp_plain, nargs=2,
            replaces="fenris_tpu/ops/structured_stencil.py:319",
        ),
    }

    # -- 2. kernel against plain, on the card ---------------------------------
    for cells in [FULL] + RAGGED:
        h, u, v = kernel_inputs(cells, dev)
        gp, w = ss.gp_table(h)
        for name, k in kernels.items():
            args = (u, v)[: k["nargs"]]
            got = k["fn"](*args, gp, w, MU, LAM)
            again = k["fn"](*args, gp, w, MU, LAM)
            ref = k["plain"](*args, gp, w, MU, LAM)
            torch.cuda.synchronize()
            abs_err = float((got - ref).abs().max())
            rel = abs_err / float(ref.abs().max())
            same = bool(torch.equal(got, again))
            print(f"compare {name} cells={cells}: max_abs_err={abs_err:.6e} rel={rel:.6e} "
                  f"(limit {KERNEL_RTOL:g}) repeat_bitwise_equal={same}", flush=True)
            check(bool(torch.isfinite(got).all()), f"{name} {cells}: non-finite output")
            check(rel <= KERNEL_RTOL, f"{name} {cells}: kernel vs plain rel {rel:.3e} > {KERNEL_RTOL:g}")
            check(same, f"{name} {cells}: two launches on one input differ")
            if cells == FULL:
                k["max_abs_err"] = abs_err
        del u, v, got, again, ref

    # -- 3. times at full size ---------------------------------------------------
    h, u, v = kernel_inputs(FULL, dev, seed=1)
    gp, w = ss.gp_table(h)
    for name, k in kernels.items():
        args = (u, v)[: k["nargs"]]
        run_k = lambda: k["fn"](*args, gp, w, MU, LAM)  # noqa: E731
        run_p = lambda: k["plain"](*args, gp, w, MU, LAM)  # noqa: E731
        # in turns: plain, kernel, kernel, plain; the lower of each pair
        p1, k1, k2, p2 = event_ms(run_p), event_ms(run_k), event_ms(run_k), event_ms(run_p)
        k["ms"], k["plain_ms"] = min(k1, k2), min(p1, p2)
        print(f"time {name} cells={FULL}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms "
              f"({smi})", flush=True)
    del u, v
    torch.cuda.synchronize()

    # -- 4. main path at full size -------------------------------------------------
    model = flagship_model(FULL, torch.float32, dev)
    history = []

    def record(k, fn, cg):
        history.append(fn)
        cg_txt = "" if cg is None else f" cg_iters={cg.num_iterations} cg_status={cg.status}"
        print(f"  newton it {k}: |F|={fn:.6e}{cg_txt}", flush=True)

    print(f"solve(mg) cells={FULL} dofs={model.num_dofs} f32:", flush=True)
    for k in kernels.values():
        k["fn"].launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = model.solve(
        preconditioner="mg", tolerance=1e-6, max_newton_iterations=4,
        cg_rel_tolerance=1e-5, cg_max_iter=200, callback=record,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k in kernels.values():
        k["launches"] = k["fn"].launches
    ratio = res.residual_norm / history[0]
    plain_model = flagship_model(FULL, torch.float32, dev, kernel=False)
    plain_ratio = float(torch.linalg.vector_norm(plain_model.residual(res.x))) / history[0]
    print(f"solve(mg): status={res.status} newton_iters={res.iterations} wall={wall:.3f} s "
          f"|F|/|F0|={ratio:.6e} plain-path |F|/|F0|={plain_ratio:.6e} "
          f"launches={{{', '.join(f'{n}: {k['launches']}' for n, k in kernels.items())}}} ({smi})",
          flush=True)
    check(tuple(res.x.shape) == (model.num_dofs,), "solve: wrong result shape")
    check(bool(torch.isfinite(res.x).all()), "solve: non-finite displacement")
    check(all(b <= a for a, b in zip(history, history[1:])), f"solve: |F| not monotone: {history}")
    check(ratio <= 1e-1, f"solve: |F|/|F0| = {ratio:.3e} > 1e-1")
    check(plain_ratio <= 1e-1, f"solve: plain-path |F|/|F0| = {plain_ratio:.3e} > 1e-1")
    for name, k in kernels.items():
        check(k["launches"] > 0, f"solve: kernel {name} was not launched on the main path")
    del model, plain_model, res

    # -- 5. mixed precision at 32^3 ----------------------------------------------
    cells = (32, 32, 32)
    model = flagship_model(cells, torch.float32, dev)
    history = []
    print(f"solve_mixed(mg) cells={cells} dofs={model.num_dofs}:", flush=True)
    t0 = time.perf_counter()
    res = model.solve_mixed(tolerance=1e-10, preconditioner="mg", callback=record)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rel = res.residual_norm / history[0]
    print(f"solve_mixed(mg): status={res.status} newton_iters={res.iterations} wall={wall:.3f} s "
          f"|F|/|F0|={rel:.6e} ({smi})", flush=True)
    check(res.status == NEWTON_CONVERGED, f"solve_mixed: status {res.status}")
    check(bool(torch.isfinite(res.x).all()), "solve_mixed: non-finite displacement")
    check(rel <= 1e-10, f"solve_mixed: |F|/|F0| = {rel:.3e} > 1e-10")

    record_line = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": SOURCE,
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
