#!/usr/bin/env python3
"""Build variants of the port's stencil kernels and time them against the shipped source on one GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/stencil_variants.py kResidualMinBlocks=1 kTileY=8,kSlab=16 ...

Each argument is one variant, ``NAME=VALUE`` pairs joined by commas:
``fenris_tpu_torch/csrc/structured_stencil.cu`` with ``constexpr int NAME
= VALUE;`` in place of each shipped value.  The shipped source and every
variant are built with the port's nvcc flags, each into its own library under
``fenris_tpu_torch/_build/variants/``; the script prints each library's
``ptxas`` lines for ``nh_march`` (registers, shared memory, spills), checks
each library's residual and Hessian action against the plain versions at
128x128x64 cells (max |k - p| / max |p| <= 1e-5), and times each variant
against the shipped build in turns (shipped, variant, variant, shipped; CUDA
events, 20 launches each) beside the card's ``nvidia-smi`` name and power
limit.  It exits non-zero if a build fails, a check fails or no CUDA device
is present.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CELLS = (128, 128, 64)
MU, LAM = 384.614, 576.923  # the flagship's Lamé parameters
RTOL = 1e-5


def build(name: str, source: str, out_dir: Path):
    """Compile one stencil source into its own library; returns (library, ptxas lines of nh_march)."""
    from fenris_tpu_torch.ops._build import _COMPILE, _LINK, _nvcc

    out_dir.mkdir(parents=True, exist_ok=True)
    src, obj, lib = out_dir / f"{name}.cu", out_dir / f"{name}.o", out_dir / f"lib{name}.so"
    src.write_text(source)
    nvcc = _nvcc()
    proc = subprocess.run([nvcc, *_COMPILE, "-o", str(obj), str(src)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise SystemExit(f"stencil_variants: nvcc failed for {name}:\n{log}")
    subprocess.run([nvcc, *_LINK, "-o", str(lib), str(obj)], check=True)
    ptxas, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = "hvp" if "nh_marchILb1E" in m.group(1) else "residual" if "nh_marchILb0E" in m.group(1) else None
        elif kernel and ("registers" in line or "spill" in line):
            ptxas[kernel] = (ptxas.get(kernel, "") + " " + line.split("info    :")[-1].strip()).strip()
    cdll = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    cdll.fenris_nh_residual.argtypes = [P, P, I, I, I, P, F, F, P]
    cdll.fenris_nh_hvp.argtypes = [P, P, P, I, I, I, P, F, F, P]
    cdll.fenris_nh_residual.restype = cdll.fenris_nh_hvp.restype = I
    return cdll, ptxas


def main() -> int:
    import torch

    import fenris_tpu_torch.ops.structured_stencil as ss

    if not torch.cuda.is_available():
        raise SystemExit("stencil_variants: no CUDA device")
    variants = [(arg, [pair.split("=", 1) for pair in arg.split(",")]) for arg in sys.argv[1:]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    shipped = (ROOT / "fenris_tpu_torch/csrc/structured_stencil.cu").read_text()
    out_dir = ROOT / "fenris_tpu_torch/_build/variants"
    libs = {"shipped": build("shipped", shipped, out_dir)}
    for i, (label, pairs) in enumerate(variants):
        source = shipped
        for name, value in pairs:
            pattern = rf"constexpr int {name} = \d+;"
            if not re.search(pattern, source):
                raise SystemExit(f"stencil_variants: no 'constexpr int {name}' in the source")
            source = re.sub(pattern, f"constexpr int {name} = {int(value)};", source)
        libs[label] = build(f"variant{i}", source, out_dir)
    for label, (_, ptxas) in libs.items():
        for kernel, txt in ptxas.items():
            print(f"ptxas {label} {kernel}: {txt}", flush=True)

    dev = torch.device("cuda", 0)
    h = 1.0 / max(CELLS)
    shape = (3, CELLS[2] + 1, CELLS[1] + 1, CELLS[0] + 1)
    g = torch.Generator(device=dev).manual_seed(0)
    u = (torch.rand(shape, generator=g, device=dev) * 2.0 - 1.0) * (0.02 * h)
    v = torch.randn(shape, generator=g, device=dev)
    gp, w = ss.gp_table(h)
    factors = ss.stencil_factors(gp, w)
    out = torch.empty_like(u)
    nz, ny, nx = shape[1:]
    stream = torch.cuda.current_stream().cuda_stream

    def runner(cdll, kernel):
        if kernel == "residual":
            return lambda: cdll.fenris_nh_residual(u.data_ptr(), out.data_ptr(), nz, ny, nx, factors.ctypes.data,
                                                   MU, LAM, stream)
        return lambda: cdll.fenris_nh_hvp(u.data_ptr(), v.data_ptr(), out.data_ptr(), nz, ny, nx,
                                          factors.ctypes.data, MU, LAM, stream)

    def ms(fn, reps=20):
        for _ in range(3):
            fn()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    plain = {"residual": ss.neo_hookean_residual_plain(u, gp, w, MU, LAM),
             "hvp": ss.neo_hookean_hvp_plain(u, v, gp, w, MU, LAM)}
    ok = True
    for label, (cdll, _) in libs.items():
        for kernel, ref in plain.items():
            code = runner(cdll, kernel)()
            torch.cuda.synchronize()
            rel = float((out.double() - ref.double()).abs().max() / ref.double().abs().max())
            good = code == 0 and rel <= RTOL
            ok &= good
            print(f"check {label} {kernel} cells={CELLS}: code {code} rel {rel:.6e} (limit {RTOL:g})", flush=True)
    if not ok:
        raise SystemExit("stencil_variants: a variant failed its check")
    for label, (cdll, _) in list(libs.items())[1:]:
        for kernel in plain:
            a, b = runner(libs["shipped"][0], kernel), runner(cdll, kernel)
            a1, b1, b2, a2 = ms(a), ms(b), ms(b), ms(a)
            print(f"time {kernel} cells={CELLS}: shipped {a1:.4f}/{a2:.4f} ms, {label} {b1:.4f}/{b2:.4f} ms ({smi})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
