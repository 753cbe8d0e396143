"""Time the element-stiffness kernel of several checkouts in turns on one card, in one process.

Usage, from the root of a checkout on a machine with a card:

    python3 tools/stiffness_ab.py OLD NEW [NEW ...] [--shapes B,B20,B10,B2,T4,T20,H27] [--reps 10] [--turns 2]
                                  [--graph] [--entry] [--no-check] [--kinds linear,laplace]
                                  [--ablate no_stores,no_build,no_sums]

OLD and each NEW are roots of checkouts (e.g. a ``git archive`` of the
parent unpacked under ``data/``, ``.``, and variants of it: a copy of
``fenris_tpu_torch/`` with a ``kTiling`` row or a line of
``csrc/stiffness_pairs.cu`` changed suffices), or a ``.cu`` file with the
same C interface (``tools/stiffness_reference_sums.cu``: Laplace on the
simplices from the reference sums, ``--shapes T4,B10,T20 --kinds
laplace``).  Each builds its own kernel
source (``csrc/stiffness_pairs.cu`` alone, every tree's nvcc started
together, with this checkout's flags; each stiffness instantiation's
registers and spills are printed from ``-Xptxas -v``); all are
loaded into this one process and run on the same inputs, built by this
checkout: each launch goes to one library's ``fenris_stiffness_pairs``
(the C interface all export), straight through ctypes with the tables on
the card once, as ``chip_smoke.stiffness_launch`` does.

Shapes (``chip_smoke.py``'s cells): B (hex8, res 99, 970,299 cells), B20
(hex20 on ``convert_mesh(box 64)``, 262,144), B10 (tet10 on the BCC res-40
box, 768,000), B2 (quad4 and tri3 at res 1024, quad8, quad9 and tri6 at
512), T4 (tet4 on the BCC res-40 box, 768,000), T20 (tet20 on the BCC
res-32 box, 393,216), H27 (hex27 on ``convert_mesh(box 48)``, 110,592);
each with linear elasticity (s = d) and Laplace (s = 1).  Per shape and
operator, ``--turns`` rounds of OLD, NEW, ..., NEW, OLD, each the lowest
of three means of ``--reps`` eager launches between CUDA events after a
warm-up (``--graph``: of one replay of a CUDA graph of them, without the
host's time a launch); the line gives every time, each NEW's lowest over
OLD's, the bound (bytes over 3.35 TB/s or f32 operations over 67 TFLOP/s,
``chip_smoke.stiffness_ops``), each library's share of it and M elements
a second; ``--entry`` also times the public entry point
(``assemble_element_elliptic_matrices_pairs(kernel="auto")``, the wrapper's
library routed to each tree's in turns; host clock, lowest of three).
The libraries' outputs must agree with OLD's to 1e-5 relative
and two launches of one library must be bitwise equal (``--no-check`` for
ablations that skip a phase).  ``--ablate`` adds, as further NEW libraries,
this checkout's source with one phase of the kernel skipped each
(``ABLATIONS``: the stores, the table build, the pair sums; a runtime test
the compiler cannot fold), and implies ``--no-check``.

Prints one ``ab`` line a shape and operator, with the card's name and power
limit first.  Compare two versions only inside one call.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = ("B", "B20", "B10", "B2", "T4", "T20", "H27")
# shape -> [(element, mesh resolution)]; B2's from chip_smoke.B2_MESHES
MESHES = {"B": [("hex8", 99)], "B20": [("hex20", 64)], "B10": [("tet10", 40)], "T4": [("tet4", 40)],
          "T20": [("tet20", 32)], "H27": [("hex27", 48)]}


# ablation -> (text of the kernel's body, its replacement): the phase runs only when the row stride is 7 or the
# pair count 99, never here
ABLATIONS = {
    "no_stores": ("__stcs(", "if (ld == 7) __stcs("),
    "no_build": ("for (int it = threadIdx.x; it < nq * ET;", "for (int it = threadIdx.x; k.P == 99 && it < nq * ET;"),
    "no_sums": ("for (; qq < end;", "for (; ld == 7 && qq < end;"),
}


def ablations(names):
    """This checkout's ``csrc/stiffness_pairs.cu`` with one phase skipped each (``ABLATIONS``), written under
    ``fenris_tpu_torch/_build/``; their paths."""
    src = (ROOT / "fenris_tpu_torch/csrc/stiffness_pairs.cu").read_text()
    a, b = src.index("// -- the kernel"), src.index("// -- launchers")
    paths = []
    for name in names:
        old, new = ABLATIONS[name]
        if old not in src[a:b]:
            raise SystemExit(f"stiffness_ab: the kernel's body has no {old!r} for {name}")
        path = ROOT / "fenris_tpu_torch/_build" / f"ablation_{name}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src[:a] + src[a:b].replace(old, new) + src[b:])
        paths.append(path)
    return paths


def libraries(roots):
    """Each checkout's ``csrc/stiffness_pairs.cu`` built alone into a shared library under its
    ``fenris_tpu_torch/_build/`` (every nvcc started together, this checkout's flags), loaded; prints the
    registers and spills of each tree's stiffness kernels from its ``-Xptxas -v`` log."""
    import ctypes
    import hashlib

    from fenris_tpu_torch.ops import _build

    jobs = []
    for k, root in enumerate(roots):
        src = root if root.suffix == ".cu" else root / "fenris_tpu_torch/csrc/stiffness_pairs.cu"
        key = hashlib.sha256(src.read_bytes() + " ".join(_build._ARCH).encode()).hexdigest()[:16]
        out = (ROOT if root.suffix == ".cu" else root) / "fenris_tpu_torch/_build" / f"stiffness_ab_{key}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build._ARCH, "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out), str(src)]
        jobs.append((out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for k, (out, proc) in enumerate(jobs):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {roots[k]}:\n{log[-4000:]}")
        entry, found = None, {}
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                st = re.search(r"(stiffness_pairs_kernel|12pairs_kernel|11sums_kernel|15pairs_from_sums)I((?:L[ib]\d+E)+)E", m.group(1))
                entry = None if st is None else (
                    f"{st.group(1).lstrip('0123456789')}<{','.join(re.findall(r'L[ib](\d+)E', st.group(2)))}>")
            elif entry and "spill stores" in line:
                found[entry] = f"{re.search(r'(\d+) bytes spill stores', line)[1]} bytes spilled"
            elif entry and "Used" in line and "registers" in line:
                found[entry] = f"{re.search(r'Used (\d+) registers', line)[1]} registers, {found.get(entry, '?')}"
        lib = ctypes.CDLL(str(out))
        argtypes, restype = _build._SIGNATURES["fenris_stiffness_pairs"]
        lib.fenris_stiffness_pairs.argtypes, lib.fenris_stiffness_pairs.restype = list(argtypes), restype
        print(f"library {'OLD' if k == 0 else f'NEW{k}'} ({roots[k]}): registers {found}", flush=True)
        libs.append(lib)
    return libs


def event_ms(fn, reps, graph=False):
    """ms a call of ``fn``: the lowest of three means of ``reps`` calls between CUDA events after warm-up
    calls, or with ``graph`` of three replays of a CUDA graph of ``reps`` calls."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    run = lambda: [fn() for _ in range(reps)]  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        g.replay()
        run = g.replay
    best = float("inf")
    for _ in range(3):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) / reps)
    return best


def launcher(lib, X, op, params, tab):
    """``run(out)``: one launch of ``lib``'s stiffness kernel on X into ``out`` (rows padded to 32)."""
    import numpy as np
    import torch

    import fenris_tpu_torch.ops.stiffness_pairs as sp

    tables, C, meta = sp._constants(op, params, tab)
    tables_d = torch.as_tensor(tables, dtype=torch.float32, device=X.device)
    cf = sp.host_constants(C, meta)
    E = X.shape[0]
    ld = -(-E // 32) * 32

    def run(out):
        code = lib.fenris_stiffness_pairs(X.data_ptr(), tables_d.data_ptr(), cf.ctypes.data, out.data_ptr(), E, ld,
                                          meta["m"], meta["n"], meta["q"], meta["d"], meta["s"], meta["sym"],
                                          torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"fenris_stiffness_pairs: CUDA error {code}")
        return out

    return run, (meta["s"] ** 2, meta["n"] ** 2, ld)


def entry_walls(libs, X, op, params, tab, turns):
    """The public entry point's wall (host clock around a synchronised call, the lowest of three) with the
    wrapper's library routed to each of ``libs``, in turns: ``{library index: [ms, ...]}``."""
    from unittest import mock

    import torch

    import fenris_tpu_torch.ops.stiffness_pairs as sp
    from fenris_tpu_torch.assembly.local import assemble_element_elliptic_matrices_pairs

    order = list(range(len(libs)))
    walls = {k: [] for k in order}
    for _ in range(turns):
        for k in order + order[::-1]:
            best = float("inf")
            with mock.patch.object(sp, "load_library", lambda k=k: libs[k]):
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    A = assemble_element_elliptic_matrices_pairs(X, None, op, params, tab, kernel="auto")
                    torch.cuda.synchronize()
                    best = min(best, (time.perf_counter() - t0) * 1e3)
                    del A
            walls[k].append(best)
    return walls


def shape_turns(shape, name, mesh, libs, args):
    import torch

    import chip_smoke as cs
    import fenris_tpu_torch.ops.stiffness_pairs as sp
    from fenris_tpu_torch.assembly.local import tabulate
    from fenris_tpu_torch.fem import FemSpace
    from fenris_tpu_torch.operators import LaplaceOperator
    from fenris_tpu_torch.quadrature import canonical_stiffness
    from fenris_tpu_torch.solid import LameParameters, LinearElasticMaterial, MaterialEllipticOperator

    d = mesh.points.shape[1]
    X = FemSpace.create(mesh, 1, torch.float32, "cuda").X_geo
    tab = tabulate(mesh.element, canonical_stiffness(name))
    q, m, _ = tab.geo_dphi.shape
    n, E = tab.dphi.shape[1], X.shape[0]
    kinds = {"linear": (MaterialEllipticOperator(LinearElasticMaterial(), dim=d), LameParameters(mu=cs.MU, lam=cs.LAM)),
             "laplace": (LaplaceOperator(), None)}
    order = list(range(len(libs)))
    for kind in args.kinds.split(","):
        op, params = kinds[kind]
        s = op.solution_dim
        runs = [launcher(lib, X, op, params, tab) for lib in libs]
        out = torch.empty(runs[0][1], dtype=torch.float32, device="cuda")
        ref = runs[0][0](out)[..., :E].clone()
        rels, same = [], []
        for run, _ in runs:
            got = run(out)[..., :E].clone()
            again = run(out)[..., :E]
            torch.cuda.synchronize()
            rels.append(float((got.double() - ref.double()).abs().max() / ref.double().abs().max()))
            same.append(bool(torch.equal(got, again)))
            del got, again
        del ref
        times = {k: [] for k in order}
        for _ in range(args.turns):
            for k in order + order[::-1]:
                times[k].append(event_ms(lambda k=k: runs[k][0](out), args.reps, args.graph))
        del out
        torch.cuda.empty_cache()
        walls = entry_walls(libs, X, op, params, tab, args.turns) if args.entry else {}
        rec = {}
        bound_txt = cs.set_bound(rec, (X.numel() + s * s * n * n * E) * 4, cs.stiffness_ops(E, m, n, q, s, op.symmetric, d))
        old = min(times[0])
        lay = sp.launch_layout(op, params, tab)
        txt = ", ".join(
            f"{'OLD' if k == 0 else f'NEW{k}'} {'/'.join(f'{t:.4f}' for t in times[k])} ms "
            f"({rec['bound_ms'] / min(times[k]) * 100:.1f}%, {E / min(times[k]) / 1e3:.1f} M el/s"
            + ("" if k == 0 else f"; x{min(times[k]) / old:.3f}, rel {rels[k]:.1e}") + f", repeat {same[k]})"
            for k in order)
        print(f"ab stiffness {shape} {name} {kind} E={E}: {txt}; {bound_txt}; this checkout's layout {lay}",
              flush=True)
        if walls:
            print(f"ab entry {shape} {name} {kind}: assemble_element_elliptic_matrices_pairs(kernel='auto') wall, ms: "
                  + ", ".join(f"{'OLD' if k == 0 else f'NEW{k}'} {'/'.join(f'{t:.3f}' for t in walls[k])}" for k in order),
                  flush=True)
        if not args.no_check and (max(rels) > 1e-5 or not all(same)):
            raise RuntimeError(f"{shape} {name} {kind}: the libraries differ by {max(rels):.3e} or repeat {same}")
    del X
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", type=Path, nargs="+", help="OLD, then one or more NEW checkouts")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--kinds", default="linear,laplace")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--graph", action="store_true",
                    help="time CUDA-graph replays (no host time a launch) instead of eager launches")
    ap.add_argument("--entry", action="store_true",
                    help="also time assemble_element_elliptic_matrices_pairs(kernel='auto') with each library")
    ap.add_argument("--no-check", action="store_true",
                    help="time libraries whose outputs differ (ablations: a variant that skips a phase)")
    ap.add_argument("--ablate", default="", help=f"add this checkout's kernel without a phase: {','.join(ABLATIONS)}")
    args = ap.parse_args()
    args.no_check = args.no_check or bool(args.ablate)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("stiffness_ab: no CUDA device")
    if len(args.roots) < 2 and not args.ablate:
        raise SystemExit("stiffness_ab: give OLD and at least one NEW checkout (or --ablate)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    t0 = time.perf_counter()
    libs = libraries([root.resolve() for root in args.roots] + ablations(filter(None, args.ablate.split(","))))
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    for shape in filter(None, args.shapes.split(",")):
        t0 = time.perf_counter()
        meshes = list(cs.B2_MESHES.items()) if shape == "B2" else MESHES[shape]
        for name, res in meshes:
            mesh = cs.square_mesh(name, res) if shape == "B2" else cs.element_box(name, res)
            shape_turns(shape, name, mesh, libs, args)
        print(f"shape {shape}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
