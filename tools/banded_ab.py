"""Time the banded gather and scatter of several checkouts in turns on one card.

Usage, from the root of a checkout on a machine with a card:

    python3 tools/banded_ab.py OLD NEW NEW OLD
    python3 tools/banded_ab.py --solves [--cells S10,PE10] [--repeat 3] OLD NEW NEW OLD

Each argument is the root of a checkout (e.g. a ``git archive`` of the
parent unpacked under ``data/``).  This script first builds the layouts of
``chip_smoke.py``'s cells once, on the card (meshes after the RCM where the
cell takes one), and saves their cells under ``fenris_tpu_torch/_build/``:

* C2 (s = 3): hex8, tools/solve_assembled.py's res-149 box;
* M10, M20 (s = 3): tet10 on the BCC res-40 box, hex20 on the res-64 box;
* P149 (s = 1): the res-149 box; P2D quad9 and tri6 (s = 1): the res-512 square;
* M2D (s = 2): quad4 and tri3 at res 1024, quad8, quad9 and tri6 at res 512.

Then each checkout runs in its own process, in the order given: it builds
only its own ``banded.cu`` (its ``ops/_build.py`` restricted to that source
and ``structured_stencil.cu``, which holds the error strings), makes each
plan with its own ``make_banded_plan`` (JAX's ``r_nodes`` rule, as the
models and Poisson routes take it), checks both kernels bitwise against
their plain versions on seeded inputs, and times them with CUDA events, the
lower of two runs of ``REPS`` launches after a warm-up.  The launches cycle
through copies of the inputs that hold 3x the card's 50 MB L2 between two
uses of one copy (one copy where the layout alone is that large), so a
launch finds little of its data in L2.  Two ways: on the card (the launches
captured in one CUDA graph and replayed: the kernel's own time) and eager
(the launches called from Python back to back: what a caller sees, the
host's time per call where that is longer), with ``index_select`` and
``index_add_`` (with its zero fill) on the same padded layout timed the
same ways in the same process.  The last lines give, for each layout, each
checkout's lowest times, and each kernel's share of its bound (the bytes
the function needs over 3.35 TB/s, as ``chip_smoke.py`` counts them).
Compare two versions only inside one call.

With ``--solves`` each checkout instead runs, with its own ``chip_smoke.py``
functions, the matrix-free solves whose CG iterations launch the scatter
(``--cells``, default all): S2D quad9 and S2D tri6 (res 128, s = 2), S10
(tet10, s = 3) and PE10 (S10 with two materials), each ``solve_mixed`` to
1e-10 as ``chip_smoke.py`` runs it, ``--repeat`` times (default 1) on one
model, and prints Newton steps, CG iterations, wall time and ms a CG
iteration (CG time without the Jacobi diagonals, over the iterations).
Then, once a cell, it runs the first Newton step's CG call again under
``torch.profiler`` and prints the card's busy time a CG iteration (kernel
time, the Jacobi diagonal included: what the card would take were the host
never late), and the host's time a call of ``scatter_add`` (as the CG
operator calls it) and of ``banded_scatter`` on the cell's plan, 200 calls
back to back.  The summary gives each checkout's median, lowest and
highest ms a CG iteration over all its solves, and the medians of the rest.
"""

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LAYOUT_DIR = ROOT / "fenris_tpu_torch" / "_build" / "banded_ab"
REPS = 50
TIMES = tuple(f"{k}{e}_ms" for k in ("gather", "scatter", "index_select", "index_add") for e in ("", "_eager"))
HBM_BYTES_PER_S = 3.35e12

# (layout, element, mesh resolution, RCM, s)
LAYOUTS = (
    ("C2", "hex8", 149, False, 3),
    ("M10 tet10", "tet10", 40, True, 3),
    ("M20 hex20", "hex20", 64, True, 3),
    ("P149", "hex8", 149, False, 1),
    ("P2D quad9", "quad9", 512, True, 1),
    ("P2D tri6", "tri6", 512, True, 1),
    ("M2D quad4", "quad4", 1024, True, 2),
    ("M2D quad8", "quad8", 512, True, 2),
    ("M2D quad9", "quad9", 512, True, 2),
    ("M2D tri3", "tri3", 1024, True, 2),
    ("M2D tri6", "tri6", 512, True, 2),
)

_RUN = """
import collections, dataclasses, json, subprocess, sys
sys.path.insert(0, ".")
import numpy as np
import torch
import fenris_tpu_torch.ops._build as build
import fenris_tpu_torch.ops.banded as bd

layout_dir, reps = sys.argv[1], int(sys.argv[2])
L2_BYTES = 50 * 2**20
layouts = json.loads(sys.argv[3])
# this checkout's banded.cu (and structured_stencil.cu, which holds the error strings) alone
build._UNITS = tuple(u for u in build._UNITS if u[0].name in ("banded.cu", "structured_stencil.cu"))
build._SIGNATURES = {k: build._SIGNATURES[k] for k in
                     ("fenris_banded_gather", "fenris_banded_scatter", "fenris_cuda_error_string")}
build.load_library()
dev = torch.device("cuda", 0)


def lower_of_two(run):
    best = float("inf")
    for _ in range(2):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) / reps)
    return best


# a call as a caller sees it: reps calls from Python back to back, cycling through the input copies (the
# host's time per call where it exceeds the card's)
def eager_ms(calls):
    for fn in calls:
        fn()
    return lower_of_two(lambda: [calls[i % len(calls)]() for i in range(reps)])


# the card's time per call: reps calls, cycling through the input copies, captured in one CUDA graph and
# replayed; each output lives until len(calls) later calls were made, so no two calls in that span write
# one buffer
def device_ms(calls):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph, kept = torch.cuda.CUDAGraph(), collections.deque(maxlen=len(calls))
    with torch.cuda.graph(graph):
        for i in range(reps):
            kept.append(calls[i % len(calls)]())
    graph.replay()
    torch.cuda.synchronize()
    return lower_of_two(graph.replay)


for name, s in layouts:
    cells = np.load(f"{layout_dir}/{name.replace(' ', '_')}.npy")
    N = int(cells.max()) + 1
    plan = bd.make_banded_plan(cells, N, s=s, r_nodes=min(4096, max(1024, -(-N // 1024) * 1024)), device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    u = torch.randn((N, s), generator=g, device=dev)
    f = torch.randn((plan.padded_elements, plan.n, s), generator=g, device=dev)
    exact = (torch.equal(bd.banded_gather(plan, u), bd.banded_gather_plain(plan, u))
             and torch.equal(bd.banded_scatter(plan, f), bd.banded_scatter_plain(plan, f)))
    idx = plan.nodes_padded.long()
    idx_spare = torch.where(plan.valid_rows > 0, idx, torch.arange(idx.numel(), device=dev) % 4096 + N)
    nv = plan.node_rows.numel()
    gather_bytes = (idx.numel() * s + nv + plan.block_rows.numel() + N * s) * 4
    scatter_bytes = (nv * s + N + 1 + nv + N * s) * 4
    # copies of the inputs, cycled so that 3x the 50 MB L2 passes between two uses of one copy
    sets = [(plan, u, f, idx, idx_spare)]
    for _ in range(min(reps, max(1, -(-3 * L2_BYTES // min(gather_bytes, scatter_bytes)))) - 1):
        p = dataclasses.replace(plan, **{k: getattr(plan, k).clone() for k in
                                         ("nodes_padded", "block_rows", "row_ptr", "node_rows")})
        sets.append((p, u.clone(), f.clone(), idx.clone(), idx_spare.clone()))
    calls = dict(gather=[lambda p=p, a=a: bd.banded_gather(p, a) for p, a, _, _, _ in sets],
                 scatter=[lambda p=p, a=a: bd.banded_scatter(p, a) for p, _, a, _, _ in sets],
                 index_select=[lambda a=a, i=i: torch.index_select(a, 0, i) for _, a, _, i, _ in sets],
                 index_add=[lambda a=a, i=i: torch.zeros((N + 4096, s), device=dev).index_add_(0, i, a.reshape(-1, s))
                            for _, _, a, _, i in sets])
    rec = dict(layout=name, s=s, n=plan.n, nodes=N, valid_rows=nv, padded_rows=idx.numel(), exact=bool(exact),
               copies=len(sets), **{f"{k}_ms": device_ms(fn) for k, fn in calls.items()},
               **{f"{k}_eager_ms": eager_ms(fn) for k, fn in calls.items()},
               gather_bytes=gather_bytes, scatter_bytes=scatter_bytes)
    print("record " + json.dumps(rec), flush=True)
    del plan, u, f, idx, idx_spare, sets, calls
    torch.cuda.empty_cache()
"""


_SOLVES = """
import json, sys, time
sys.path.insert(0, ".")
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
import fenris_tpu_torch.ops.banded as bd
from fenris_tpu_torch.mesh.reorder import reorder_mesh
from fenris_tpu_torch.ops._build import load_library

load_library()
dev = torch.device("cuda", 0)


def solve(model, cg_iters):
    return model.solve_mixed(tolerance=1e-10, cg_rel_tolerance=1e-4, max_newton_iterations=30,
                             callback=lambda k, fn, cg: cg is None or cg_iters.append(cg.num_iterations),
                             cg_max_iter=cs.SLICE_CG_MAX_ITER)


def run(cell, model, repeat):
    inner, diag, cg_iters, first = [], [], [], []
    cg_call = model._matrix_free_cg

    def keep_first(u, f, *args):
        if not first:
            first.append((u.clone(), f.clone(), *args))
        return cg_call(u, f, *args)

    model._matrix_free_cg = cs.timed(keep_first, inner)
    model.hessian_diagonal = cs.timed(model.hessian_diagonal, diag)
    for _ in range(repeat):
        inner.clear(), diag.clear(), cg_iters.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(model, cg_iters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print("solve " + json.dumps(dict(cell=cell, status=res.status, newton=res.iterations, cg_iters=cg_iters,
                                         wall_s=wall, cg_ms=(sum(inner) - sum(diag)) / max(sum(cg_iters), 1) * 1e3)),
              flush=True)
    # the first Newton step's CG call again, under torch.profiler (Jacobi diagonal included): the card's busy time
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = cg_call(*first[0])
        torch.cuda.synchronize()
    busy_us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
                  for e in prof.key_averages() if str(e.device_type).endswith("CUDA"))
    # the host's time to make one scatter call as the CG operator makes it (scatter_add: the autograd
    # function, then the wrapper) and the wrapper's alone, 200 calls back to back with no wait for the card
    plan = model._plan
    f = torch.randn((plan.padded_elements, plan.n, plan.s), device=dev)
    host_us = []
    for fn in (bd.scatter_add, bd.banded_scatter):
        for _ in range(20):
            fn(plan, f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn(plan, f)
        host_us.append((time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
    print("busy " + json.dumps(dict(cell=cell, busy_ms=busy_us / 1e3 / max(again.num_iterations, 1),
                                    scatter_add_host_us=host_us[0], banded_scatter_host_us=host_us[1])), flush=True)


cells, repeat = sys.argv[1].split(","), int(sys.argv[2])
for name in ("quad9", "tri6"):
    if f"S2D {name}" in cells:
        mesh, _ = reorder_mesh(cs.square_mesh(name, cs.RES_S2D), device=dev)
        run(f"S2D {name}", cs.model_2d(mesh, torch.float32, dev, banded=True, fused_kernels=True), repeat)
if "S10" in cells or "PE10" in cells:
    mesh, _ = reorder_mesh(cs.element_box("tet10", cs.RES_B10), device=dev)
if "S10" in cells:
    run("S10", cs.assembled_model(None, torch.float32, dev, None, mesh=mesh, banded=True, fused_kernels=True),
        repeat)
if "PE10" in cells:
    run("PE10", cs.assembled_model(None, torch.float32, dev, None, mesh=mesh, params=cs.two_material_params(mesh),
                                   banded=True, fused_kernels=True), repeat)
"""


def solves(roots, smi, cells, repeat) -> int:
    """The --solves mode: each checkout's solves of ``cells`` in turns, ``repeat`` times in each process."""
    runs = {}  # (root, cell) -> [ms a CG iteration of each solve]
    busy = {}  # (root, cell) -> [(card busy ms a CG iteration, host us a scatter_add call, a banded_scatter call)]
    for root in roots:
        print(f"== {root}", flush=True)
        proc = subprocess.run([sys.executable, "-c", _SOLVES, ",".join(cells), str(repeat)], cwd=root,
                              capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            kind, _, body = line.partition(" ")
            if kind == "solve":
                rec = json.loads(body)
                print(f"solve {rec['cell']}: status {rec['status']}, {rec['newton']} Newton steps, CG iterations "
                      f"{rec['cg_iters']}, wall {rec['wall_s']:.3f} s, {rec['cg_ms']:.4f} ms a CG iteration", flush=True)
                runs.setdefault((str(root), rec["cell"]), []).append(rec["cg_ms"])
            elif kind == "busy":
                rec = json.loads(body)
                print(f"busy {rec['cell']}: card busy {rec['busy_ms']:.4f} ms a CG iteration (first step, profiled); "
                      f"host {rec['scatter_add_host_us']:.2f} us a scatter_add call, {rec['banded_scatter_host_us']:.2f}"
                      " us a banded_scatter call", flush=True)
                busy.setdefault((str(root), rec["cell"]), []).append(
                    (rec["busy_ms"], rec["scatter_add_host_us"], rec["banded_scatter_host_us"]))
        if proc.returncode != 0:
            print(proc.stderr[-3000:], flush=True)
            return proc.returncode
    print(f"each checkout's solves: ms a CG iteration (median, lowest, highest, count), card busy ms a CG iteration "
          f"and host us a scatter_add / banded_scatter call (medians) ({smi}):", flush=True)
    for (root, cell), ms in sorted(runs.items(), key=lambda kv: (kv[0][1], kv[0][0])):
        b = [statistics.median(x) for x in zip(*busy[(root, cell)])]
        print(f"summary {cell} [{Path(root).name}]: {statistics.median(ms):.4f} ms a CG iteration ({min(ms):.4f}-"
              f"{max(ms):.4f}, {len(ms)} solves), card busy {b[0]:.4f}, host {b[1]:.2f} / {b[2]:.2f} us", flush=True)
    return 0


def build_layouts(smi):
    """Save each layout's cells (int32, after the RCM where the cell takes one) under LAYOUT_DIR."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from fenris_tpu_torch.mesh.convert import convert_mesh
    from fenris_tpu_torch.mesh.procedural import (
        create_unit_box_uniform_hex_mesh_3d,
        create_unit_box_uniform_tet_mesh_3d,
        create_unit_square_uniform_quad_mesh_2d,
        create_unit_square_uniform_tri_mesh_2d,
    )
    from fenris_tpu_torch.mesh.reorder import reorder_mesh

    LAYOUT_DIR.mkdir(parents=True, exist_ok=True)
    meshes = {}
    for name, element, res, rcm, _ in LAYOUTS:
        key = (element, res, rcm)
        if key not in meshes:
            if element.startswith(("quad", "tri")):
                base = (create_unit_square_uniform_tri_mesh_2d if element.startswith("tri") else
                        create_unit_square_uniform_quad_mesh_2d)(res)
                mesh = base if element in ("quad4", "tri3") else convert_mesh(base, element)
            else:
                base = (create_unit_box_uniform_tet_mesh_3d if element.startswith("tet") else
                        create_unit_box_uniform_hex_mesh_3d)(res)
                mesh = base if element == "hex8" else convert_mesh(base, element)
            if rcm:
                mesh, _ = reorder_mesh(mesh, device=torch.device("cuda", 0))
            meshes[key] = np.asarray(mesh.cells, dtype=np.int32)
        np.save(LAYOUT_DIR / f"{name.replace(' ', '_')}.npy", meshes[key])
        print(f"layout {name}: {meshes[key].shape[0]} cells of {element} ({smi})", flush=True)
    torch.cuda.empty_cache()


def main() -> int:
    args = sys.argv[1:]
    opts = {a: args[i + 1] for i, a in enumerate(args) if a in ("--cells", "--repeat")}
    roots = [Path(a).resolve() for i, a in enumerate(args)
             if not a.startswith("--") and (i == 0 or args[i - 1] not in opts)]
    if not roots:
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if "--solves" in args:
        cells = opts.get("--cells", "S2D quad9,S2D tri6,S10,PE10").split(",")
        return solves(roots, smi, cells, int(opts.get("--repeat", 1)))
    build_layouts(smi)
    layouts = json.dumps([(name, s) for name, *_, s in LAYOUTS])
    best = {}  # (root, layout) -> record of the lowest times
    failed = False
    for root in roots:
        print(f"== {root}", flush=True)
        proc = subprocess.run([sys.executable, "-c", _RUN, str(LAYOUT_DIR), str(REPS), layouts], cwd=root,
                              capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if not line.startswith("record "):
                continue
            rec = json.loads(line[len("record "):])
            print(f"time {rec['layout']}: card (eager) ms: gather {rec['gather_ms']:.4f} "
                  f"({rec['gather_eager_ms']:.4f}), scatter {rec['scatter_ms']:.4f} ({rec['scatter_eager_ms']:.4f}), "
                  f"index_select {rec['index_select_ms']:.4f} ({rec['index_select_eager_ms']:.4f}), index_add_ "
                  f"{rec['index_add_ms']:.4f} ({rec['index_add_eager_ms']:.4f}), bitwise equal to the plain versions: "
                  f"{rec['exact']}", flush=True)
            failed |= not rec["exact"]
            prev = best.setdefault((str(root), rec["layout"]), rec)
            for key in TIMES:
                prev[key] = min(prev[key], rec[key])
        if proc.returncode != 0:
            print(proc.stderr[-3000:], flush=True)
            return proc.returncode
    print(f"lowest of each checkout's runs, card ms (eager ms) ({smi}); share = bound / card time, bound = bytes / "
          "3.35 TB/s:", flush=True)
    for name, *_ in LAYOUTS:
        for root in dict.fromkeys(str(r) for r in roots):
            r = best[(root, name)]
            gb, sb = r["gather_bytes"] / HBM_BYTES_PER_S * 1e3, r["scatter_bytes"] / HBM_BYTES_PER_S * 1e3
            print(f"summary {name} s={r['s']} n={r['n']} [{Path(root).name}]: gather {r['gather_ms']:.4f} "
                  f"({r['gather_eager_ms']:.4f}; {gb / r['gather_ms'] * 100:.1f}% of {gb:.4f}; index_select "
                  f"{r['index_select_ms']:.4f} ({r['index_select_eager_ms']:.4f})), scatter {r['scatter_ms']:.4f} "
                  f"({r['scatter_eager_ms']:.4f}; {sb / r['scatter_ms'] * 100:.1f}% of {sb:.4f}; index_add_ "
                  f"{r['index_add_ms']:.4f} ({r['index_add_eager_ms']:.4f}))", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
