"""Time the fused element sweeps of two checkouts in turns on one card, and the solves that run them.

Usage, from the root of a checkout on a machine with a card:

    python3 tools/em_sweep_ab.py OLD NEW [NEW ...] [--cells C2,M10,...] [--solves S10,PE10,...] [--reps 20]

OLD and each NEW are roots of checkouts (e.g. a ``git archive`` of the
parent unpacked under ``data/``, ``.``, and variants of it: a copy of
``fenris_tpu_torch/`` with a ``constexpr`` changed suffices).  Each builds
its own kernel library (its ``fenris_tpu_torch/_build/``, ``-Xptxas -v``
log beside it: the spills of each variant's sweeps are printed); all are
loaded into this one process and run on the same inputs: the meshes,
models and plans are this checkout's, and each launch goes to one
library's ``fenris_banded_sweep`` (the C interface all export).

* ``--cells``: the fused banded sweeps (``banded_tangent_sweep``, the CG
  operator, and ``banded_vector_sweep``, the residual) at the layouts
  ``chip_smoke.py`` times them at: C2 and C3 (hex8, Neo-Hookean), M10
  (tet10) and M20 (hex20) with each material, M27 (hex27 on a res-48 box,
  each material; no ``chip_smoke.py`` cell), M2D (quad4, quad8, quad9,
  tri3, tri6, each material), T4-MG (tet4, each material), MSH (the
  refined Gmsh sphere, tet4), E10 and E8 (PE10's and ME's two-material
  ``[E]`` parameters on tet10 and hex8).  Per shape, ``--turns`` rounds of
  OLD, NEW, ..., NEW, OLD (every library forth and back), each the mean of
  ``--reps`` launches timed with CUDA events after 3 warm-up launches
  (``--graph``: one replay of a CUDA graph of them, without the host's
  time a launch, on inputs the L2 may partly keep); the line gives every
  time and each NEW's lowest over OLD's lowest.  The
  libraries' outputs must agree with OLD's to 1e-5 relative (their
  summation orders may differ).
* ``--solves``: ``solve_mixed`` to 1e-10 (``cg_rel_tolerance`` 1e-4) of
  S10, PE10, S20, T4-MG (Jacobi), MSH, GEO and S2D (quad9 and tri6, res
  128), as ``chip_smoke.py`` sets them up, with ``load_library`` of the
  element sweeps routed to OLD, NEW, NEW, OLD, ... (the first NEW; the gather and scatter
  run on this checkout's kernels): wall, Newton steps, CG iterations, ms a
  CG iteration (the CG loops' time without the Jacobi diagonals, over
  their iterations) and the relative residual of an independent f64
  model.

Prints one ``ab`` line a shape or solve run, with the card's name and power
limit first.  Compare two versions only inside one call.
"""

from __future__ import annotations

import argparse
import importlib.util
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SWEEP_CELLS = ("C2", "C3", "M10", "M20", "M27", "M2D", "T4-MG", "MSH", "E10", "E8")
RES_M27 = 48  # hex27 on convert_mesh(box 48): 110,592 cells, 912,673 nodes
SOLVE_CELLS = ("S10", "PE10", "S20", "T4-MG", "MSH", "GEO", "S2D")


def library(root: Path, tag: str):
    """The kernel library of the checkout at ``root``, built by that checkout's own ``_build.py``; prints the
    element sweeps that ptxas reports spilling."""
    spec = importlib.util.spec_from_file_location(f"_em_ab_build_{tag}", root / "fenris_tpu_torch/ops/_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = mod.load_library()
    import fenris_tpu_torch.ops.em_sweep as es

    entry, spills, regs = None, [], {}
    for line in mod.build_log().read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            em = re.search(r"_kernelILb(\d)ELb(\d)ELi(\d)ELi(\d+)ELi(\d+)ELi(\d)E", m.group(1))
            entry = None if em is None else tuple(int(x) for x in em.groups())
        elif entry and "spill stores" in line and "0 bytes spill stores" not in line:
            spills.append(entry)
        elif entry and "Used" in line and entry[0] == 1 and entry[5] == 0:  # banded Neo-Hookean
            regs[f"{es.ELEMENTS[entry[2:5]]} {'T' if entry[1] else 'V'}"] = int(re.search(r"Used (\d+)", line)[1])
    print(f"library {tag} ({root}): {len(spills)} sweeps spill {spills[:12]}; banded Neo-Hookean registers {regs}",
          flush=True)
    return lib


def event_ms(fn, reps, graph=False):
    """ms a call of ``fn``: ``reps`` calls after 3 warm-up calls between CUDA events, or with ``graph`` one
    replay of a CUDA graph of ``reps`` calls (no host time a launch; the inputs stay the same, so the L2 may
    keep part of them)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    run = lambda: [fn() for _ in range(reps)]  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        g.replay()
        run = g.replay
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def banded_call(lib, model, u, v, op, params):
    """One ``fenris_banded_sweep`` of ``lib`` on ``model``'s banded layout (v None: the vector sweep)."""
    import torch

    import fenris_tpu_torch.ops.em_sweep as es

    plan, X, tab = model._plan, model._X_band, model.tab
    E = plan.padded_elements
    tables, q, d, m, n, material, *lame, kept = es._kernel_args(X, op, params, tab, model._em_tables, E)
    out = torch.empty((E, n, d), dtype=torch.float32, device=X.device)
    code = lib.fenris_banded_sweep(
        X.data_ptr(), u.data_ptr(), None if v is None else v.data_ptr(), plan.nodes_padded.data_ptr(),
        plan.block_rows.data_ptr(), out.data_ptr(), E, plan.elements_per_block, tables.data_ptr(), q, d, m, n,
        material, *lame, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"fenris_banded_sweep: CUDA error {code}")
    del kept
    return out


def layout_text(lib, model, op, tangent):
    """The NEW library's launch geometry (``fenris_em_layout``), when it has one."""
    import ctypes

    import fenris_tpu_torch.ops.em_sweep as es

    fn = getattr(lib, "fenris_em_layout", None)
    if fn is None:
        return ""
    out = (ctypes.c_int * 5)()
    tab, d = model.tab, model.mesh.dim
    material = list(es.MATERIALS.values()).index(type(op.material))
    fn(1, int(tangent), tab.num_points, d, tab.geo_dphi.shape[1], tab.dphi.shape[1], material, out)
    return (f" [NEW layout: {out[0]} lanes an element, {out[1]} elements a tile, {out[2]} threads, "
            f"{out[3]} shared bytes, {out[4]} blocks an SM]")


def sweep_turns(cell, model, libs, args, params=None):
    """Every material's (or the model's own, with ``params``) tangent and vector sweeps, OLD and NEW in turns."""
    import torch

    import fenris_tpu_torch.ops.em_sweep as es
    import chip_smoke as cs
    from fenris_tpu_torch.solid import MaterialEllipticOperator

    N, d = model._plan.num_nodes, model.mesh.dim
    g = torch.Generator(device="cuda").manual_seed(31)
    u = cs.displacement(model, 32).reshape(N, d)
    v = torch.randn((N, d), generator=g, device="cuda")
    materials = {"neo_hookean": es.MATERIALS["neo_hookean"]} if params is not None or cell in ("C2", "C3", "MSH") \
        else es.MATERIALS
    name = model.mesh.element.name
    order = list(range(len(libs)))
    for material, cls in materials.items():
        op = MaterialEllipticOperator(cls(), dim=d)
        p = params if params is not None else model.params
        for kind, vv in (("tangent", v), ("vector", None)):
            outs = [banded_call(lib, model, u, vv, op, p) for lib in libs]
            torch.cuda.synchronize()
            rels = [float((o.double() - outs[0].double()).abs().max() / outs[0].double().abs().max()) for o in outs]
            del outs
            times = {k: [] for k in order}
            for _ in range(args.turns):
                for k in order + order[::-1]:
                    times[k].append(event_ms(lambda k=k: banded_call(libs[k], model, u, vv, op, p), args.reps,
                                             args.graph))
            old = min(times[0])
            txt = ", ".join(f"{'OLD' if k == 0 else f'NEW{k}'} {'/'.join(f'{t:.4f}' for t in times[k])} ms"
                            + ("" if k == 0 else f" ({min(times[k]) / old:.3f}, rel {rels[k]:.1e})") for k in order)
            print(f"ab sweep {cell} {name} {material} {kind} E_pad={model._plan.padded_elements}: {txt}"
                  f"{layout_text(libs[1], model, op, kind == 'tangent')}", flush=True)
            if max(rels) > 1e-5 and not args.no_check:
                raise RuntimeError(f"{cell} {name} {material} {kind}: the libraries differ by {max(rels):.3e}")


def box(name, res, rcm=True):
    import chip_smoke as cs
    from fenris_tpu_torch.mesh.reorder import reorder_mesh

    mesh = cs.element_box(name, res)
    return reorder_mesh(mesh, device="cuda")[0] if rcm else mesh


def t4_mesh():
    import chip_smoke as cs
    from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_tet_mesh_3d
    from fenris_tpu_torch.multigrid import rcm_refined_hierarchy

    return rcm_refined_hierarchy(create_unit_box_uniform_tet_mesh_3d(cs.RES_T4_COARSE), cs.T4_LEVELS, device="cuda")[0]


def sphere_model(kind, dtype, mesh=None, **kw):
    """MSH's (the refined Gmsh sphere, cap z < MSH_CAP_Z) or GEO's (the procedural sphere) model, RCM'd."""
    import numpy as np

    import chip_smoke as cs
    from fenris_tpu_torch.elasticity import HyperelasticModel
    from fenris_tpu_torch.mesh.procedural import create_simple_stupid_sphere
    from fenris_tpu_torch.mesh.refinement import refine_uniformly
    from fenris_tpu_torch.mesh.reorder import reorder_mesh
    from fenris_tpu_torch.solid import LameParameters, NeoHookeanMaterial

    if mesh is None:
        if kind == "MSH":
            mesh = cs.refined_sphere()[0]
        else:
            mesh = cs.weld(create_simple_stupid_sphere([0.0, 0.0, 0.0], 1.0, cs.GEO_SWEEPS).triangulate(), 1e-12)[0]
            while mesh.num_cells < cs.GEO_MIN_TETS:
                mesh = refine_uniformly(mesh)
        mesh = reorder_mesh(mesh, device="cuda")[0]
    cap = cs.MSH_CAP_Z if kind == "MSH" else cs.GEO_CAP_Z
    return HyperelasticModel(mesh=mesh, material=NeoHookeanMaterial(), params=LameParameters(mu=cs.MU, lam=cs.LAM),
                             dirichlet_nodes=np.flatnonzero(mesh.points[:, 2] < cap), body_force=np.array(cs.BODY_A),
                             dtype=dtype, device="cuda", **kw)


def sweep_cell(cell, libs, args):
    import torch

    import chip_smoke as cs

    f32 = dict(banded=True, fused_kernels=True)
    if cell in ("C2", "E8"):
        model = cs.assembled_model(cs.RES_A, torch.float32, "cuda", None, **f32)
    elif cell == "C3":
        model = cs.assembled_model(None, torch.float32, "cuda", None, mesh=box("hex8", cs.RES_C3), **f32)
    elif cell in ("M10", "E10"):
        model = cs.assembled_model(None, torch.float32, "cuda", None, mesh=box("tet10", cs.RES_B10), **f32)
    elif cell == "M20":
        model = cs.assembled_model(None, torch.float32, "cuda", None, mesh=box("hex20", cs.RES_B20), **f32)
    elif cell == "M27":
        model = cs.assembled_model(None, torch.float32, "cuda", None, mesh=box("hex27", RES_M27), **f32)
    elif cell == "T4-MG":
        model = cs.assembled_model(0, torch.float32, "cuda", None, mesh=t4_mesh(), **f32)
    elif cell == "MSH":
        model = sphere_model("MSH", torch.float32, **f32)
    elif cell == "M2D":
        from fenris_tpu_torch.mesh.reorder import reorder_mesh

        for name, res in cs.B2_MESHES.items():
            mesh = reorder_mesh(cs.square_mesh(name, res), device="cuda")[0]
            model = cs.model_2d(mesh, torch.float32, "cuda", **f32)
            sweep_turns(cell, model, libs, args)
            del model
            torch.cuda.empty_cache()
        return
    else:
        raise SystemExit(f"unknown sweep cell {cell}")
    params = None
    if cell in ("E10", "E8"):
        from fenris_tpu_torch.solid import LameParameters

        index = torch.as_tensor(model._plan.element_index, device="cuda")  # padded as the model pads them
        params = LameParameters(*(torch.as_tensor(x, dtype=torch.float32, device="cuda")[index]
                                  for x in cs.two_material_params(model.mesh)))
    sweep_turns(cell, model, libs, args, params)
    del model
    torch.cuda.empty_cache()


def solve_models(cell):
    """``[(label, f32 fused model, f64 check model, solve keyword arguments)]`` of a solve cell."""
    import torch

    import chip_smoke as cs

    f32 = dict(banded=True, fused_kernels=True)
    big = dict(cg_max_iter=cs.SLICE_CG_MAX_ITER)
    if cell in ("S10", "PE10"):
        mesh = box("tet10", cs.RES_B10)
        params = cs.two_material_params(mesh) if cell == "PE10" else None
        kw = {} if params is None else {"params": params}
        return [(cell, cs.assembled_model(None, torch.float32, "cuda", None, mesh=mesh, **kw, **f32),
                 cs.assembled_model(None, torch.float64, "cuda", 8192, mesh=mesh, **kw), big if params else {})]
    if cell == "S20":
        mesh = box("hex20", cs.RES_B20)
        return [(cell, cs.assembled_model(None, torch.float32, "cuda", None, mesh=mesh, **f32),
                 cs.assembled_model(None, torch.float64, "cuda", 8192, mesh=mesh), {})]
    if cell == "T4-MG":
        mesh = t4_mesh()
        return [(cell + " Jacobi", cs.assembled_model(0, torch.float32, "cuda", None, mesh=mesh, **f32),
                 cs.assembled_model(None, torch.float64, "cuda", 8192, mesh=mesh), big)]
    if cell in ("MSH", "GEO"):
        model = sphere_model(cell, torch.float32, **f32)
        return [(cell, model, sphere_model(cell, torch.float64, mesh=model.mesh, chunk_size=8192), {})]
    if cell == "S2D":
        from fenris_tpu_torch.mesh.reorder import reorder_mesh

        out = []
        for name in ("quad9", "tri6"):
            mesh = reorder_mesh(cs.square_mesh(name, cs.RES_S2D), device="cuda")[0]
            out.append((f"S2D {name}", cs.model_2d(mesh, torch.float32, "cuda", **f32),
                        cs.model_2d(mesh, torch.float64, "cuda", 8192), big))
        return out
    raise SystemExit(f"unknown solve cell {cell}")


def solve_turns(cell, libs, args):
    from unittest import mock

    import torch

    import fenris_tpu_torch.ops.em_sweep as es
    import chip_smoke as cs

    for label, model, check, kw in solve_models(cell):
        r0 = float(torch.linalg.vector_norm(check.residual(torch.zeros(model.space.num_dofs, dtype=torch.float64,
                                                                        device="cuda"))))
        for k in (0, 1, 1, 0)[: 2 * args.solve_turns]:
            inner, diag, cg = [], [], []
            model._matrix_free_cg = cs.timed(model._matrix_free_cg, inner)
            model.hessian_diagonal = cs.timed(model.hessian_diagonal, diag)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with mock.patch.object(es, "load_library", lambda k=k: libs[k]):
                res = model.solve_mixed(tolerance=1e-10, cg_rel_tolerance=1e-4, max_newton_iterations=30,
                                        callback=lambda i, f, c: c is not None and cg.append(c.num_iterations), **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            del model._matrix_free_cg, model.hessian_diagonal
            rel = float(torch.linalg.vector_norm(check.residual(res.x.detach().double()))) / r0
            iters = max(sum(cg), 1)
            print(f"ab solve {label} {'OLD' if k == 0 else 'NEW'}: status {res.status} wall {wall:.3f} s, Newton "
                  f"{res.iterations}, CG {cg} (sum {sum(cg)}), {(sum(inner) - sum(diag)) / iters * 1e3:.4f} ms a CG "
                  f"iteration, independent f64 rel residual {rel:.3e}", flush=True)
            del res
        del model, check
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", type=Path, nargs="+", help="OLD, then one or more NEW checkouts")
    ap.add_argument("--cells", default=",".join(SWEEP_CELLS))
    ap.add_argument("--solves", default="")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--graph", action="store_true",
                    help="time the sweeps as CUDA-graph replays (no host time a launch) instead of eager calls")
    ap.add_argument("--no-check", action="store_true",
                    help="time libraries whose outputs differ (ablations: a variant that skips a phase)")
    ap.add_argument("--solve-turns", type=int, default=2, help="pairs of OLD/NEW solves (OLD NEW NEW OLD: 2)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("em_sweep_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    t0 = time.perf_counter()
    if len(args.roots) < 2:
        raise SystemExit("em_sweep_ab: give OLD and at least one NEW checkout")
    libs = [library(root.resolve(), "old" if k == 0 else f"new{k}") for k, root in enumerate(args.roots)]
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    for cell in filter(None, args.cells.split(",")):
        t0 = time.perf_counter()
        sweep_cell(cell, libs, args)
        print(f"cell {cell}: {time.perf_counter() - t0:.1f} s", flush=True)
    for cell in filter(None, args.solves.split(",")):
        t0 = time.perf_counter()
        solve_turns(cell, libs, args)
        print(f"solves {cell}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
