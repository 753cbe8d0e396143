"""Time the fused hex8 Neo-Hookean element sweeps of several checkouts in turns on one card.

Usage, from the root of a checkout on a machine with a card:

    python3 tools/em_sweep_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout (e.g. a ``git archive`` of the
parent unpacked under ``data/``); each runs in its own process, in the
order given, and builds its own kernels.  It times
``banded_tangent_sweep`` (the matrix-free CG operator) and
``banded_vector_sweep`` (the residual) with CUDA events at path C2's layout
(``chip_smoke.py``: tools/solve_assembled.py's res-149 box, 3,307,949 hex8)
and C3's (the RCM-reordered res-63 box), f32, on the same seeded inputs, and
prints the lower of two runs of 20 launches each.  Compare two versions only
inside one call.
"""

import subprocess
import sys
from pathlib import Path

_RUN = """
import subprocess, sys
sys.path.insert(0, ".")
import numpy as np
import torch
from fenris_tpu_torch.elasticity import HyperelasticModel
from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d
from fenris_tpu_torch.mesh.reorder import reorder_mesh
from fenris_tpu_torch.ops import em_sweep as es
from fenris_tpu_torch.ops._build import load_library
from fenris_tpu_torch.solid import LameParameters, NeoHookeanMaterial

smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip()
load_library()
dev = torch.device("cuda", 0)


def event_ms(fn, reps=20):
    for _ in range(3):
        fn()
    best = float("inf")
    for _ in range(2):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) / reps)
    return best


for cell, res, rcm in (("C2", 149, False), ("C3", 63, True)):
    mesh = create_unit_box_uniform_hex_mesh_3d(res)
    if rcm:
        mesh, _ = reorder_mesh(mesh, device=dev)
    model = HyperelasticModel(mesh=mesh, material=NeoHookeanMaterial(), params=LameParameters(384.614, 576.923),
                              dirichlet_nodes=np.flatnonzero(mesh.points[:, 2] < 1e-12),
                              body_force=np.array([0.0, 0.0, -4.0]), dtype=torch.float32, device=dev, banded=True,
                              fused_kernels=True)
    plan, X, tab, tables = model._plan, model._X_band, model.tab, model._em_tables
    g = torch.Generator(device=dev).manual_seed(11)
    N = plan.num_nodes
    u = (torch.rand((N, 3), generator=g, device=dev) * 2 - 1) * (0.01 / res)
    v = torch.randn((N, 3), generator=g, device=dev)
    op, params = model.operator, model.params
    tangent = event_ms(lambda: es.banded_tangent_sweep(plan, X, u, v, op, params, tab, tables))
    vector = event_ms(lambda: es.banded_vector_sweep(plan, X, u, op, params, tab, tables))
    print(f"time {cell} res={res} E_pad={plan.padded_elements}: banded_tangent_sweep {tangent:.4f} ms, "
          f"banded_vector_sweep {vector:.4f} ms ({smi})", flush=True)
    del model, plan, X, u, v
    torch.cuda.empty_cache()
"""


def main() -> int:
    roots = [Path(a).resolve() for a in sys.argv[1:]]
    if not roots:
        raise SystemExit(__doc__)
    for root in roots:
        print(f"== {root}", flush=True)
        proc = subprocess.run([sys.executable, "-c", _RUN], cwd=root, capture_output=True, text=True)
        print("\n".join(ln for ln in proc.stdout.splitlines() if ln.startswith("time ")), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-2000:], flush=True)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
