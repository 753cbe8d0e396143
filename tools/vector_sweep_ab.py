#!/usr/bin/env python3
"""Time the fused vector sweep against the route it replaced, built from an older em_sweep source.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/vector_sweep_ab.py OLD_EM_SWEEP_CU

``OLD_EM_SWEEP_CU`` is an ``em_sweep.cu`` whose ``fenris_em_sweep`` takes
(X, u, v, out, strides[12], E, tables, q, mu, lam, stream), as the port's
has since it was first written (for example the file from a ``git archive``
of an earlier commit).  It is built with the port's nvcc flags into its own
library.  On path C2's layout (the res-149 box, 3,354,624 padded elements)
and path C3's (the RCM-reordered res-63 box) the script holds the fused
``banded_vector_sweep`` and the old route -- the banded gather, then the
old library's element-minor vector sweep on the gathered element-major
rows, what the fused model's residual ran before -- against the plain
version (max |k - p| / max |p| <= 1e-5), and times the two in turns (old,
fused, fused, old; CUDA events, 10 launches each) beside the card's
``nvidia-smi`` name and power limit.  It exits non-zero if the build or a
check fails or no CUDA device is present.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the smoke test's models, inputs and timers)


def build_old(source: Path) -> ctypes.CDLL:
    from fenris_tpu_torch.ops._build import _COMPILE, _LINK, _nvcc

    out_dir = ROOT / "fenris_tpu_torch/_build/variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    obj, lib = out_dir / "old_em_sweep.o", out_dir / "libold_em_sweep.so"
    nvcc = _nvcc()
    subprocess.run([nvcc, *_COMPILE, "-o", str(obj), str(source)], check=True, capture_output=True)
    subprocess.run([nvcc, *_LINK, "-o", str(lib), str(obj)], check=True)
    cdll = ctypes.CDLL(str(lib))
    P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    cdll.fenris_em_sweep.argtypes = [P, P, P, P, ctypes.POINTER(L), L, P, I, F, F, P]
    cdll.fenris_em_sweep.restype = I
    return cdll


def ab(old, model, shape_txt, smi):
    import torch

    import fenris_tpu_torch.ops.banded as bd
    import fenris_tpu_torch.ops.em_sweep as es

    plan, X, tables = model._plan, model._X_band, model._em_tables
    op, params, tab = model.operator, model.params, model.tab
    u = cs.displacement(model, seed=5).reshape(-1, 3)
    E, q = plan.padded_elements, tab.num_points
    mu, lam = float(params.mu), float(params.lam)

    def old_route():
        ue = bd.banded_gather(plan, u).permute(1, 2, 0)
        out = torch.empty_like(ue)
        strides = (ctypes.c_longlong * 12)(*X.stride(), *ue.stride(), *ue.stride(), *out.stride())
        code = old.fenris_em_sweep(X.data_ptr(), ue.data_ptr(), None, out.data_ptr(), strides, E, tables.data_ptr(),
                                   q, mu, lam, torch.cuda.current_stream().cuda_stream)
        cs.check(code == 0, f"old em_vector_sweep: CUDA error {code}")
        return out.permute(2, 0, 1)  # the element-major rows the scatter reads

    fused = lambda: es.banded_vector_sweep(plan, X, u, op, params, tab, tables)  # noqa: E731
    ref = es.banded_vector_sweep_plain(plan, X, u, op, params, tab)
    cs.compare("banded_vector_sweep", shape_txt, fused(), fused(), ref)
    cs.compare("old route (gather + old em_vector_sweep)", shape_txt, old_route(), old_route(), ref)
    del ref
    fused_ms, old_ms, txt = cs.in_turns(fused, old_route, reps=10, names=("fused", "old route"))
    cs.log(f"time banded_vector_sweep {shape_txt}: {txt} (fused faster: {fused_ms < old_ms}; "
           f"{old_ms / fused_ms:.3f}x) ({smi})")
    cs.free_memory()


def main() -> int:
    import torch

    from fenris_tpu_torch.mesh.procedural import create_unit_box_uniform_hex_mesh_3d
    from fenris_tpu_torch.mesh.reorder import reorder_mesh

    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("vector_sweep_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cs.log(smi)
    dev = torch.device("cuda", 0)
    old = build_old(Path(sys.argv[1]).resolve())
    model = cs.assembled_model(cs.RES_A, torch.float32, dev, None, banded=True, fused_kernels=True)
    p = model._plan
    ab(old, model, f"res={cs.RES_A} E_pad={p.padded_elements} blocks={p.k_blocks}", smi)
    del model
    cs.free_memory()
    mesh, _ = reorder_mesh(create_unit_box_uniform_hex_mesh_3d(cs.RES_C3))
    model = cs.assembled_model(cs.RES_C3, torch.float32, dev, None, mesh=mesh, banded=True, fused_kernels=True)
    p = model._plan
    ab(old, model, f"res={cs.RES_C3} rcm E={mesh.num_cells} E_pad={p.padded_elements} blocks={p.k_blocks}", smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
