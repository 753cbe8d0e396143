"""Time LOC (b) of ``chip_smoke.py`` with each shortcut of ``fenris_tpu_torch/space.py`` switched off in turn.

Usage, from the root of a checkout on a machine with a card:

    python3 tools/location_ablation.py [--timeout SECONDS] [VARIANT ...]

LOC (b) is ``find_closest_element`` with the grid index on a LOC_GRID^3 grid
around the Gmsh sphere refined MSH_LEVELS times (303,616 tet4, about 63% of
the points outside), f64.  Each variant runs in its own process, in the
order given (default: ``all prune prepass charts brute all``; the two
``all`` runs give the run-to-run spread), after one warm-up call on 4,096
of the points, and prints the seconds of the timed call, the charted and
re-run counts and, against the first variant, the largest distance
difference and the number of points whose element differs.  A variant
past ``--timeout`` seconds (default 300) is reported as cut.

Variants (the shortcuts are the port's; JAX's concrete branch has none):

* ``all``: every shortcut on, as the package runs;
* ``prune``: every candidate column queried in one block, none skipped
  for its AABB distance or because another candidate contains the point
  (``space._open_pairs``);
* ``prepass``: the pre-pass takes 24 Newton steps on every pair, without
  the one-step filter on affine geometry (``space._inside_pass``);
* ``charts``: every uncovered pair takes the 24-step chart pass, without
  the one-step chart filter on affine geometry
  (``space._charts_that_can_win``);
* ``brute``: the brute force's candidates from every element's AABB
  distance (``[Q, E, d]``, then a selection over ``[Q, E]`` ranked as
  JAX's ``top_k``), without the f32 centre-distance filter
  (``space._brute_candidates``).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = ("all", "prune", "prepass", "charts", "brute")

_RUN = """
import sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
import fenris_tpu_torch.space as S

variant, out = sys.argv[1], sys.argv[2]
if variant == "prune":
    S.FIRST_BLOCK = 1 << 30

    def open_all(cand, cand_dist, covered, bound, lo, hi):
        q, j = torch.nonzero(cand[:, lo:hi] >= 0).unbind(1)
        return q, j + lo

    S._open_pairs = open_all
elif variant == "prepass":
    S._inside_pass = lambda el, X, p, c, q, j, tol: S._closest_pairs(el, X, p, c, q, j, tol, False)
elif variant == "charts":
    S._charts_that_can_win = lambda el, X, p, c, q, j, chart, best, slack, tol: chart
elif variant == "brute":
    def brute_all(a, points, num_candidates):
        Q, E = points.shape[0], a["lo"].shape[0]
        k = min(num_candidates, E)
        kk = min(k + 1, E)
        d2 = S._aabb_d2(a["lo"][None], a["hi"][None], points[:, None])  # [Q, E]
        T2 = torch.topk(d2, kk, dim=1, largest=False).values[:, -1:]
        # every element within the (k+1)-th distance, ties included, ranked as top_k ranks them
        rows, cols = torch.nonzero(d2 <= T2).unbind(1)
        counts = torch.bincount(rows, minlength=Q)
        pos = torch.arange(rows.numel(), device=rows.device) - (torch.cumsum(counts, 0) - counts)[rows]
        table = torch.full((Q, int(counts.max())), torch.inf, dtype=points.dtype, device=points.device)
        ids = torch.zeros(table.shape, dtype=torch.int64, device=points.device)
        table[rows, pos], ids[rows, pos] = d2[rows, cols], cols
        d2, sel = torch.sort(table, dim=1, stable=True)
        limit = torch.sqrt(d2[:, k].clamp_min(0.0)).double() if kk > k else points.new_full((Q,), torch.inf).double()
        return torch.gather(ids, 1, sel[:, :k]), torch.sqrt(d2[:, :k] + 1e-300), limit

    S._brute_candidates = brute_all
elif variant != "all":
    raise SystemExit(f"unknown variant {variant}")
dev = torch.device("cuda", 0)
sphere, _ = cs.refined_sphere()
P = cs.loc_grid_points(sphere, dev)
index = S.GridIndex.build(sphere)
warm = torch.as_tensor(np.random.default_rng(63).choice(P.shape[0], 4096, replace=False), device=dev)
S.find_closest_element(sphere, P[warm], index=index)
S.location_counts.update(charted=0, reruns=0)
torch.cuda.synchronize()
t0 = time.perf_counter()
res = S.find_closest_element(sphere, P, index=index)
torch.cuda.synchronize()
seconds = time.perf_counter() - t0
np.savez(out, element=res.element_indices.cpu().numpy(), distance=res.domain_distance.cpu().numpy())
print(f"{seconds!r} {S.location_counts['charted']} {S.location_counts['reruns']} {sphere.num_cells} {P.shape[0]}")
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", metavar="VARIANT", help=f"of {', '.join(VARIANTS)}")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args()
    variants = args.variants or [*VARIANTS, "all"]
    if set(variants) - set(VARIANTS):
        ap.error(f"unknown variants {sorted(set(variants) - set(VARIANTS))}")
    import numpy as np

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    first = None
    with tempfile.TemporaryDirectory() as tmp:
        for n, variant in enumerate(variants):
            out = str(Path(tmp) / f"{n}.npz")
            try:
                run = subprocess.run([sys.executable, "-c", _RUN, variant, out], cwd=ROOT, capture_output=True,
                                     text=True, timeout=args.timeout)
            except subprocess.TimeoutExpired:
                print(f"{variant}: cut at {args.timeout:g} s ({smi})", flush=True)
                continue
            if run.returncode:
                print(f"{variant}: failed (exit {run.returncode})\n{run.stderr[-4000:]}", flush=True)
                return 1
            seconds, charted, reruns, cells, points = run.stdout.split()[-5:]
            got = np.load(out)
            first = first or out
            ref = np.load(first)
            d_diff = float(np.abs(got["distance"] - ref["distance"]).max())
            other = int((got["element"] != ref["element"]).sum())
            print(f"{variant}: {points} points, {cells} tets: {float(seconds):.3f} s, charted {charted}, re-runs "
                  f"{reruns}; against the first variant: max distance difference {d_diff:.3e}, {other} other "
                  f"elements ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
