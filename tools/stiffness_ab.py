"""Time entry B (the hex8 element-stiffness kernel at res 99) of several checkouts in turns on one card.

Usage, from the root of a checkout on a machine with a card:

    python3 tools/stiffness_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout (e.g. a ``git archive`` of the
parent unpacked under ``data/``); each runs in its own process, in the
order given, its own ``chip_smoke.stiffness_phases``: the kernel against its
plain version (linear elasticity and Laplace), timed in turns with it, and
the public entry point.  Compare two versions only inside one call.
"""

import subprocess
import sys
from pathlib import Path

_RUN = """
import subprocess, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
import fenris_tpu_torch.ops.stiffness_pairs as sp
from fenris_tpu_torch.ops._build import load_library
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip()
load_library()
cs.stiffness_phases({"stiffness_pairs": dict(fn=sp.stiffness_pairs)}, torch.device("cuda", 0), smi)
"""


def main() -> int:
    roots = [Path(a).resolve() for a in sys.argv[1:]]
    if not roots:
        raise SystemExit(__doc__)
    for root in roots:
        print(f"== {root}", flush=True)
        proc = subprocess.run([sys.executable, "-c", _RUN], cwd=root, capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(("time stiffness_pairs", "entry B"))]
        print("\n".join(lines), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-2000:], flush=True)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
