"""Build and load the port's CUDA kernels (nvcc + ctypes).

The kernels live in ``fenris_tpu_torch/csrc/*.cu`` and have a plain C
interface, so they build with ``nvcc`` alone in seconds (no PyTorch
headers).  The first call of :func:`load_library` compiles every source
into an object file (``em_sweep.cu`` once per element, ``-DFENRIS_EM_ELEMENT``
0-10: its 132 instantiations would make it the one long compile), all ``nvcc``
processes started together, links them
into one shared library under ``fenris_tpu_torch/_build/`` named by a hash
of the sources and flags, with the ``nvcc`` log beside it under the same
name (:func:`build_log`), and loads it; later calls reuse the library.
Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load_library", "build_log", "check", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"
_SOURCES = tuple(
    _PKG / "csrc" / name
    for name in ("structured_stencil.cu", "dia_sweep.cu", "stiffness_pairs.cu", "banded.cu", "em_sweep.cu")
)
_EM_ELEMENTS = 11  # em_sweep.cu's FENRIS_EM_ELEMENT parts (ops/em_sweep.ELEMENTS)
# (source, object stem, extra nvcc flags): one object a source, em_sweep.cu one per element
_UNITS = tuple(
    unit
    for src in _SOURCES
    for unit in (
        [(src, f"{src.stem}_{k}", (f"-DFENRIS_EM_ELEMENT={k}",)) for k in range(_EM_ELEMENTS)]
        if src.name == "em_sweep.cu"
        else [(src, src.stem, ())]
    )
)
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
_COMPILE = (*_ARCH, "-c", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LINK = (*_ARCH, "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_LP = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    # u, out, nz, ny, nx, factors (host f32 [32]), mu, lam, stream
    "fenris_nh_residual": ((_P, _P, _I, _I, _I, _P, _F, _F, _P), _I),
    # u, v, out, nz, ny, nx, factors (host f32 [32]), mu, lam, stream
    "fenris_nh_hvp": ((_P, _P, _P, _I, _I, _I, _P, _F, _F, _P), _I),
    # bands, offsets, D, x, y, N, s, stream
    "fenris_dia_sweep": ((_P, _P, _I, _P, _P, _L, _I, _P), _I),
    # X, tables, cf (host), out, E, ld, m, n, q, d, s, sym, stream
    "fenris_stiffness_pairs": ((_P, _P, _P, _P, _L, _L, _I, _I, _I, _I, _I, _I, _P), _I),
    # u, nodes, block_rows, out, rows_total, rows_per_block, s, stream
    "fenris_banded_gather": ((_P, _P, _P, _P, _L, _I, _I, _P), _I),
    # f, row_ptr, node_rows, out, num_nodes, s, walk, stream
    "fenris_banded_scatter": ((_P, _P, _P, _P, _L, _I, _I, _P), _I),
    # X, u, v (NULL: vector sweep), out, strides[12], E, tables, q, d, m, n, material, then mu and lam each
    # as (pointer or NULL, element stride, value), stream
    "fenris_em_sweep": ((_P, _P, _P, _P, _LP, _L, _P, _I, _I, _I, _I, _I, _P, _I, _F, _P, _I, _F, _P), _I),
    # X, u, v (NULL: vector sweep), nodes, block_rows, out, E, elements_per_block, tables, q, d, m, n,
    # material, mu and lam as in fenris_em_sweep, stream
    "fenris_banded_sweep": ((_P, _P, _P, _P, _P, _P, _L, _I, _P, _I, _I, _I, _I, _I, _P, _I, _F, _P, _I, _F, _P),
                            _I),
    # banded, tangent, q, d, m, n, material, out (int32 [5]): the launch geometry, nothing launched
    "fenris_em_layout": ((_I, _I, _I, _I, _I, _I, _I, _P), _I),
    "fenris_cuda_error_string": ((_I,), ctypes.c_char_p),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _key() -> str:
    h = hashlib.sha256()
    for src, stem, flags in _UNITS:
        h.update(" ".join((src.name, stem, *flags)).encode())
        h.update(src.read_bytes())
    h.update(" ".join(_COMPILE + _LINK).encode())
    return h.hexdigest()[:16]


def build_log() -> Path:
    """The ``nvcc`` log (``-Xptxas -v``: registers, spills) of the library :func:`load_library` loads."""
    return BUILD_DIR / f"libfenris_kernels_{_key()}.log"


def _run_all(cmds, log_path: Path) -> None:
    """Run the commands concurrently; append their output to ``log_path``; raise if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    with open(log_path, "a") as log:
        for cmd, out in zip(cmds, outs):
            log.write(" ".join(cmd) + "\n" + out + "\n")
    failed = [(c, o) for c, o, p in zip(cmds, outs, procs) if p.returncode != 0]
    if failed:
        cmd, out = failed[0]
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out}")


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libfenris_kernels_{_key()}.so"
    if not lib_path.exists():
        # build in a private directory and rename the library and its log
        # into place: a concurrent build never loads a half-written one
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            nvcc = _nvcc()
            objs = [Path(tmp) / (stem + ".o") for _, stem, _ in _UNITS]
            log = Path(tmp) / "build.log"
            _run_all([[nvcc, *_COMPILE, *flags, "-o", str(o), str(src)] for (src, _, flags), o in zip(_UNITS, objs)],
                     log)
            so = Path(tmp) / "lib.so"
            _run_all([[nvcc, *_LINK, "-o", str(so), *map(str, objs)]], log)
            os.replace(log, build_log())
            os.replace(so, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.fenris_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
