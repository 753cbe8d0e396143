"""Build and load the port's CUDA kernels (nvcc + ctypes).

The kernels live in ``fenris_tpu_torch/csrc/*.cu`` and have a plain C
interface, so they build with ``nvcc`` alone in seconds (no PyTorch
headers).  The first call of :func:`load_library` compiles the sources
into ``fenris_tpu_torch/_build/`` under a name keyed by a hash of the
sources and flags, and later calls reuse the library.  Nothing is built
or loaded at import time.
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

__all__ = ["load_library", "check", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"
_SOURCES = (_PKG / "csrc" / "structured_stencil.cu",)
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # u, scratch, out, nz, ny, nx, gp, wdet, mu, lam, stream
    "fenris_nh_residual": (_P, _P, _P, _I, _I, _I, _P, _P, _F, _F, _P),
    # u, v, scratch, out, nz, ny, nx, gp, wdet, mu, lam, stream
    "fenris_nh_hvp": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _F, _F, _P),
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
    for src in _SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    out_dir = BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libfenris_stencil_{_key()}.so"
    if not lib_path.exists():
        # build into a temporary name and rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            cmd = [_nvcc(), *_FLAGS, "-o", tmp, *map(str, _SOURCES)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            (out_dir / "build.log").write_text(
                " ".join(cmd) + "\n" + proc.stdout + proc.stderr
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.fenris_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fenris_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.fenris_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
