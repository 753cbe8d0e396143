"""Checkpoint / resume: persist meshes and solver state.

Counterpart of ``fenris_tpu/io/checkpoint.py``: a mesh and named arrays
(solution vectors, Newton state, material parameters) in one compressed
``.npz`` file, in the JAX package's layout (``mesh/points``,
``mesh/cells``, ``mesh/element``, ``state/<name>``), so a file written by
either package loads in the other.  Arrays may be numpy arrays or tensors
(saved through ``.detach().cpu().numpy()``); loading gives numpy arrays.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..mesh import Mesh
from ..reference_elements import ELEMENTS
from .vtk import to_numpy

__all__ = ["save_checkpoint", "load_checkpoint", "save_mesh", "load_mesh"]

_PREFIX = "state/"


def save_checkpoint(path, mesh: Optional[Mesh] = None, **arrays) -> None:
    """Save a mesh and named state arrays to one compressed npz file."""
    payload: Dict[str, np.ndarray] = {}
    if mesh is not None:
        payload["mesh/points"] = np.asarray(mesh.points)
        payload["mesh/cells"] = np.asarray(mesh.cells)
        payload["mesh/element"] = np.array(mesh.element.name)
    for name, arr in arrays.items():
        payload[_PREFIX + name] = to_numpy(arr)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **payload)


def load_checkpoint(path):
    """Load ``(mesh_or_None, {name: array})`` from a checkpoint file."""
    with np.load(path, allow_pickle=False) as npz:
        mesh = None
        if "mesh/points" in npz:
            mesh = Mesh(
                npz["mesh/points"],
                npz["mesh/cells"],
                ELEMENTS[str(npz["mesh/element"])],
            )
        state = {
            k[len(_PREFIX) :]: npz[k].copy() for k in npz.files if k.startswith(_PREFIX)
        }
    return mesh, state


def save_mesh(path, mesh: Mesh) -> None:
    save_checkpoint(path, mesh=mesh)


def load_mesh(path) -> Mesh:
    mesh, _ = load_checkpoint(path)
    if mesh is None:
        raise ValueError(f"{path} contains no mesh")
    return mesh
