"""Carrying state between the JAX package and the port, as numpy arrays.

Nothing here imports JAX: the caller hands over the JAX model's fields as
numpy arrays (``np.asarray(jax_model.dirichlet_mask)``, …), and vectors
move as numpy arrays in the shared layouts — flat ``[num_nodes * 3]``
(``3 * node + comp``, nodes in (z, y, x) order) or grid ``[3, nz, ny, nx]``.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import DEFAULT_DTYPE
from .solid import LameParameters, NeoHookeanMaterial
from .structured import StructuredHyperelasticModel

__all__ = [
    "structured_model_from_arrays",
    "hyperelastic_model_from_arrays",
    "flat_to_grid",
    "grid_to_flat",
]


def structured_model_from_arrays(
    cells,
    spacing,
    mu,
    lam,
    dirichlet_mask=None,
    body_force=None,
    *,
    dtype: torch.dtype = DEFAULT_DTYPE,
    device="cpu",
) -> StructuredHyperelasticModel:
    """A Neo-Hookean port model with the given JAX model's fields.

    ``cells``/``spacing``/``mu``/``lam`` as stored on the JAX
    ``StructuredHyperelasticModel``; ``dirichlet_mask`` a boolean
    ``[num_nodes * 3]`` array; ``body_force`` a constant ``[3]`` array, or a
    pointwise torch callable supplied by the caller (a JAX callable is not
    carried over).
    """
    return StructuredHyperelasticModel(
        cells=tuple(int(c) for c in np.asarray(cells).reshape(-1)),
        spacing=float(spacing),
        material=NeoHookeanMaterial(),
        params=LameParameters(mu=float(mu), lam=float(lam)),
        dirichlet_mask=None if dirichlet_mask is None else np.asarray(dirichlet_mask, dtype=bool),
        body_force=body_force if body_force is None or callable(body_force) else np.asarray(body_force),
        dtype=dtype,
        device=device,
    )


def hyperelastic_model_from_arrays(
    points,
    cells,
    mu,
    lam,
    dirichlet_nodes=None,
    body_force=None,
    *,
    dtype: torch.dtype = DEFAULT_DTYPE,
    device="cpu",
    **kwargs,
):
    """A Neo-Hookean unstructured port model with the given JAX model's fields.

    ``points``/``cells`` as on the JAX model's hex8 mesh
    (``np.asarray(jax_model.mesh.points)``, ``.cells``), ``mu``/``lam`` its
    Lamé parameters, ``dirichlet_nodes`` its constrained nodes and
    ``body_force`` a constant ``[3]`` array (a JAX callable is not carried
    over).  Further keyword arguments (``chunk_size``, ``rule``) go to
    :class:`~.elasticity.HyperelasticModel`.
    """
    from .elasticity import HyperelasticModel
    from .mesh import Mesh
    from .reference_elements import HEX8

    return HyperelasticModel(
        mesh=Mesh(np.asarray(points), np.asarray(cells), HEX8),
        material=NeoHookeanMaterial(),
        params=LameParameters(mu=float(mu), lam=float(lam)),
        dirichlet_nodes=None if dirichlet_nodes is None else np.asarray(dirichlet_nodes),
        body_force=None if body_force is None else np.asarray(body_force, dtype=np.float64),
        dtype=dtype,
        device=device,
        **kwargs,
    )


def flat_to_grid(u, node_shape) -> np.ndarray:
    """Grid ``[3, nz, ny, nx]`` from a flat dof vector (numpy)."""
    return np.ascontiguousarray(np.moveaxis(np.asarray(u).reshape(tuple(node_shape) + (3,)), -1, 0))


def grid_to_flat(g) -> np.ndarray:
    """Flat dof vector from a ``[3, nz, ny, nx]`` grid (numpy)."""
    return np.ascontiguousarray(np.moveaxis(np.asarray(g), 0, -1)).reshape(-1)
