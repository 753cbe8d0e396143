"""Shared helpers for the PyTorch-port parity tests (not collected by pytest).

Every parity test builds its inputs with numpy from a seed, runs the JAX
reference (``fenris_tpu``) and the port (``fenris_tpu_torch``) on the same
arrays, and compares the results as numpy arrays with a stated tolerance.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from fenris_tpu.solid import LameParameters as JaxLame
from fenris_tpu.solid import LinearElasticMaterial as JaxLinear
from fenris_tpu.solid import NeoHookeanMaterial as JaxNeoHookean
from fenris_tpu.solid import StVKMaterial as JaxStVK
from fenris_tpu.structured import StructuredHyperelasticModel as JaxModel
from fenris_tpu_torch.solid import LameParameters as TorchLame
from fenris_tpu_torch.solid import LinearElasticMaterial as TorchLinear
from fenris_tpu_torch.solid import NeoHookeanMaterial as TorchNeoHookean
from fenris_tpu_torch.solid import StVKMaterial as TorchStVK
from fenris_tpu_torch.structured import StructuredHyperelasticModel as TorchModel

# xdist runs several test files at once: one intra-op thread per worker
torch.set_num_threads(1)

#: the flagship model's Lamé parameters (__graft_entry__._structured_model)
MU, LAM = 384.614, 576.923

#: material name -> (JAX class, port class)
MATERIALS = {
    "linear": (JaxLinear, TorchLinear),
    "neo_hookean": (JaxNeoHookean, TorchNeoHookean),
    "stvk": (JaxStVK, TorchStVK),
}

JAX_DTYPES = {torch.float32: jnp.float32, torch.float64: jnp.float64}


def rng(seed: int = 1234) -> np.random.Generator:
    return np.random.default_rng(seed)


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rel_err(ref, got) -> float:
    """max |ref - got| / max |ref| (absolute error when ref is all zero)."""
    ref, got = to_numpy(ref).astype(np.float64), to_numpy(got).astype(np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    scale = np.abs(ref).max()
    return float(np.abs(ref - got).max() / (scale if scale > 0 else 1.0))


def clamp_mask(cells) -> np.ndarray:
    """Dirichlet mask fixing the z = 0 node plane, flat ``[num_nodes * 3]``."""
    ncx, ncy, ncz = cells
    mask = np.zeros((ncz + 1) * (ncy + 1) * (ncx + 1) * 3, dtype=bool)
    mask[: (ncy + 1) * (ncx + 1) * 3] = True
    return mask


def model_pair(cells, dtype=torch.float64, material="neo_hookean", spacing=0.25,
               mask=True, body_force=(0.0, 0.0, -5.0), torch_body_force=None,
               jax_kwargs=None, torch_kwargs=None, **kwargs):
    """The same structured model in JAX and in the port.

    ``body_force`` is a constant array or a JAX callable; a callable needs
    its torch twin in ``torch_body_force``.  Extra keyword arguments go to
    both constructors, ``jax_kwargs``/``torch_kwargs`` to one of them.
    """
    jax_cls, torch_cls = MATERIALS[material]
    common = dict(
        cells=tuple(cells),
        spacing=spacing,
        dirichlet_mask=clamp_mask(cells) if mask else None,
        **kwargs,
    )
    const = body_force is None or not callable(body_force)
    jm = JaxModel(
        material=jax_cls(), params=JaxLame(MU, LAM), dtype=JAX_DTYPES[dtype],
        body_force=None if body_force is None else (np.asarray(body_force) if const else body_force),
        **common,
        **(jax_kwargs or {}),
    )
    tm = TorchModel(
        material=torch_cls(), params=TorchLame(MU, LAM), dtype=dtype,
        body_force=np.asarray(body_force) if const and body_force is not None else torch_body_force,
        **common,
        **(torch_kwargs or {}),
    )
    return jm, tm


def state(num_dofs: int, seed: int = 0, scale: float = 0.02):
    """Displacement u ~ U(-scale, scale) and a direction v ~ N(0, 1), float64."""
    g = rng(seed)
    return g.uniform(-scale, scale, num_dofs), g.standard_normal(num_dofs)


def both(jax_fn, torch_fn, *arrays, dtype=torch.float64):
    """Run ``jax_fn`` and ``torch_fn`` on the same numpy ``arrays``."""
    jd = JAX_DTYPES[dtype]
    ref = jax_fn(*(jnp.asarray(a, jd) for a in arrays))
    got = torch_fn(*(torch.as_tensor(np.asarray(a), dtype=dtype) for a in arrays))
    return to_numpy(ref), to_numpy(got)
