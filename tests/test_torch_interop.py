"""Port interop: JAX model state carried across as numpy, and the no-JAX rule."""

import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import rel_err, state

import __graft_entry__
from fenris_tpu_torch.interop import flat_to_grid, grid_to_flat, structured_model_from_arrays

PKG = Path(__file__).resolve().parent.parent / "fenris_tpu_torch"


def _carry(jm, **kwargs):
    return structured_model_from_arrays(
        jm.cells,
        jm.spacing,
        np.asarray(jm.params.mu),
        np.asarray(jm.params.lam),
        np.asarray(jm.dirichlet_mask),
        np.asarray(jm.body_force),
        device="cpu",
        **kwargs,
    )


def test_flagship_model_carried_across_matches_jax():
    """The flagship fields (__graft_entry__._structured_model), cut to a small grid."""
    jm = __graft_entry__._structured_model((4, 3, 5), dtype=jnp.float64)
    tm = _carry(jm, dtype=torch.float64)
    assert tm.node_shape == jm.node_shape and tm.num_dofs == jm.num_dofs
    u, v = state(jm.num_dofs, seed=11, scale=0.02 * jm.spacing)
    # f64, another summation order: roundoff only
    assert rel_err(np.asarray(jm.residual(jnp.asarray(u))), tm.residual(torch.as_tensor(u))) < 1e-12
    ref = jm.hessian_vector_product(jnp.asarray(u), jnp.asarray(v))
    assert rel_err(np.asarray(ref), tm.hessian_vector_product(torch.as_tensor(u), torch.as_tensor(v))) < 1e-12


def test_grid_helpers_match_jax_layout():
    jm = __graft_entry__._structured_model((3, 2, 4), dtype=jnp.float64)
    u, _ = state(jm.num_dofs, seed=12)
    g = flat_to_grid(u, jm.node_shape)
    assert np.array_equal(g, np.asarray(jm._grid(jnp.asarray(u))))
    assert np.array_equal(grid_to_flat(g), u)


def test_port_imports_no_jax():
    """Importing every port module pulls in neither jax nor fenris_tpu."""
    modules = sorted(
        "fenris_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'fenris_tpu.')) or m == 'fenris_tpu')\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=PKG.parent, timeout=120)
    # nor a lazy import inside a function
    banned = re.compile(r"^\s*(import|from)\s+(jax|fenris_tpu)(\.|\s|$)", re.MULTILINE)
    for path in PKG.rglob("*.py"):
        assert not banned.search(path.read_text()), path
