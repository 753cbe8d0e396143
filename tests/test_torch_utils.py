"""Port parity: ``fenris_tpu_torch.utils`` against ``fenris_tpu.utils`` in f64, and ``profiling`` on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fenris_tpu.utils as ju
import fenris_tpu_torch.utils as tu
from fenris_tpu.sparse import CsrMatrix as JaxCsr
from fenris_tpu_torch import profiling
from fenris_tpu_torch.sparse.csr import CsrMatrix as TorchCsr


def _rng(seed=7):
    return np.random.default_rng(seed)


def _rotations(rng, n):
    q = rng.standard_normal((n, 4))
    w, x, y, z = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    return np.stack(
        [
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


def _matrices():
    """A seeded batch of general 3x3 matrices, half of them with det < 0 (the reflection branch)."""
    M = _rng().standard_normal((64, 3, 3))
    M[::2] = M[::2] @ np.diag([1.0, 1.0, -1.0])
    return M


def _deformations(n=64, seed=8):
    """F = R S with S symmetric positive definite near the identity."""
    rng = _rng(seed)
    A = rng.standard_normal((n, 3, 3))
    return _rotations(rng, n) @ (np.eye(3) + 0.2 * (A + np.swapaxes(A, 1, 2)) / 2)


def _np(t):
    return t.numpy()


def test_rotation_svd_matches_jax():
    """Singular values equal (the last one signed); U and V equal up to one sign per column pair, as an SVD's
    vectors are determined; both proper rotations reconstructing M."""
    M = _matrices()
    jU, js, jV = (np.asarray(x) for x in ju.rotation_svd(jnp.asarray(M)))
    tU, ts, tV = (_np(x) for x in tu.rotation_svd(torch.as_tensor(M)))
    assert np.abs(ts - js).max() < 1e-12
    assert (ts[:, -1] < 0).sum() == (np.linalg.det(M) < 0).sum()
    sign = np.sign(np.einsum("bij,bij->bj", tU, jU))  # [B, 3] per-column sign
    assert np.abs(tU - jU * sign[:, None, :]).max() < 1e-12
    assert np.abs(tV - jV * sign[:, None, :]).max() < 1e-12
    assert np.abs(np.linalg.det(tU) - 1.0).max() < 1e-12 and np.abs(np.linalg.det(tV) - 1.0).max() < 1e-12
    assert np.abs(tU @ (ts[..., :, None] * np.swapaxes(tV, -1, -2)) - M).max() < 1e-12


def test_polar_decomposition_matches_jax():
    for F in (_deformations(), _matrices()):
        jR, jS = (np.asarray(x) for x in ju.polar_decomposition(jnp.asarray(F)))
        tR, tS = (_np(x) for x in tu.polar_decomposition(torch.as_tensor(F)))
        assert np.abs(tR - jR).max() < 1e-12
        assert np.abs(tS - jS).max() < 1e-12


def test_apd_matches_jax():
    F = _deformations()
    jR = np.asarray(jax.jit(ju.apd)(jnp.asarray(F)))
    tR = _np(tu.apd(torch.as_tensor(F)))
    assert np.abs(tR - jR).max() < 1e-10
    # and it is the polar rotation
    assert np.abs(tR - _np(tu.polar_decomposition(torch.as_tensor(F))[0])).max() < 1e-5


@pytest.mark.parametrize("n", [3, 6])
def test_eigenvalue_helpers_match_jax(n):
    A = _rng(n).standard_normal((16, n, n))
    A = A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(n)
    scale = np.abs(np.linalg.eigvalsh(A)).max()
    assert np.abs(_np(tu.sym_eigenvalues(torch.as_tensor(A))) - np.asarray(ju.sym_eigenvalues(jnp.asarray(A)))).max() \
        < 1e-12 * scale
    for t, j in zip(tu.extremal_eigenvalues(torch.as_tensor(A)), ju.extremal_eigenvalues(jnp.asarray(A))):
        assert np.abs(_np(t) - np.asarray(j)).max() < 1e-12 * scale
    tk, jk = _np(tu.condition_number_sym(torch.as_tensor(A))), np.asarray(ju.condition_number_sym(jnp.asarray(A)))
    assert np.abs(tk / jk - 1.0).max() < 1e-12


def test_save_matrix_market_matches_jax(tmp_path):
    """The same file, byte for byte: a dense numpy matrix, a dense tensor, and a CSR matrix of each package."""
    rng = _rng(3)
    m = rng.standard_normal((4, 5)) * (rng.uniform(size=(4, 5)) < 0.5)
    ju.save_matrix_market(tmp_path / "jax.mtx", m)
    reference = (tmp_path / "jax.mtx").read_bytes()
    for i, dense in enumerate((m, torch.as_tensor(m))):
        tu.save_matrix_market(tmp_path / f"torch{i}.mtx", dense)
        assert (tmp_path / f"torch{i}.mtx").read_bytes() == reference
    rows, cols = np.nonzero(m)
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=4))])
    ju.save_matrix_market(tmp_path / "jax_csr.mtx", JaxCsr(jnp.asarray(row_ptr), jnp.asarray(cols.astype(np.int32)),
                                                          jnp.asarray(m[rows, cols]), (4, 5)))
    tu.save_matrix_market(tmp_path / "sub" / "torch_csr.mtx", TorchCsr(torch.as_tensor(row_ptr), torch.as_tensor(cols),
                                                                       torch.as_tensor(m[rows, cols]), (4, 5)))
    assert (tmp_path / "sub" / "torch_csr.mtx").read_bytes() == (tmp_path / "jax_csr.mtx").read_bytes()
    assert (tmp_path / "jax_csr.mtx").read_bytes() == reference


def test_helpers_put_other_inputs_on_the_card():
    """A numpy input goes to the card, so it raises on a machine without one (nothing falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the call would succeed")
    for fn in (tu.rotation_svd, tu.polar_decomposition, tu.apd, tu.sym_eigenvalues, tu.extremal_eigenvalues,
               tu.condition_number_sym):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(np.eye(3))


def test_timer_sections():
    timer = profiling.Timer()
    x = torch.ones(1000, dtype=torch.float64)
    for _ in range(3):
        with timer.section("sum", sync=x):
            x.sum()
    with timer.section("nothing"):
        pass
    summary = timer.summary()
    assert set(summary) == {"sum", "nothing"} and len(timer.times["sum"]) == 3
    assert all(v >= 0.0 for v in summary.values())


def test_benchmark_counts_calls():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    seconds = profiling.benchmark(fn, torch.ones(10), warmup=2, iters=5)
    assert len(calls) == 7 and seconds >= 0.0


def test_trace_writes_a_trace_file(tmp_path):
    with profiling.trace(tmp_path / "trace") as prof:
        torch.ones(100).sum()
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert len(prof.key_averages()) > 0
