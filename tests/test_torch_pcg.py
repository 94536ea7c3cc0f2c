"""The port's PCG (``align3d_torch/optim/pcg.py``) against
``align3d_tpu.optim.pcg.pcg`` on one random block-SPD system (12 blocks of
6) with a block-Jacobi preconditioner, the same numpy inputs fed to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_tpu.optim.pcg import pcg as jax_pcg

from align3d_torch.optim.pcg import pcg

BLOCKS = 12
REL = 1e-5  # x within 1e-5 x max|x| of JAX's


def _system(seed: int = 0):
    rng = np.random.default_rng(seed)
    n = BLOCKS * 6
    b_mat = rng.normal(0.0, 1.0, (n, n))
    a = (b_mat @ b_mat.T / n + 0.5 * np.eye(n)).astype(np.float32)
    minv = np.linalg.inv(a.reshape(BLOCKS, 6, BLOCKS, 6)[np.arange(BLOCKS), :, np.arange(BLOCKS), :])
    return a, minv.astype(np.float32), rng.normal(0.0, 1.0, (BLOCKS, 6)).astype(np.float32)


def _jax_solve(iters: int, tol: float = 1e-10) -> np.ndarray:
    a, minv, b = (jnp.asarray(v) for v in _system())
    x = jax_pcg(lambda v: (a @ v.reshape(-1)).reshape(BLOCKS, 6), lambda r: jnp.einsum("nuw,nw->nu", minv, r), b,
                iters, tol)
    return np.asarray(x)


def _torch_solve(iters: int, tol: float = 1e-10) -> torch.Tensor:
    a, minv, b = (torch.from_numpy(v) for v in _system())
    return pcg(lambda v: (a @ v.reshape(-1)).reshape(BLOCKS, 6), lambda r: torch.einsum("nuw,nw->nu", minv, r), b,
               iters, tol)


@pytest.mark.parametrize("iters", [4, 32, 128])
def test_pcg_matches_jax(iters):
    ref, got = _jax_solve(iters), _torch_solve(iters).numpy()
    # Measured: 2.1e-7 / 1.6e-7 / 1.6e-7 x max|x| at 4 / 32 / 128 trips.
    assert np.abs(got - ref).max() <= REL * np.abs(ref).max()


def test_pcg_freezes_at_tol_as_jax():
    # rz is 0.34 after 4 trips and 0.026 after 6; the 7th takes it below
    # 1e-2, and from then on every trip is masked, so 64 and 128 trips
    # return the same bits.
    tol = 1e-2
    frozen = _torch_solve(128, tol)
    assert torch.equal(frozen, _torch_solve(64, tol))
    assert not torch.equal(frozen, _torch_solve(128))  # the tolerance did stop it early
    ref = _jax_solve(128, tol)
    # Measured: 1.7e-7 x max|x|.
    assert np.abs(frozen.numpy() - ref).max() <= REL * np.abs(ref).max()
