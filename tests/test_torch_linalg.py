"""The port's plain batched SPD solve against the JAX package's
`solve_psd`.

`chol_solve_plain` is the plain PyTorch version of the CUDA kernel in
dm_control_tpu_torch/csrc/chol_solve.cu; tests/test_torch_kernels.py
holds the kernel's own tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dm_control_tpu.ops import linalg as jlinalg

from dm_control_tpu_torch.ops import linalg as tlinalg

# One intra-op thread: the batches here are tiny, and pytest-xdist workers
# share the host's cores, where a thread pool per worker only contends.
torch.set_num_threads(1)


def random_spd(rng, batch, n, diag_lo=1e-6, diag_hi=1.0):
  """Well-conditioned SPD correlation matrices rescaled so the diagonals
  span [diag_lo, diag_hi]: after Jacobi scaling every pivot is O(1)."""
  A = rng.normal(size=(batch, n, n))
  C = A @ np.swapaxes(A, -1, -2) / n + np.eye(n)
  dc = np.sqrt(np.diagonal(C, axis1=-2, axis2=-1))
  C = C / dc[..., :, None] / dc[..., None, :]
  scale = np.sqrt(np.exp(rng.uniform(np.log(diag_lo), np.log(diag_hi),
                                     (batch, n))))
  return C * scale[..., :, None] * scale[..., None, :]


@pytest.mark.parametrize('n', [1, 2, 8, 27, 29, 32, 62, 64])
def test_plain_solve_matches_solve_psd(n):
  """float64, 1e-10 relative: the same factorization on both sides."""
  rng = np.random.default_rng(n)
  H = random_spd(rng, 16, n)
  g = rng.normal(size=(16, n))
  with jax.enable_x64(True):
    want = np.asarray(jax.jit(jlinalg.solve_psd)(jnp.asarray(H),
                                                 jnp.asarray(g)))
  got = tlinalg.chol_solve_plain(torch.as_tensor(H), torch.as_tensor(g))
  assert got.dtype == torch.float64
  # relative to the solution's scale, per system
  rel = np.abs(got.numpy() - want).max(-1) / np.abs(want).max(-1)
  assert rel.max() < 1e-10, rel.max()
  # and the residual of the original (unscaled) system
  res = np.einsum('bij,bj->bi', H, got.numpy()) - g
  assert np.abs(res).max() < 1e-9 * np.abs(g).max()
