"""The CUDA SPD-solve kernel, its wrapper and its plain version.

Imports neither jax nor the JAX package, so on a GPU host without jax it
runs on its own, skipping the repository's conftest:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

The `cuda`-marked cases skip where torch sees no GPU.
"""

import numpy as np
import pytest
import torch

from dm_control_tpu_torch.ops import cuda_kernels
from dm_control_tpu_torch.ops import linalg

# One intra-op thread: the batches here are tiny, and pytest-xdist workers
# share the host's cores, where a thread pool per worker only contends.
torch.set_num_threads(1)


def random_spd(rng, batch, n, diag_lo=1e-6, diag_hi=1.0):
  """SPD matrices whose diagonals span [diag_lo, diag_hi]."""
  A = rng.normal(size=(batch, n, n))
  C = A @ np.swapaxes(A, -1, -2) / n + np.eye(n)
  dc = np.sqrt(np.diagonal(C, axis1=-2, axis2=-1))
  C = C / dc[..., :, None] / dc[..., None, :]
  scale = np.sqrt(np.exp(rng.uniform(np.log(diag_lo), np.log(diag_hi),
                                     (batch, n))))
  return C * scale[..., :, None] * scale[..., None, :]


def test_plain_solve_floors_singular_pivots():
  """A singular system yields finite values: the pivot floor bounds the
  factor instead of dividing by rounding noise."""
  H = torch.ones((2, 4, 4), dtype=torch.float32)
  g = torch.ones((2, 4), dtype=torch.float32)
  x = linalg.chol_solve_plain(H, g)
  assert torch.isfinite(x).all()


def test_cpu_dispatch_runs_plain_version():
  rng = np.random.default_rng(0)
  H = torch.as_tensor(random_spd(rng, 4, 27))
  g = torch.as_tensor(rng.normal(size=(4, 27)))
  before = cuda_kernels.chol_solve_cuda.launches
  x = cuda_kernels.chol_solve_batched(H, g)
  assert cuda_kernels.chol_solve_cuda.launches == before
  torch.testing.assert_close(x, linalg.chol_solve_plain(H, g), rtol=0,
                             atol=0)


def test_kernel_wrapper_rejects_cpu_tensors():
  H = torch.eye(3).expand(2, 3, 3).contiguous()
  with pytest.raises(ValueError):
    cuda_kernels.chol_solve_cuda(H, torch.ones(2, 3))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_kernel_matches_plain(dtype):
  """The CUDA kernel against the plain version on the card."""
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU with nvcc')
  rng = np.random.default_rng(1)
  tol = 2e-4 if dtype == torch.float32 else 1e-10
  for n in (1, 8, 27, 32, 64):
    H = torch.as_tensor(random_spd(rng, 512, n), dtype=dtype, device='cuda')
    g = torch.as_tensor(rng.normal(size=(512, n)), dtype=dtype,
                        device='cuda')
    want = linalg.chol_solve_plain(H, g)
    got = cuda_kernels.chol_solve_cuda(H, g)
    torch.cuda.synchronize()
    rel = ((got - want).abs().amax(-1) / want.abs().amax(-1)).max().item()
    assert rel < tol, (n, rel)
