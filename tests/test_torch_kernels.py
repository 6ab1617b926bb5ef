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


def _cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU with nvcc')


def _check(H, g, dtype):
  """Kernel vs plain on the card, relative to each system's solution."""
  tol = 2e-4 if dtype == torch.float32 else 1e-10
  want = linalg.chol_solve_plain(H, g)
  got = cuda_kernels.chol_solve_cuda(H, g)
  torch.cuda.synchronize()
  assert torch.isfinite(got).all()
  rel = ((got - want).abs().amax(-1) / want.abs().amax(-1)).max().item()
  assert rel < tol, rel


# every variant and its edges: the register tile N = 28 (1 to 28) and
# shared memory (29 to 64); and every n the suite's models give it (1 to
# 4: pendulum, cartpole and acrobot, two and three poles; 7: hopper;
# 9: cheetah and walker; 22: quadruped walk and run; 27: humanoid; 28:
# quadruped fetch)
@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 2, 3, 4, 5, 7, 8, 9, 16, 17, 22, 27, 28,
                               29, 31, 32, 33, 64])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_kernel_matches_plain(dtype, n):
  """The CUDA kernel against the plain version on the card."""
  _cuda()
  rng = np.random.default_rng(n)
  H = torch.as_tensor(random_spd(rng, 512, n), dtype=dtype, device='cuda')
  g = torch.as_tensor(rng.normal(size=(512, n)), dtype=dtype, device='cuda')
  _check(H, g, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [27, 64])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_kernel_floors_singular_pivots(dtype, n):
  """Zero rows and columns (a massless dof) and zero matrices: every pivot
  the floor meets is exactly 0, in any summation order."""
  _cuda()
  rng = np.random.default_rng(2)
  H = random_spd(rng, 96, n)
  H[0::3, 5, :] = H[0::3, :, 5] = 0
  H[1::3, 0, :] = H[1::3, :, 0] = H[1::3, -1, :] = H[1::3, :, -1] = 0
  H[2::3] = 0
  H = torch.as_tensor(H, dtype=dtype, device='cuda')
  g = torch.as_tensor(rng.normal(size=(96, n)), dtype=dtype, device='cuda')
  _check(H, g, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [27, 64])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_kernel_reads_only_the_lower_triangle(dtype, n):
  """NaN above every diagonal: like the plain version, the kernel reads
  only the lower triangle, so the two still agree."""
  _cuda()
  rng = np.random.default_rng(4)
  H = random_spd(rng, 96, n)
  H[:, np.triu_indices(n, 1)[0], np.triu_indices(n, 1)[1]] = np.nan
  H = torch.as_tensor(H, dtype=dtype, device='cuda')
  g = torch.as_tensor(rng.normal(size=(96, n)), dtype=dtype, device='cuda')
  _check(H, g, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize('offset', [0, 1, 2, 3])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_kernel_takes_ragged_misaligned_batches(dtype, offset):
  """Batches that leave a block's last group short, from addresses that
  are element-aligned but not 16-byte aligned."""
  _cuda()
  rng = np.random.default_rng(3)
  for batch, n in ((1, 27), (13, 27), (1003, 27), (7, 5)):
    flat = torch.empty(offset + batch * n * n, dtype=dtype, device='cuda')
    H = flat[offset:].view(batch, n, n)
    H.copy_(torch.as_tensor(random_spd(rng, batch, n)))
    g = torch.as_tensor(rng.normal(size=(batch, n)), dtype=dtype,
                        device='cuda')
    _check(H, g, dtype)


@pytest.mark.cuda
def test_kernel_variant_by_n():
  _cuda()
  got = [cuda_kernels.chol_solve_variant(n) for n in (1, 27, 28, 29, 64)]
  assert got == ['registers N=28'] * 3 + ['shared memory'] * 2
