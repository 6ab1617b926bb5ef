"""Plain PyTorch batched SPD solve: the reference for the CUDA kernel.

Port of the math of dm_control_tpu/ops/linalg.py (`solve_psd`): Jacobi
scaling to a unit diagonal, a Cholesky factor whose pivots are floored,
forward and back substitution, unscaling. The explicit inverse factor K^T
of the JAX version is a workaround for XLA layouts on the TPU and is not
carried over; the result is the same function.

The factor's diagonal is L_jj = sqrt(max(c_jj, floor)), where c_jj is the
pivot after the previous columns' updates; the column below it is
c_ij / L_jj. This is what `linalg.solve_psd` computes, and what the CUDA
kernel in csrc/chol_solve.cu computes.
"""

from __future__ import annotations

import torch


def pivot_floor(dtype: torch.dtype) -> float:
  """Floor for the pivots of the unit-diagonal scaled matrix."""
  return 1e-6 if dtype == torch.float32 else 1e-12


def jacobi_scale(H: torch.Tensor) -> torch.Tensor:
  """s with diag(s H s) = 1; diagonal entries <= 1e-30 get s = 1."""
  d = torch.diagonal(H, dim1=-2, dim2=-1)
  tiny = 1e-30
  return torch.where(d > tiny, torch.rsqrt(torch.clamp(d, min=tiny)),
                     torch.ones_like(d))


def chol_solve_plain(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  """Solve H x = g for a batch of SPD systems. H (B, n, n), g (B, n)."""
  n = H.shape[-1]
  if n == 0:
    return g.clone()
  s = jacobi_scale(H)
  Hs = H * s[..., :, None] * s[..., None, :]
  gs = g * s
  eps = pivot_floor(H.dtype)
  L = torch.zeros_like(Hs)
  diag = []
  for j in range(n):
    c = Hs[..., j:, j]
    if j:
      c = c - torch.einsum('...ik,...k->...i', L[..., j:, :j], L[..., j, :j])
    djj = torch.sqrt(torch.clamp(c[..., 0], min=eps))
    L[..., j:, j] = c / djj[..., None]
    L[..., j, j] = djj
    diag.append(djj)
  # forward substitution L y = gs
  y = torch.zeros_like(gs)
  for i in range(n):
    acc = gs[..., i]
    if i:
      acc = acc - torch.sum(L[..., i, :i] * y[..., :i], dim=-1)
    y[..., i] = acc / diag[i]
  # back substitution L^T x = y
  x = torch.zeros_like(gs)
  for i in range(n - 1, -1, -1):
    acc = y[..., i]
    if i + 1 < n:
      acc = acc - torch.sum(L[..., i + 1:, i] * x[..., i + 1:], dim=-1)
    x[..., i] = acc / diag[i]
  return x * s
