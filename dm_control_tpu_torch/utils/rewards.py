# Spec constants in this file reproduce task-specification values from
# dm_control (github.com/google-deepmind/dm_control), Copyright The
# dm_control Authors, Apache License 2.0.
"""Soft indicator ("tolerance") rewards on torch tensors.

Port of dm_control_tpu/utils/rewards.py: the same sigmoid family, bounds
semantics and value_at_margin calibration.
"""

from __future__ import annotations

import numpy as np
import torch

_DEFAULT_VALUE_AT_MARGIN = 0.1

# sigmoid name -> (calibrate(v1) -> scale, curve(scaled distance))
_SMOOTH_SIGMOIDS = {
    'gaussian': (lambda v1: np.sqrt(-2 * np.log(v1)),
                 lambda sx: torch.exp(-0.5 * sx * sx)),
    'hyperbolic': (lambda v1: np.arccosh(1 / v1),
                   lambda sx: 1 / torch.cosh(sx)),
    'long_tail': (lambda v1: np.sqrt(1 / v1 - 1),
                  lambda sx: 1 / (sx * sx + 1)),
    'reciprocal': (lambda v1: 1 / v1 - 1,
                   lambda sx: 1 / (torch.abs(sx) + 1)),
    'tanh_squared': (lambda v1: np.arctanh(np.sqrt(1 - v1)),
                     lambda sx: 1 - torch.tanh(sx) ** 2),
}

# these clip to exactly zero beyond one margin
_WINDOWED_SIGMOIDS = {
    'cosine': (lambda v1: np.arccos(2 * v1 - 1) / np.pi,
               lambda sx: (1 + torch.cos(np.pi * sx)) / 2),
    'linear': (lambda v1: 1 - v1, lambda sx: 1 - sx),
    'quadratic': (lambda v1: np.sqrt(1 - v1), lambda sx: 1 - sx * sx),
}


def _shaping_fn(sigmoid, value_at_margin):
  if sigmoid in _WINDOWED_SIGMOIDS:
    if not 0 <= value_at_margin < 1:
      raise ValueError(
          f'value_at_margin for {sigmoid!r} must lie in [0, 1); '
          f'got {value_at_margin}.')
    calibrate, curve = _WINDOWED_SIGMOIDS[sigmoid]
    scale = calibrate(value_at_margin)
    return lambda x: torch.where(torch.abs(x * scale) < 1, curve(x * scale),
                                 torch.zeros_like(x))
  if sigmoid in _SMOOTH_SIGMOIDS:
    if not 0 < value_at_margin < 1:
      raise ValueError(
          f'value_at_margin for {sigmoid!r} must lie in (0, 1); '
          f'got {value_at_margin}.')
    calibrate, curve = _SMOOTH_SIGMOIDS[sigmoid]
    scale = calibrate(value_at_margin)
    return lambda x: curve(x * scale)
  raise ValueError(
      f'Unknown sigmoid {sigmoid!r}; choose from '
      f'{sorted(_SMOOTH_SIGMOIDS) + sorted(_WINDOWED_SIGMOIDS)}.')


def tolerance(x: torch.Tensor, bounds=(0.0, 0.0), margin: float = 0.0,
              sigmoid: str = 'gaussian',
              value_at_margin: float = _DEFAULT_VALUE_AT_MARGIN):
  """1 inside `bounds`, decaying over `margin` outside them."""
  lower, upper = bounds
  if lower > upper:
    raise ValueError(
        f'bounds must satisfy lower <= upper; got ({lower}, {upper}).')
  if margin < 0:
    raise ValueError(f'margin must be non-negative; got {margin}.')
  hit = (lower <= x) & (x <= upper)
  one, zero = torch.ones_like(x), torch.zeros_like(x)
  if margin == 0:
    return torch.where(hit, one, zero)
  overshoot = torch.where(x < lower, lower - x, x - upper)
  shaped = _shaping_fn(sigmoid, value_at_margin)(overshoot / margin)
  return torch.where(hit, one, shaped)
