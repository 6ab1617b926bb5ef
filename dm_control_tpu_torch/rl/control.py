"""Task interface and a minimal environment holder.

Port of the parts of dm_control_tpu/rl/control.py that the batched path
needs: `Task` (:36-85), `compute_n_steps` (:87) and an `Environment` that
holds a model, a task and the substep count. Every Task hook works on a
whole batch: Data tensors are (B, ...) and hooks return (B, ...) tensors.
The dm_env reset/step API is not ported yet.
"""

from __future__ import annotations

import abc
from typing import Dict, Optional

import torch

from dm_control_tpu_torch.models import types


class Task(abc.ABC):
  """A batched task."""

  @abc.abstractmethod
  def initialize_episode(self, model: types.Model, data: types.Data,
                         generator: torch.Generator) -> types.Data:
    """Episode-initial Data for the batch."""

  @abc.abstractmethod
  def get_observation(self, model: types.Model,
                      data: types.Data) -> Dict[str, torch.Tensor]:
    """An ordered dict of (B, ...) observations."""

  @abc.abstractmethod
  def get_reward(self, model: types.Model,
                 data: types.Data) -> torch.Tensor:
    """(B,) rewards."""

  def get_termination(self, model: types.Model,
                      data: types.Data) -> Optional[torch.Tensor]:
    """Optional (B,) bool: the episode terminates with discount 0."""
    return None

  def before_step(self, model: types.Model, data: types.Data,
                  action: torch.Tensor) -> types.Data:
    """Maps actions into Data (default: writes ctrl)."""
    return data.replace(ctrl=torch.as_tensor(
        action, dtype=data.qpos.dtype, device=data.qpos.device))

  def after_step(self, model: types.Model, data: types.Data) -> types.Data:
    return data


def compute_n_steps(control_timestep: float, physics_timestep: float,
                    tolerance: float = 1e-5) -> int:
  """Physics substeps per control step."""
  if control_timestep < physics_timestep * (1 - tolerance):
    raise ValueError(
        f'Control timestep ({control_timestep}) cannot be smaller than '
        f'physics timestep ({physics_timestep}).')
  ratio = control_timestep / physics_timestep
  if abs(ratio - round(ratio)) > tolerance * round(ratio):
    raise ValueError('Control timestep must be an integer multiple of '
                     'physics timestep.')
  return int(round(ratio))


class Environment:
  """A (model, task) pair with its substep count and time limit."""

  def __init__(self, model: types.Model, task: Task,
               time_limit: float = float('inf'),
               control_timestep: Optional[float] = None,
               n_sub_steps: Optional[int] = None):
    if n_sub_steps is not None and control_timestep is not None:
      raise ValueError('Both n_sub_steps and control_timestep were '
                       'supplied.')
    self._model = model
    self._task = task
    self._time_limit = time_limit
    ts = float(model.opt.timestep)
    if control_timestep is not None:
      self._n_sub_steps = compute_n_steps(control_timestep, ts)
    else:
      self._n_sub_steps = n_sub_steps or 1

  @property
  def model(self) -> types.Model:
    return self._model

  @property
  def task(self) -> Task:
    return self._task

  @property
  def n_sub_steps(self) -> int:
    return self._n_sub_steps

  @property
  def time_limit(self) -> float:
    return self._time_limit
