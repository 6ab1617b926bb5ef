"""Auto-resetting batches of environments on one device.

Port of dm_control_tpu/parallel/batch_env.py without the mesh: one Model,
a batch of slim states (forward.SLIM_STATE_FIELDS) and a Python loop over
control steps. Each control step runs `n_sub_steps` batched physics steps,
then one position/velocity refresh for observations and rewards (the
reference's legacy-step freshness contract).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dm_control_tpu_torch.models import types
from dm_control_tpu_torch.ops import forward as forward_ops
from dm_control_tpu_torch.rl import control


def _where(mask: torch.Tensor, new: dict, old: dict) -> dict:
  """Per-env select of two dicts of (B, ...) tensors."""
  return {k: torch.where(mask.reshape((-1,) + (1,) * (old[k].dim() - 1)),
                         new[k], old[k]) for k in old}


class BatchedEnvironment:
  """A batch of identical environments stepped together.

  When an episode ends (task termination, time limit or physics
  divergence) `step` re-initializes that env in the same call; its
  returned observation is the first one of the new episode and `done`
  is set.
  """

  def __init__(self, model: types.Model, task: control.Task,
               batch_size: int, time_limit: float = float('inf'),
               n_sub_steps: int = 1, seed: int = 0):
    self.model = model
    self.task = task
    self.batch_size = batch_size
    self._n_sub_steps = n_sub_steps
    ts = float(model.opt.timestep)
    if time_limit == float('inf'):
      self._step_limit = np.iinfo(np.int32).max
    else:
      self._step_limit = int(round(time_limit / (ts * n_sub_steps)))
    self._gen = torch.Generator(device=model.device)
    self._gen.manual_seed(seed)
    self._template = types.make_data(model, batch_size)
    self._state = None
    self._steps = None

  # ------------------------------------------------------------------
  def _inflate(self, state: dict) -> types.Data:
    template = (self._template
                if state['qpos'].shape[0] == self.batch_size else None)
    return forward_ops.inflate(self.model, state, template)

  def _init(self, n: int) -> types.Data:
    """Fresh, fully forward-computed Data for n new episodes."""
    data = types.make_data(self.model, n)
    data = self.task.initialize_episode(self.model, data, self._gen)
    return forward_ops.forward(self.model, data)

  def step_core(self, state: dict, actions: torch.Tensor):
    """One control step of the whole batch, without resets.

    Returns (state, obs, reward, termination, diverged).
    """
    m, task = self.model, self.task
    d = task.before_step(m, self._inflate(state), actions)
    state = forward_ops.slim_state(d)
    for _ in range(self._n_sub_steps):
      d = forward_ops.step_batched(m, self._inflate(state),
                                   compute_sensors=False)
      state = forward_ops.slim_state(d)
    d = forward_ops.fwd_pv(m, self._inflate(state))
    d = task.after_step(m, d)
    obs = task.get_observation(m, d)
    reward = task.get_reward(m, d)
    term = task.get_termination(m, d)
    if term is None:
      term = torch.zeros_like(d.divergence)
    return forward_ops.slim_state(d), obs, reward, term, d.divergence

  @property
  def state(self) -> dict:
    return self._state

  def set_state(self, state: dict):
    """Replace the batch's slim state (and restart its step counts)."""
    self._state = dict(state)
    self._steps = torch.zeros(self.batch_size, dtype=torch.int64,
                              device=self.model.device)

  @property
  def data(self) -> types.Data:
    """Position/velocity-fresh Data of the current state."""
    if self._state is None:
      return None
    return forward_ops.fwd_pv(self.model, self._inflate(self._state))

  def reset(self):
    data = self._init(self.batch_size)
    obs = self.task.get_observation(self.model, data)
    self.set_state(forward_ops.slim_state(data))
    return obs

  def step(self, actions: torch.Tensor):
    """Returns (obs, reward, done) for the batch."""
    state, obs, reward, term, diverged = self.step_core(self._state, actions)
    steps = self._steps + 1
    done = term | (steps >= self._step_limit) | diverged
    idx = torch.nonzero(done)[:, 0]
    if len(idx):
      fresh = self._init(len(idx))
      fresh_state = forward_ops.slim_state(fresh)
      fresh_obs = self.task.get_observation(self.model, fresh)
      state = {k: v.index_put((idx,), fresh_state[k].to(v.dtype))
               for k, v in state.items()}
      obs = type(obs)((k, v.index_put((idx,), fresh_obs[k].to(v.dtype)))
                      for k, v in obs.items())
      steps = torch.where(done, torch.zeros_like(steps), steps)
    self._state, self._steps = state, steps
    return obs, reward, done

  # ------------------------------------------------------------------
  def rollout_random(self, n_steps: int) -> Tuple[types.Data, torch.Tensor]:
    """Rollout with uniform-random actions from the batch's generator.

    Finished or diverged envs go back to their state at the start of the
    rollout. Returns (final Data, summed rewards (B,)); a diverged env
    adds no reward for the step it diverged in.
    """
    m = self.model
    if self._state is None:
      self.reset()
    limited = m.const('actuator_ctrllimited',
                      lambda: np.asarray(m.actuator_ctrllimited, dtype=bool))
    lo = torch.where(limited, m.actuator_ctrlrange[:, 0],
                     -torch.ones_like(m.actuator_ctrlrange[:, 0]))
    hi = torch.where(limited, m.actuator_ctrlrange[:, 1],
                     torch.ones_like(m.actuator_ctrlrange[:, 1]))
    lo, hi = lo.float(), hi.float()
    pool = self._state
    state = self._state
    total = torch.zeros(self.batch_size, dtype=torch.float32, device=m.device)
    for _ in range(n_steps):
      u = torch.rand((self.batch_size, m.nu), generator=self._gen,
                     device=m.device, dtype=torch.float32)
      actions = lo + (hi - lo) * u
      state, _, reward, term, diverged = self.step_core(state, actions)
      state = _where(term | diverged, pool, state)
      total = total + torch.where(diverged, torch.zeros_like(reward),
                                  reward).float()
    self._state = state
    return self.data, total
