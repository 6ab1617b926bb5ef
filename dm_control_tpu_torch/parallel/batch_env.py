"""Auto-resetting batches of environments on one device.

Port of dm_control_tpu/parallel/batch_env.py without the mesh: one Model,
a batch of slim states (forward.SLIM_STATE_FIELDS) and a Python loop over
control steps. A task that changes its model each episode
(`Task.randomize_model`) gets one row an env of the leaves it draws, drawn
at reset and again at each env's auto-reset, before that env's initial
state, as the unbatched JAX environment draws them
(dm_control_tpu/rl/control.py:146-151; the JAX batched path never draws).
Each control step runs `n_sub_steps` batched physics steps, then one
position/velocity refresh for observations and rewards. As in
MuJoCo's `Physics.step` (mj_step2 then mj_step1 each substep), the
position- and velocity-stage sensors are of the new state and the
acceleration-stage sensors (touch, accelerometer, force, torque) of the
last substep's pre-integration state, from its constraint solve. (The
JAX package's batched path keeps the acceleration-stage values of the
episode's first forward instead.)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dm_control_tpu_torch.models import types
from dm_control_tpu_torch.ops import forward as forward_ops
from dm_control_tpu_torch.ops import sensor as sensor_ops
from dm_control_tpu_torch.rl import control


def _where(mask: torch.Tensor, new: dict, old: dict) -> dict:
  """Per-env select of two dicts of (B, ...) tensors."""
  return {k: torch.where(mask.reshape((-1,) + (1,) * (old[k].dim() - 1)),
                         new[k], old[k]) for k in old}


class BatchedEnvironment:
  """A batch of environments of one model stepped together; a task that
  randomizes its model gives each env its own drawn leaves.

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
    self._leaves = {}
    self._batch_model = model

  # ------------------------------------------------------------------
  def _inflate(self, state: dict) -> types.Data:
    template = (self._template
                if state['qpos'].shape[0] == self.batch_size else None)
    return forward_ops.inflate(self.model, state, template)

  def _init(self, n: int):
    """n new episodes: their drawn model leaves ({} for a task that draws
    none), the model with them, and its fresh, fully forward-computed
    Data. The leaves are drawn before the initial states (the JAX order)."""
    leaves = self.task.randomize_model(self.model, n, self._gen)
    m = self.model.with_leaves(**leaves) if leaves else self.model
    data = types.make_data(m, n)
    data = self.task.initialize_episode(m, data, self._gen)
    return leaves, m, forward_ops.forward(m, data)

  def _set_leaves(self, leaves: dict):
    self._leaves = dict(leaves)
    self._batch_model = (self.model.with_leaves(**leaves) if leaves
                         else self.model)

  def step_core(self, state: dict, actions: torch.Tensor):
    """One control step of the whole batch, without resets.

    Returns (state, obs, reward, termination, diverged).
    """
    m, task = self._batch_model, self.task
    d = task.before_step(m, self._inflate(state), actions)
    state = forward_ops.slim_state(d)
    acc = sensor_ops.has_acc_stage(m)
    for i in range(self._n_sub_steps):
      # the last substep evaluates the acceleration-stage sensors of its
      # pre-integration state from its own constraint solve (as MuJoCo's
      # mj_step2); the refresh below computes the position/velocity stage
      # for the new state
      d = forward_ops.step_batched(
          m, self._inflate(state),
          compute_sensors=acc and i == self._n_sub_steps - 1, stages='acc')
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

  @property
  def leaves(self) -> dict:
    """The drawn model leaves of the batch, {name: (B, ...)}; {} while the
    batch steps with the compiled model."""
    return self._leaves

  @property
  def batch_model(self) -> types.Model:
    """The model the batch steps with: `model` with `leaves`."""
    return self._batch_model

  def set_state(self, state: dict, leaves: dict = None,
                steps: torch.Tensor = None):
    """Replace the batch's slim state; with `leaves`, its drawn model
    leaves too; with `steps` ((B,) ints), the control steps each env's
    episode has run, for the time limit (default: 0 for every env)."""
    self._state = dict(state)
    if leaves is not None:
      self._set_leaves(leaves)
    if steps is None:
      steps = torch.zeros(self.batch_size, dtype=torch.int64)
    self._steps = torch.as_tensor(steps, dtype=torch.int64).to(
        self.model.device, copy=True)

  @property
  def data(self) -> types.Data:
    """Position/velocity-fresh Data of the current state."""
    if self._state is None:
      return None
    return forward_ops.fwd_pv(self._batch_model, self._inflate(self._state))

  def reset(self):
    leaves, m, data = self._init(self.batch_size)
    obs = self.task.get_observation(m, data)
    self.set_state(forward_ops.slim_state(data), leaves=leaves)
    return obs

  def step(self, actions: torch.Tensor):
    """Returns (obs, reward, done) for the batch."""
    state, obs, reward, term, diverged = self.step_core(self._state, actions)
    steps = self._steps + 1
    done = term | (steps >= self._step_limit) | diverged
    idx = torch.nonzero(done)[:, 0]
    if len(idx):
      leaves, m, fresh = self._init(len(idx))
      fresh_state = forward_ops.slim_state(fresh)
      fresh_obs = self.task.get_observation(m, fresh)
      state = {k: v.index_put((idx,), fresh_state[k].to(v.dtype))
               for k, v in state.items()}
      obs = type(obs)((k, v.index_put((idx,), fresh_obs[k].to(v.dtype)))
                      for k, v in obs.items())
      steps = torch.where(done, torch.zeros_like(steps), steps)
      if leaves:
        # only the done envs draw; the others keep their leaves
        old = self._leaves or {
            k: getattr(self.model, k).expand(
                (self.batch_size,) + v.shape[1:]).clone()
            for k, v in leaves.items()}
        self._set_leaves(types.put_envs(old, idx, leaves))
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
