"""Cheetah domain (port of dm_control_tpu/suite/cheetah.py), batched."""

from __future__ import annotations

import collections

import torch

from dm_control_tpu_torch import models
from dm_control_tpu_torch.ops import forward as forward_ops
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import containers
from dm_control_tpu_torch.utils import rewards

_DEFAULT_TIME_LIMIT = 10
_RUN_SPEED = 10
# physics steps the initializer lets the randomized pose settle for
_SETTLE_STEPS = 200
SUITE = containers.TaggedTasks()


def make_model() -> str:
  """The reference model asset, verbatim (suite/assets/cheetah.xml)."""
  return common.read_model('cheetah.xml')


@SUITE.add('benchmarking')
def run(time_limit=_DEFAULT_TIME_LIMIT, device='cuda', dtype=torch.float32):
  model = models.from_xml_string(make_model(), assets=common.read_assets(),
                                 device=device, dtype=dtype)
  return control.Environment(model, Cheetah(model), time_limit=time_limit)


def settle(model, data):
  """_SETTLE_STEPS batched physics steps with zero control, then the
  clock restarts at 0. Sensors are skipped: they do not feed the
  dynamics, and the environment's forward pass after the initializer
  computes them."""
  for _ in range(_SETTLE_STEPS):
    data = forward_ops.step_batched(model, data, compute_sensors=False)
  return data.replace(time=torch.zeros_like(data.time))


class Cheetah(base.Task):
  """Run forward fast."""

  def __init__(self, model):
    super().__init__(model)
    self._speed_slice = self.sensor_slice('torso_subtreelinvel')

  def initialize_episode(self, model, data, generator):
    """Limited joints uniform in range, then 200 settling steps."""
    qpos = base.random_limited_qpos_only_limited(model, data.qpos.shape[0],
                                                 generator)
    return settle(model, data.replace(qpos=qpos.to(data.qpos.dtype)))

  def get_observation(self, model, data):
    obs = collections.OrderedDict()
    obs['position'] = data.qpos[:, 1:]
    obs['velocity'] = data.qvel
    return obs

  def get_reward(self, model, data):
    return rewards.tolerance(
        data.sensordata[:, self._speed_slice][:, 0],
        bounds=(_RUN_SPEED, float('inf')), margin=_RUN_SPEED,
        value_at_margin=0, sigmoid='linear')
