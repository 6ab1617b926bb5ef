"""Hopper domain (port of dm_control_tpu/suite/hopper.py), batched."""

from __future__ import annotations

import collections

import torch

from dm_control_tpu_torch import models
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import containers
from dm_control_tpu_torch.utils import rewards

_CONTROL_TIMESTEP = .02
_DEFAULT_TIME_LIMIT = 20
_STAND_HEIGHT = 0.6
_HOP_SPEED = 2
SUITE = containers.TaggedTasks()


def make_model() -> str:
  """The reference model asset, verbatim (suite/assets/hopper.xml)."""
  return common.read_model('hopper.xml')


def _make_env(hopping, time_limit, device, dtype):
  model = models.from_xml_string(make_model(), assets=common.read_assets(),
                                 device=device, dtype=dtype)
  return control.Environment(model, Hopper(model, hopping=hopping),
                             time_limit=time_limit,
                             control_timestep=_CONTROL_TIMESTEP)


@SUITE.add('benchmarking')
def stand(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
          dtype=torch.float32):
  return _make_env(False, time_limit, device, dtype)


@SUITE.add('benchmarking')
def hop(time_limit=_DEFAULT_TIME_LIMIT, device='cuda', dtype=torch.float32):
  return _make_env(True, time_limit, device, dtype)


class Hopper(base.Task):
  """Stand upright or hop forward."""

  def __init__(self, model, hopping: bool):
    super().__init__(model)
    self._hopping = hopping
    self._torso = self.body_id('torso')
    self._foot = self.body_id('foot')
    self._speed_slice = self.sensor_slice('torso_subtreelinvel')
    self._touch_toe = self.sensor_slice('touch_toe')
    self._touch_heel = self.sensor_slice('touch_heel')

  def initialize_episode(self, model, data, generator):
    qpos = base.random_limited_qpos(model, data.qpos.shape[0], generator)
    return data.replace(qpos=qpos.to(data.qpos.dtype))

  def _height(self, data):
    return data.xipos[:, self._torso, 2] - data.xipos[:, self._foot, 2]

  def get_observation(self, model, data):
    obs = collections.OrderedDict()
    obs['position'] = data.qpos[:, 1:]
    obs['velocity'] = data.qvel
    obs['touch'] = torch.log1p(torch.cat(
        [data.sensordata[:, self._touch_toe],
         data.sensordata[:, self._touch_heel]], dim=-1))
    return obs

  def get_reward(self, model, data):
    standing = rewards.tolerance(self._height(data), (_STAND_HEIGHT, 2))
    if self._hopping:
      hopping = rewards.tolerance(
          data.sensordata[:, self._speed_slice][:, 0],
          bounds=(_HOP_SPEED, float('inf')), margin=_HOP_SPEED / 2,
          value_at_margin=0.5, sigmoid='linear')
      return standing * hopping
    small_control = torch.mean(rewards.tolerance(
        data.ctrl, margin=1, value_at_margin=0, sigmoid='quadratic'), dim=-1)
    return standing * (small_control + 4) / 5
