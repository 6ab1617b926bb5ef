"""Planar walker domain (port of dm_control_tpu/suite/walker.py), batched."""

from __future__ import annotations

import collections

import torch

from dm_control_tpu_torch import models
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import containers
from dm_control_tpu_torch.utils import rewards

_DEFAULT_TIME_LIMIT = 25
_CONTROL_TIMESTEP = .025
_STAND_HEIGHT = 1.2
_WALK_SPEED = 1
_RUN_SPEED = 8
SUITE = containers.TaggedTasks()


def make_model() -> str:
  """The reference model asset, verbatim (suite/assets/walker.xml)."""
  return common.read_model('walker.xml')


def _make_env(move_speed, time_limit, device, dtype):
  model = models.from_xml_string(make_model(), assets=common.read_assets(),
                                 device=device, dtype=dtype)
  task = PlanarWalker(model, move_speed=move_speed)
  return control.Environment(model, task, time_limit=time_limit,
                             control_timestep=_CONTROL_TIMESTEP)


@SUITE.add('benchmarking')
def stand(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
          dtype=torch.float32):
  return _make_env(0, time_limit, device, dtype)


@SUITE.add('benchmarking')
def walk(time_limit=_DEFAULT_TIME_LIMIT, device='cuda', dtype=torch.float32):
  return _make_env(_WALK_SPEED, time_limit, device, dtype)


@SUITE.add('benchmarking')
def run(time_limit=_DEFAULT_TIME_LIMIT, device='cuda', dtype=torch.float32):
  return _make_env(_RUN_SPEED, time_limit, device, dtype)


class PlanarWalker(base.Task):
  """Stand, walk or run with a planar biped."""

  def __init__(self, model, move_speed):
    super().__init__(model)
    self._move_speed = move_speed
    self._torso = self.body_id('torso')
    self._speed_slice = self.sensor_slice('torso_subtreelinvel')

  def initialize_episode(self, model, data, generator):
    qpos = base.random_limited_qpos(model, data.qpos.shape[0], generator)
    return data.replace(qpos=qpos.to(data.qpos.dtype))

  def get_observation(self, model, data):
    obs = collections.OrderedDict()
    # the planar orientation (xx, xz) of every body but the world
    xx_xz = data.xmat[:, 1:, 0, ::2]
    obs['orientations'] = xx_xz.reshape(xx_xz.shape[0], -1)
    obs['height'] = data.xpos[:, self._torso, 2]
    obs['velocity'] = data.qvel
    return obs

  def get_reward(self, model, data):
    standing = rewards.tolerance(
        data.xpos[:, self._torso, 2], bounds=(_STAND_HEIGHT, float('inf')),
        margin=_STAND_HEIGHT / 2)
    upright = (1 + data.xmat[:, self._torso, 2, 2]) / 2
    stand_reward = (3 * standing + upright) / 4
    if self._move_speed == 0:
      return stand_reward
    move_reward = rewards.tolerance(
        data.sensordata[:, self._speed_slice][:, 0],
        bounds=(self._move_speed, float('inf')),
        margin=self._move_speed / 2, value_at_margin=0.5, sigmoid='linear')
    return stand_reward * (5 * move_reward + 1) / 6
