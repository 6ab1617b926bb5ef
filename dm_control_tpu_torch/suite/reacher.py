"""Reacher domain (port of dm_control_tpu/suite/reacher.py), batched.

Each episode draws the target's position (`geom_pos` of the target geom)
for its env: angle uniform in [0, 2 pi), radius uniform in [.05, .20).
"""

from __future__ import annotations

import collections
import math

import torch

from dm_control_tpu_torch import models
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import containers
from dm_control_tpu_torch.utils import rewards

_DEFAULT_TIME_LIMIT = 20
_BIG_TARGET = .05
_SMALL_TARGET = .015
SUITE = containers.TaggedTasks()


def make_model() -> str:
  """The reference model asset, verbatim (suite/assets/reacher.xml)."""
  return common.read_model('reacher.xml')


def _make_env(target_size, time_limit, device, dtype):
  model = models.from_xml_string(make_model(), assets=common.read_assets(),
                                 device=device, dtype=dtype)
  # the task's target size is baked into the model
  gid = model.names.name2id('geom', 'target')
  geom_size = model.geom_size.clone()
  geom_size[gid, 0] = target_size
  model = model.replace(geom_size=geom_size)
  return control.Environment(model, Reacher(model, target_size),
                             time_limit=time_limit)


@SUITE.add('benchmarking', 'easy')
def easy(time_limit=_DEFAULT_TIME_LIMIT, device='cuda', dtype=torch.float32):
  """Reacher with a large target."""
  return _make_env(_BIG_TARGET, time_limit, device, dtype)


@SUITE.add('benchmarking')
def hard(time_limit=_DEFAULT_TIME_LIMIT, device='cuda', dtype=torch.float32):
  """Reacher with a small target."""
  return _make_env(_SMALL_TARGET, time_limit, device, dtype)


class Reacher(base.Task):
  """Reach the target with the finger."""

  def __init__(self, model, target_size: float):
    super().__init__(model)
    self._target_size = target_size
    self._target = self.geom_id('target')
    self._finger = self.geom_id('finger')
    self._radii = float(model.geom_size[self._target, 0] +
                        model.geom_size[self._finger, 0])

  def randomize_model(self, model, n, generator):
    angle = base.uniform(generator, (n,), 0.0, 2 * math.pi, model.dtype)
    radius = base.uniform(generator, (n,), .05, .20, model.dtype)
    geom_pos = model.geom_pos.expand((n,) + model.geom_pos.shape).clone()
    geom_pos[:, self._target, 0] = radius * torch.sin(angle)
    geom_pos[:, self._target, 1] = radius * torch.cos(angle)
    return {'geom_pos': geom_pos}

  def initialize_episode(self, model, data, generator):
    qpos = base.random_limited_qpos(model, data.qpos.shape[0], generator)
    return data.replace(qpos=qpos.to(data.qpos.dtype))

  def _finger_to_target(self, data):
    return (data.geom_xpos[:, self._target, :2] -
            data.geom_xpos[:, self._finger, :2])

  def get_observation(self, model, data):
    obs = collections.OrderedDict()
    obs['position'] = data.qpos
    obs['to_target'] = self._finger_to_target(data)
    obs['velocity'] = data.qvel
    return obs

  def get_reward(self, model, data):
    dist = torch.linalg.vector_norm(self._finger_to_target(data), dim=-1)
    return rewards.tolerance(dist, (0, self._radii))
