"""Acrobot domain (port of dm_control_tpu/suite/acrobot.py), batched."""

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

_DEFAULT_TIME_LIMIT = 10
SUITE = containers.TaggedTasks()


def make_model() -> str:
  """The reference model asset, verbatim (suite/assets/acrobot.xml)."""
  return common.read_model('acrobot.xml')


def _make_env(sparse, time_limit, device, dtype):
  model = models.from_xml_string(make_model(), assets=common.read_assets(),
                                 device=device, dtype=dtype)
  task = Balance(model, sparse=sparse)
  return control.Environment(model, task, time_limit=time_limit)


@SUITE.add('benchmarking')
def swingup(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
            dtype=torch.float32):
  return _make_env(False, time_limit, device, dtype)


@SUITE.add('benchmarking')
def swingup_sparse(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
                   dtype=torch.float32):
  return _make_env(True, time_limit, device, dtype)


class Balance(base.Task):
  """Swing up and balance the acrobot's tip at the target."""

  def __init__(self, model, sparse: bool):
    super().__init__(model)
    self._sparse = sparse
    self._arms = [self.body_id('upper_arm'), self.body_id('lower_arm')]
    self._target = self.site_id('target')
    self._tip = self.site_id('tip')
    self._target_radius = float(model.site_size[self._target, 0])

  def initialize_episode(self, model, data, generator):
    angles = base.uniform(generator, (data.qpos.shape[0], 2), -math.pi,
                          math.pi, data.qpos.dtype)
    return data.replace(qpos=angles)

  def get_observation(self, model, data):
    obs = collections.OrderedDict()
    obs['orientations'] = torch.cat([data.xmat[:, self._arms, 0, 2],
                                     data.xmat[:, self._arms, 2, 2]], dim=-1)
    obs['velocity'] = data.qvel
    return obs

  def get_reward(self, model, data):
    to_target = torch.linalg.vector_norm(
        data.site_xpos[:, self._target] - data.site_xpos[:, self._tip],
        dim=-1)
    return rewards.tolerance(to_target, bounds=(0, self._target_radius),
                             margin=0 if self._sparse else 1)
