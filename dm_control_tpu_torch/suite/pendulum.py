"""Pendulum domain (port of dm_control_tpu/suite/pendulum.py), batched."""

from __future__ import annotations

import collections
import math

import numpy as np
import torch

from dm_control_tpu_torch import models
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import containers
from dm_control_tpu_torch.utils import rewards

_DEFAULT_TIME_LIMIT = 20
_ANGLE_BOUND = 8
_COSINE_BOUND = np.cos(np.deg2rad(_ANGLE_BOUND))
SUITE = containers.TaggedTasks()


def make_model() -> str:
  """The reference model asset, verbatim (suite/assets/pendulum.xml)."""
  return common.read_model('pendulum.xml')


@SUITE.add('benchmarking')
def swingup(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
            dtype=torch.float32):
  model = models.from_xml_string(make_model(), assets=common.read_assets(),
                                 device=device, dtype=dtype)
  return control.Environment(model, SwingUp(model), time_limit=time_limit)


class SwingUp(base.Task):
  """Swing up and balance the pole."""

  def __init__(self, model):
    super().__init__(model)
    self._pole = self.body_id('pole')
    self._hinge_q = self.joint_qposadr('hinge')
    self._hinge_v = self.joint_dofadr('hinge')

  def initialize_episode(self, model, data, generator):
    qpos = data.qpos.clone()
    qpos[:, self._hinge_q] = base.uniform(
        generator, (qpos.shape[0],), -math.pi, math.pi, qpos.dtype)
    return data.replace(qpos=qpos)

  def get_observation(self, model, data):
    obs = collections.OrderedDict()
    obs['orientation'] = data.xmat[:, self._pole, [2, 0], 2]
    obs['velocity'] = data.qvel[:, self._hinge_v:self._hinge_v + 1]
    return obs

  def get_reward(self, model, data):
    return rewards.tolerance(data.xmat[:, self._pole, 2, 2],
                             (_COSINE_BOUND, 1))
