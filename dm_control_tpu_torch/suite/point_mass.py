"""Point-mass domain (port of dm_control_tpu/suite/point_mass.py),
batched.

Only the easy task: the hard one redraws the actuation directions
(`wrap_prm`) every episode, which needs a per-env model.
"""

from __future__ import annotations

import collections

import torch

from dm_control_tpu_torch import models
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import containers
from dm_control_tpu_torch.utils import rewards

_DEFAULT_TIME_LIMIT = 20
SUITE = containers.TaggedTasks()


def make_model() -> str:
  """The reference model asset, verbatim (suite/assets/point_mass.xml)."""
  return common.read_model('point_mass.xml')


@SUITE.add('benchmarking', 'easy')
def easy(time_limit=_DEFAULT_TIME_LIMIT, device='cuda', dtype=torch.float32):
  model = models.from_xml_string(make_model(), assets=common.read_assets(),
                                 device=device, dtype=dtype)
  return control.Environment(model, PointMass(model), time_limit=time_limit)


class PointMass(base.Task):
  """Reach the target with small controls."""

  def __init__(self, model):
    super().__init__(model)
    self._mass_geom = self.geom_id('pointmass')
    self._target_geom = self.geom_id('target')
    self._target_size = float(model.geom_size[self._target_geom, 0])

  def initialize_episode(self, model, data, generator):
    qpos = base.random_limited_qpos(model, data.qpos.shape[0], generator)
    return data.replace(qpos=qpos.to(data.qpos.dtype))

  def get_observation(self, model, data):
    obs = collections.OrderedDict()
    obs['position'] = data.qpos
    obs['velocity'] = data.qvel
    return obs

  def get_reward(self, model, data):
    dist = torch.linalg.vector_norm(
        data.geom_xpos[:, self._target_geom] -
        data.geom_xpos[:, self._mass_geom], dim=-1)
    near_target = rewards.tolerance(
        dist, bounds=(0, self._target_size), margin=self._target_size)
    control_reward = torch.mean(rewards.tolerance(
        data.ctrl, margin=1, value_at_margin=0, sigmoid='quadratic'), dim=-1)
    small_control = (control_reward + 4) / 5
    return near_target * small_control
