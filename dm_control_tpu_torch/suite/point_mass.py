"""Point-mass domain (port of dm_control_tpu/suite/point_mass.py),
batched.

The easy task actuates along x and y. The hard one draws two actuation
directions for each episode (the tendon coefficients `wrap_prm[0:4]` of
its env): a unit dir1 from a normal draw, and dir2 that direction turned
by an angle uniform in [arccos .9, pi - arccos .9), so |dir1 . dir2| <= .9
(the reference's rejection-free form).
"""

from __future__ import annotations

import collections

import numpy as np
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


@SUITE.add()
def hard(time_limit=_DEFAULT_TIME_LIMIT, device='cuda', dtype=torch.float32):
  model = models.from_xml_string(make_model(), assets=common.read_assets(),
                                 device=device, dtype=dtype)
  return control.Environment(model, PointMass(model, randomize_gains=True),
                             time_limit=time_limit)


class PointMass(base.Task):
  """Reach the target with small controls; with `randomize_gains`, along
  actuation directions drawn each episode."""

  def __init__(self, model, randomize_gains: bool = False):
    super().__init__(model)
    self._randomize_gains = randomize_gains
    self._mass_geom = self.geom_id('pointmass')
    self._target_geom = self.geom_id('target')
    self._target_size = float(model.geom_size[self._target_geom, 0])

  def randomize_model(self, model, n, generator):
    if not self._randomize_gains:
      return {}
    dtype = model.dtype
    dir1 = torch.randn((n, 2), generator=generator, device=generator.device,
                       dtype=dtype)
    dir1 = dir1 / torch.linalg.vector_norm(dir1, dim=-1, keepdim=True)
    ang = base.uniform(generator, (n,), np.arccos(0.9),
                       np.pi - np.arccos(0.9), dtype)
    c, s = torch.cos(ang), torch.sin(ang)
    dir2 = torch.stack([c * dir1[:, 0] - s * dir1[:, 1],
                        s * dir1[:, 0] + c * dir1[:, 1]], dim=-1)
    wrap_prm = model.wrap_prm.expand((n,) + model.wrap_prm.shape).clone()
    wrap_prm[:, 0:2] = dir1
    wrap_prm[:, 2:4] = dir2
    return {'wrap_prm': wrap_prm}

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
