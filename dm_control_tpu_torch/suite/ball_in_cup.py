"""Ball-in-cup domain (port of dm_control_tpu/suite/ball_in_cup.py),
batched."""

from __future__ import annotations

import collections

import torch

from dm_control_tpu_torch import models
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import containers

_DEFAULT_TIME_LIMIT = 20
_CONTROL_TIMESTEP = .02
# rejection-sampling rounds for a contact-free initial ball position
_MAX_INIT_ROUNDS = 64
SUITE = containers.TaggedTasks()


def make_model() -> str:
  """The reference model asset, verbatim (suite/assets/ball_in_cup.xml)."""
  return common.read_model('ball_in_cup.xml')


@SUITE.add('benchmarking', 'easy')
def catch(time_limit=_DEFAULT_TIME_LIMIT, device='cuda', dtype=torch.float32):
  model = models.from_xml_string(make_model(), assets=common.read_assets(),
                                 device=device, dtype=dtype)
  return control.Environment(model, BallInCup(model), time_limit=time_limit,
                             control_timestep=_CONTROL_TIMESTEP)


class BallInCup(base.Task):
  """Swing the ball into the cup (sparse reward)."""

  def __init__(self, model):
    super().__init__(model)
    self._ball_body = self.body_id('ball')
    self._ball_geom = self.geom_id('ball')
    self._target_site = self.site_id('target')
    self._ball_x = self.joint_qposadr('ball_x')
    self._ball_z = self.joint_qposadr('ball_z')

  def initialize_episode(self, model, data, generator):
    """The ball at a random contact-free position: x uniform in
    [-0.2, 0.2), z in [0.2, 0.5), the rest at qpos0; only the envs that
    still have contacts are redrawn, for at most 64 rounds after the
    first draw."""
    dtype = data.qpos.dtype

    def draw(idx):
      n = len(idx)
      qpos = model.qpos0.to(dtype).expand(n, model.nq).clone()
      qpos[:, self._ball_x] = base.uniform(generator, (n,), -.2, .2, dtype)
      qpos[:, self._ball_z] = base.uniform(generator, (n,), .2, .5, dtype)
      return qpos

    return data.replace(qpos=base.contact_free_qpos(
        model, data.qpos.shape[0], draw, _MAX_INIT_ROUNDS))

  def get_observation(self, model, data):
    obs = collections.OrderedDict()
    obs['position'] = data.qpos
    obs['velocity'] = data.qvel
    return obs

  def get_reward(self, model, data):
    """1 where the ball is inside the cup's target box, else 0."""
    xz = [0, 2]
    target = data.site_xpos[:, self._target_site][:, xz]
    ball = data.xpos[:, self._ball_body][:, xz]
    size = model.site_size[self._target_site][xz]
    ball_size = model.geom_size[self._ball_geom, 0]
    inside = torch.all(torch.abs(target - ball) < size - ball_size, dim=-1)
    return inside.to(data.qpos.dtype)
