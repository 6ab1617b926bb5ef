"""Fish domain (port of dm_control_tpu/suite/fish.py), batched.

upright rights the fish; swim brings its mouth to a target that each
episode places for its env (`geom_pos` of the target geom: x and y
uniform in [-.4, .4), z in [.1, .3)).
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

_DEFAULT_TIME_LIMIT = 40
_CONTROL_TIMESTEP = .04
_JOINTS = ['tail1', 'tail_twist', 'tail2', 'finright_roll',
           'finright_pitch', 'finleft_roll', 'finleft_pitch']
SUITE = containers.TaggedTasks()


def make_model() -> str:
  """The reference model asset, verbatim (suite/assets/fish.xml)."""
  return common.read_model('fish.xml')


def _make_env(task_cls, time_limit, device, dtype):
  model = models.from_xml_string(make_model(), assets=common.read_assets(),
                                 device=device, dtype=dtype)
  return control.Environment(model, task_cls(model), time_limit=time_limit,
                             control_timestep=_CONTROL_TIMESTEP)


@SUITE.add('benchmarking')
def upright(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
            dtype=torch.float32):
  return _make_env(Upright, time_limit, device, dtype)


@SUITE.add('benchmarking')
def swim(time_limit=_DEFAULT_TIME_LIMIT, device='cuda', dtype=torch.float32):
  return _make_env(Swim, time_limit, device, dtype)


class _FishTask(base.Task):

  def __init__(self, model):
    super().__init__(model)
    self._torso = self.body_id('torso')
    self._mouth = self.geom_id('mouth')
    self._target = self.geom_id('target')
    self._joint_q = [self.joint_qposadr(j) for j in _JOINTS]
    self._root_q = self.joint_qposadr('root')

  def initialize_episode(self, model, data, generator):
    """A random root orientation (a normalized normal draw) and the fin
    and tail joints uniform in [-0.2, 0.2)."""
    B, dtype = data.qpos.shape[0], data.qpos.dtype
    quat = torch.randn((B, 4), generator=generator, device=generator.device,
                       dtype=dtype)
    quat = quat / torch.clamp(torch.linalg.vector_norm(
        quat, dim=-1, keepdim=True), min=1e-12)
    qpos = data.qpos.clone()
    qpos[:, self._root_q + 3:self._root_q + 7] = quat
    qpos[:, self._joint_q] = base.uniform(
        generator, (B, len(self._joint_q)), -.2, .2, dtype)
    return data.replace(qpos=qpos)

  def _upright(self, data):
    return data.xmat[:, self._torso, 2, 2]


class Upright(_FishTask):
  """Right the fish."""

  def get_observation(self, model, data):
    obs = collections.OrderedDict()
    obs['joint_angles'] = data.qpos[:, self._joint_q]
    obs['upright'] = self._upright(data)
    obs['velocity'] = data.qvel
    return obs

  def get_reward(self, model, data):
    return rewards.tolerance(self._upright(data), bounds=(1, 1), margin=1)


class Swim(_FishTask):
  """Swim to the target."""

  def __init__(self, model):
    super().__init__(model)
    size = model.geom_size
    self._radii = float(size[self._mouth, 0] + size[self._target, 0])

  def randomize_model(self, model, n, generator):
    xy = base.uniform(generator, (n, 2), -.4, .4, model.dtype)
    z = base.uniform(generator, (n,), .1, .3, model.dtype)
    geom_pos = model.geom_pos.expand((n,) + model.geom_pos.shape).clone()
    geom_pos[:, self._target, 0:2] = xy
    geom_pos[:, self._target, 2] = z
    return {'geom_pos': geom_pos}

  def _mouth_to_target(self, data):
    """The target in the mouth's frame."""
    dif = data.geom_xpos[:, self._target] - data.geom_xpos[:, self._mouth]
    return torch.einsum('Bi,Bij->Bj', dif, data.geom_xmat[:, self._mouth])

  def get_observation(self, model, data):
    obs = collections.OrderedDict()
    obs['joint_angles'] = data.qpos[:, self._joint_q]
    obs['upright'] = self._upright(data)
    obs['target'] = self._mouth_to_target(data)
    obs['velocity'] = data.qvel
    return obs

  def get_reward(self, model, data):
    in_target = rewards.tolerance(
        torch.linalg.vector_norm(self._mouth_to_target(data), dim=-1),
        bounds=(0, self._radii), margin=2 * self._radii)
    is_upright = 0.5 * (self._upright(data) + 1)
    return (7 * in_target + is_upright) / 8
