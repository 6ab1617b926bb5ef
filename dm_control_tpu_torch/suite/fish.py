"""Fish domain (port of dm_control_tpu/suite/fish.py), batched.

Only the upright task: swim moves its target every episode, which needs
a per-env model.
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


@SUITE.add('benchmarking')
def upright(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
            dtype=torch.float32):
  model = models.from_xml_string(make_model(), assets=common.read_assets(),
                                 device=device, dtype=dtype)
  return control.Environment(model, Upright(model), time_limit=time_limit,
                             control_timestep=_CONTROL_TIMESTEP)


class Upright(base.Task):
  """Right the fish."""

  def __init__(self, model):
    super().__init__(model)
    self._torso = self.body_id('torso')
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

  def get_observation(self, model, data):
    obs = collections.OrderedDict()
    obs['joint_angles'] = data.qpos[:, self._joint_q]
    obs['upright'] = self._upright(data)
    obs['velocity'] = data.qvel
    return obs

  def get_reward(self, model, data):
    return rewards.tolerance(self._upright(data), bounds=(1, 1), margin=1)
