"""Humanoid domain (port of dm_control_tpu/suite/humanoid.py), batched."""

from __future__ import annotations

import collections

import torch

from dm_control_tpu_torch import models
from dm_control_tpu_torch.models import types
from dm_control_tpu_torch.ops import collision as coll_ops
from dm_control_tpu_torch.ops import smooth
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import containers
from dm_control_tpu_torch.utils import rewards

_DEFAULT_TIME_LIMIT = 25
_CONTROL_TIMESTEP = .025
_STAND_HEIGHT = 1.4
_WALK_SPEED = 1
_RUN_SPEED = 10
# rejection-sampling rounds for a contact-free initial pose
_MAX_INIT_ROUNDS = 64
SUITE = containers.TaggedTasks()


def make_model() -> str:
  """The reference model asset, verbatim (suite/assets/humanoid.xml)."""
  return common.read_model('humanoid.xml')


def _make_env(move_speed, pure_state, time_limit, device, dtype):
  model = models.from_xml_string(make_model(), assets=common.read_assets(),
                                 device=device, dtype=dtype)
  task = Humanoid(model, move_speed=move_speed, pure_state=pure_state)
  return control.Environment(model, task, time_limit=time_limit,
                             control_timestep=_CONTROL_TIMESTEP)


@SUITE.add('benchmarking')
def stand(time_limit=_DEFAULT_TIME_LIMIT, device='cpu',
          dtype=torch.float32):
  return _make_env(0, False, time_limit, device, dtype)


@SUITE.add('benchmarking')
def walk(time_limit=_DEFAULT_TIME_LIMIT, device='cpu', dtype=torch.float32):
  return _make_env(_WALK_SPEED, False, time_limit, device, dtype)


@SUITE.add('benchmarking')
def run(time_limit=_DEFAULT_TIME_LIMIT, device='cpu', dtype=torch.float32):
  return _make_env(_RUN_SPEED, False, time_limit, device, dtype)


@SUITE.add()
def run_pure_state(time_limit=_DEFAULT_TIME_LIMIT, device='cpu',
                   dtype=torch.float32):
  return _make_env(_RUN_SPEED, True, time_limit, device, dtype)


class Humanoid(base.Task):
  """Stand, walk or run, rewarded for uprightness and speed."""

  def __init__(self, model, move_speed, pure_state):
    super().__init__(model)
    self._move_speed = move_speed
    self._pure_state = pure_state
    self._torso = self.body_id('torso')
    self._head = self.body_id('head')
    self._extremities = [self.body_id(side + limb)
                         for side in ('left_', 'right_')
                         for limb in ('hand', 'foot')]
    self._com_vel_slice = self.sensor_slice('torso_subtreelinvel')

  def initialize_episode(self, model, data, generator):
    """Rejection-sample collision-free random joint configurations: only
    the envs that still have contacts are redrawn, for at most 64 rounds
    after the first draw."""

    def n_contacts(qpos):
      d = types.make_data(model, qpos.shape[0], dtype=qpos.dtype)
      d = smooth.kinematics(model, d.replace(qpos=qpos))
      d = coll_ops.collision(model, d)
      return d.contact.active.sum(dim=-1)

    qpos = base.random_limited_qpos(model, data.qpos.shape[0], generator)
    qpos = qpos.to(data.qpos.dtype)
    n = n_contacts(qpos)
    for _ in range(_MAX_INIT_ROUNDS):
      redo = torch.nonzero(n > 0)[:, 0]
      if not len(redo):
        break
      q = base.random_limited_qpos(model, len(redo), generator)
      qpos[redo] = q.to(qpos.dtype)
      n[redo] = n_contacts(qpos[redo])
    return data.replace(qpos=qpos)

  def get_observation(self, model, data):
    obs = collections.OrderedDict()
    if self._pure_state:
      obs['position'] = data.qpos
      obs['velocity'] = data.qvel
      return obs
    obs['joint_angles'] = data.qpos[:, 7:]
    obs['head_height'] = data.xpos[:, self._head, 2]
    torso_frame = data.xmat[:, self._torso]
    torso_pos = data.xpos[:, self._torso]
    obs['extremities'] = torch.cat([
        torch.einsum('Bi,Bij->Bj', data.xpos[:, b] - torso_pos, torso_frame)
        for b in self._extremities], dim=-1)
    obs['torso_vertical'] = data.xmat[:, self._torso, 2, :]
    obs['com_velocity'] = data.sensordata[:, self._com_vel_slice]
    obs['velocity'] = data.qvel
    return obs

  def get_reward(self, model, data):
    head_height = data.xpos[:, self._head, 2]
    standing = rewards.tolerance(head_height,
                                 bounds=(_STAND_HEIGHT, float('inf')),
                                 margin=_STAND_HEIGHT / 4)
    upright = rewards.tolerance(data.xmat[:, self._torso, 2, 2],
                                bounds=(0.9, float('inf')), sigmoid='linear',
                                margin=1.9, value_at_margin=0)
    stand_reward = standing * upright
    small_control = torch.mean(rewards.tolerance(
        data.ctrl, margin=1, value_at_margin=0, sigmoid='quadratic'), dim=-1)
    small_control = (4 + small_control) / 5
    com_vel_xy = data.sensordata[:, self._com_vel_slice][:, :2]
    if self._move_speed == 0:
      dont_move = torch.mean(rewards.tolerance(com_vel_xy, margin=2), dim=-1)
      return small_control * stand_reward * dont_move
    com_speed = torch.linalg.vector_norm(com_vel_xy, dim=-1)
    move = rewards.tolerance(com_speed, bounds=(self._move_speed,
                                                float('inf')),
                             margin=self._move_speed, value_at_margin=0,
                             sigmoid='linear')
    move = (5 * move + 1) / 6
    return small_control * stand_reward * move
