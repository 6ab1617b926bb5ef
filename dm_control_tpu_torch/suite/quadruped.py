"""Quadruped domain (port of dm_control_tpu/suite/quadruped.py), batched.

walk, run and fetch. escape waits for the heightfield narrowphase and the
rangefinder rays.
"""

from __future__ import annotations

import collections
import math
from xml.etree import ElementTree as etree

import torch

from dm_control_tpu_torch import models
from dm_control_tpu_torch.models import constants
from dm_control_tpu_torch.models import types
from dm_control_tpu_torch.ops import collision as coll_ops
from dm_control_tpu_torch.ops import smooth
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import containers
from dm_control_tpu_torch.utils import rewards

_DEFAULT_TIME_LIMIT = 20
_CONTROL_TIMESTEP = .02
_RUN_SPEED = 5
_WALK_SPEED = 0.5
# the initializer raises the root by this much a round, for at most
# _MAX_LIFT_ROUNDS rounds, until nothing touches
_LIFT_STEP = 0.01
_MAX_LIFT_ROUNDS = 1000
SUITE = containers.TaggedTasks()

_WALLS = ['wall_px', 'wall_py', 'wall_nx', 'wall_ny']


def _remove(mjcf, tag, name):
  for parent in mjcf.iter():
    for child in list(parent):
      if child.tag == tag and child.get('name') == name:
        parent.remove(child)
        return
  raise ValueError(f'{tag} {name!r} not found')


def make_model(floor_size=None, walls_and_ball=False) -> str:
  """The model asset (suite/assets/quadruped.xml) with the elements a task
  does not use removed: the terrain and the rangefinders (escape's, not
  ported) always, the walls, the ball and the target unless asked for."""
  mjcf = etree.fromstring(common.read_model('quadruped.xml'))

  if floor_size is not None:
    floor_geom = mjcf.find('.//geom[@name=\'floor\']')
    floor_geom.set('size', f'{floor_size} {floor_size} .5')

  if not walls_and_ball:
    for wall in _WALLS:
      _remove(mjcf, 'geom', wall)
    _remove(mjcf, 'body', 'ball')
    _remove(mjcf, 'site', 'target')

  _remove(mjcf, 'geom', 'terrain')
  for sensor in mjcf.findall('sensor'):
    for rf in sensor.findall('rangefinder'):
      sensor.remove(rf)

  return etree.tostring(mjcf, encoding='unicode')


def _make_env(xml, task_cls, task_kwargs, time_limit, device, dtype):
  model = models.from_xml_string(xml, assets=common.read_assets(),
                                 device=device, dtype=dtype)
  return control.Environment(model, task_cls(model, **task_kwargs),
                             time_limit=time_limit,
                             control_timestep=_CONTROL_TIMESTEP)


@SUITE.add()
def walk(time_limit=_DEFAULT_TIME_LIMIT, device='cuda', dtype=torch.float32):
  return _make_env(make_model(floor_size=_DEFAULT_TIME_LIMIT * _WALK_SPEED),
                   Move, dict(desired_speed=_WALK_SPEED), time_limit, device,
                   dtype)


@SUITE.add()
def run(time_limit=_DEFAULT_TIME_LIMIT, device='cuda', dtype=torch.float32):
  return _make_env(make_model(floor_size=_DEFAULT_TIME_LIMIT * _RUN_SPEED),
                   Move, dict(desired_speed=_RUN_SPEED), time_limit, device,
                   dtype)


@SUITE.add()
def fetch(time_limit=_DEFAULT_TIME_LIMIT, device='cuda', dtype=torch.float32):
  return _make_env(make_model(walls_and_ball=True), Fetch, {}, time_limit,
                   device, dtype)


def _upright_reward(data, torso, deviation_angle=0):
  deviation = math.cos(math.radians(deviation_angle))
  return rewards.tolerance(data.xmat[:, torso, 2, 2],
                           bounds=(deviation, float('inf')),
                           sigmoid='linear', margin=1 + deviation,
                           value_at_margin=0)


def _rel(data, pos, torso):
  """World points (B, 3) relative to the torso, in the torso's frame."""
  return torch.einsum('Bi,Bij->Bj', pos - data.xpos[:, torso],
                      data.xmat[:, torso])


class _QuadrupedTask(base.Task):
  """Observations and the contact-free initial height shared by the
  quadruped tasks."""

  def __init__(self, model):
    super().__init__(model)
    self._torso = self.body_id('torso')
    self._root_q = self.joint_qposadr('root')
    hinges = [j for j in range(model.njnt)
              if model.jnt_type[j] == constants.JointType.HINGE]
    self._hinge_q = [model.jnt_qposadr[j] for j in hinges]
    self._hinge_v = [model.jnt_dofadr[j] for j in hinges]
    self._vel_slice = self.sensor_slice('velocimeter')
    self._imu = [self.sensor_slice('imu_accel'),
                 self.sensor_slice('imu_gyro')]
    names = model.names.names('sensor')
    self._ft = [self.sensor_slice(n) for n in names
                if n.startswith(('force_', 'torque_'))]

  def _find_non_contacting_height(self, model, data, quat, xy=None):
    """qpos with the root at orientation `quat` (B, 4) and planar position
    `xy` (B, 2) (default 0), raised from z = 0 in steps of _LIFT_STEP
    until the env has no active contact. Each round re-collides only the
    envs that still touch; the loop ends when none does or after
    _MAX_LIFT_ROUNDS rounds."""

    def n_contacts(qpos):
      d = types.make_data(model, qpos.shape[0], dtype=qpos.dtype)
      d = smooth.kinematics(model, d.replace(qpos=qpos))
      return coll_ops.collision(model, d).contact.active.sum(dim=-1)

    adr = self._root_q
    qpos = data.qpos.clone()
    if xy is not None:
      qpos[:, adr:adr + 2] = xy
    qpos[:, adr + 2] = 0.0
    qpos[:, adr + 3:adr + 7] = quat
    n = n_contacts(qpos)
    for _ in range(_MAX_LIFT_ROUNDS):
      lift = torch.nonzero(n > 0)[:, 0]
      if not len(lift):
        break
      qpos[lift, adr + 2] += _LIFT_STEP
      n[lift] = n_contacts(qpos[lift])
    return qpos

  def _random_orientation(self, gen, batch, dtype):
    quat = torch.randn((batch, 4), generator=gen, device=gen.device,
                       dtype=dtype)
    return quat / torch.clamp(torch.linalg.vector_norm(
        quat, dim=-1, keepdim=True), min=1e-12)

  def _common_observations(self, data):
    obs = collections.OrderedDict()
    obs['egocentric_state'] = torch.cat(
        [data.qpos[:, self._hinge_q], data.qvel[:, self._hinge_v],
         data.act], dim=-1)
    obs['torso_velocity'] = data.sensordata[:, self._vel_slice]
    obs['torso_upright'] = data.xmat[:, self._torso, 2, 2]
    obs['imu'] = torch.cat([data.sensordata[:, s] for s in self._imu],
                           dim=-1)
    obs['force_torque'] = torch.asinh(torch.cat(
        [data.sensordata[:, s] for s in self._ft], dim=-1))
    return obs


class Move(_QuadrupedTask):
  """Move forward at the desired horizontal speed, staying upright."""

  def __init__(self, model, desired_speed):
    super().__init__(model)
    self._desired_speed = desired_speed

  def initialize_episode(self, model, data, generator):
    """A random orientation at the lowest contact-free height."""
    quat = self._random_orientation(generator, data.qpos.shape[0],
                                    data.qpos.dtype)
    return data.replace(
        qpos=self._find_non_contacting_height(model, data, quat))

  def get_observation(self, model, data):
    return self._common_observations(data)

  def get_reward(self, model, data):
    move_reward = rewards.tolerance(
        data.sensordata[:, self._vel_slice][:, 0],
        bounds=(self._desired_speed, float('inf')),
        margin=self._desired_speed, value_at_margin=0.5, sigmoid='linear')
    return _upright_reward(data, self._torso) * move_reward


class Fetch(_QuadrupedTask):
  """Bring the ball to the target."""

  def __init__(self, model):
    super().__init__(model)
    self._ball_b = self.body_id('ball')
    self._ball_g = self.geom_id('ball')
    self._floor_g = self.geom_id('floor')
    self._target_s = self.site_id('target')
    self._workspace_s = self.site_id('workspace')
    self._ball_q = self.joint_qposadr('ball_root')
    self._ball_v = self.joint_dofadr('ball_root')
    self._root_v = self.joint_dofadr('root')
    self._floor_size = float(model.geom_size[self._floor_g, 0])
    self._ball_radius = float(model.geom_size[self._ball_g, 0])
    self._workspace_radius = float(model.site_size[self._workspace_s, 0])
    self._target_radius = float(model.site_size[self._target_s, 0])

  def initialize_episode(self, model, data, generator):
    """A random azimuth and planar position within 0.9 of the floor's
    half-size at the lowest contact-free height; the ball dropped from
    z = 2 at a random planar position with a normal(0, 5) planar
    velocity."""
    B, dtype = data.qpos.shape[0], data.qpos.dtype
    azimuth = base.uniform(generator, (B,), 0.0, 2 * math.pi, dtype)
    zero = torch.zeros_like(azimuth)
    quat = torch.stack([torch.cos(azimuth / 2), zero, zero,
                        torch.sin(azimuth / 2)], dim=-1)
    spawn = 0.9 * self._floor_size
    xy = base.uniform(generator, (B, 2), -spawn, spawn, dtype)
    qpos = self._find_non_contacting_height(model, data, quat, xy)
    qpos[:, self._ball_q:self._ball_q + 2] = base.uniform(
        generator, (B, 2), -spawn, spawn, dtype)
    qpos[:, self._ball_q + 2] = 2.0
    qvel = data.qvel.clone()
    qvel[:, self._ball_v:self._ball_v + 2] = 5 * torch.randn(
        (B, 2), generator=generator, device=generator.device, dtype=dtype)
    return data.replace(qpos=qpos, qvel=qvel)

  def get_observation(self, model, data):
    obs = self._common_observations(data)
    ball_rel_vel = (data.qvel[:, self._ball_v:self._ball_v + 3] -
                    data.qvel[:, self._root_v:self._root_v + 3])
    ball_state = torch.stack([
        data.xpos[:, self._ball_b] - data.xpos[:, self._torso], ball_rel_vel,
        data.qvel[:, self._ball_v + 3:self._ball_v + 6]], dim=1)
    obs['ball_state'] = torch.einsum(
        'Bki,Bij->Bkj', ball_state, data.xmat[:, self._torso]).reshape(
            data.qpos.shape[0], 9)
    obs['target_position'] = _rel(data, data.site_xpos[:, self._target_s],
                                  self._torso)
    return obs

  def get_reward(self, model, data):
    arena_radius = self._floor_size * math.sqrt(2)
    ball = data.xpos[:, self._ball_b]
    self_to_ball = data.site_xpos[:, self._workspace_s] - ball
    reach_reward = rewards.tolerance(
        torch.linalg.vector_norm(self_to_ball[:, :2], dim=-1),
        bounds=(0, self._workspace_radius + self._ball_radius),
        sigmoid='linear', margin=arena_radius, value_at_margin=0)
    ball_to_target = data.site_xpos[:, self._target_s] - ball
    fetch_reward = rewards.tolerance(
        torch.linalg.vector_norm(ball_to_target[:, :2], dim=-1),
        bounds=(0, self._target_radius), sigmoid='linear',
        margin=arena_radius, value_at_margin=0)
    reach_then_fetch = reach_reward * (0.5 + 0.5 * fetch_reward)
    return _upright_reward(data, self._torso) * reach_then_fetch
