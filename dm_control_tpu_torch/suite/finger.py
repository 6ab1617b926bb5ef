"""Finger domain (port of dm_control_tpu/suite/finger.py), batched.

A two-link planar finger and a free-spinning body on a hinge with dry
friction (`frictionloss`), with elliptic friction cones (nv 3). spin:
turn the body fast (the model's hinge damping lowered to .03). turn_easy
and turn_hard: bring the body's tip into a target on the hinge's circle;
each episode draws the target for its env (`site_pos` of the target
site), at an angle uniform in [-pi, pi). Every observation is a function
of the sensors.
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

_DEFAULT_TIME_LIMIT = 20
_CONTROL_TIMESTEP = .02
_EASY_TARGET_SIZE = 0.07
_HARD_TARGET_SIZE = 0.03
_SPIN_VELOCITY = 15.0
# rejection-sampling rounds for a contact-free initial pose
_MAX_INIT_ROUNDS = 64
SUITE = containers.TaggedTasks()


def make_model() -> str:
  """The reference model asset, verbatim (suite/assets/finger.xml)."""
  return common.read_model('finger.xml')


def _load(device, dtype):
  return models.from_xml_string(make_model(), assets=common.read_assets(),
                                device=device, dtype=dtype)


@SUITE.add('benchmarking')
def spin(time_limit=_DEFAULT_TIME_LIMIT, device='cuda', dtype=torch.float32):
  """The Spin task."""
  model = _load(device, dtype)
  # the spin variant lowers the hinge's damping (reference finger.py)
  damping = model.dof_damping.clone()
  damping[model.jnt_dofadr[model.names.name2id('joint', 'hinge')]] = .03
  model = model.replace(dof_damping=damping)
  return control.Environment(model, Spin(model), time_limit=time_limit,
                             control_timestep=_CONTROL_TIMESTEP)


@SUITE.add('benchmarking')
def turn_easy(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
              dtype=torch.float32):
  """The Turn task with a large target."""
  return _turn(_EASY_TARGET_SIZE, time_limit, device, dtype)


@SUITE.add('benchmarking')
def turn_hard(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
              dtype=torch.float32):
  """The Turn task with a small target."""
  return _turn(_HARD_TARGET_SIZE, time_limit, device, dtype)


def _turn(target_radius, time_limit, device, dtype):
  model = _load(device, dtype)
  # the task's target size is baked into the model
  size = model.site_size.clone()
  size[model.names.name2id('site', 'target'), 0] = target_radius
  model = model.replace(site_size=size)
  return control.Environment(model, Turn(model), time_limit=time_limit,
                             control_timestep=_CONTROL_TIMESTEP)


class _FingerTask(base.Task):

  def __init__(self, model):
    super().__init__(model)
    ss = self.sensor_slice
    self._s_pos = [ss('proximal'), ss('distal')]
    self._s_vel = [ss('proximal_velocity'), ss('distal_velocity'),
                   ss('hinge_velocity')]
    self._s_tip = ss('tip')
    self._s_target = ss('target')
    self._s_spinner = ss('spinner')
    self._s_touch = [ss('touchtop'), ss('touchbottom')]
    self._target_site = self.site_id('target')

  def initialize_episode(self, model, data, generator):
    """Rejection-sample contact-free joint angles: only the envs that
    still have contacts are redrawn, for at most 64 rounds after the first
    draw. The contacts are those of the compiled model: a drawn target
    site moves no geom."""
    qpos = base.contact_free_qpos(
        self.model, data.qpos.shape[0],
        lambda idx: base.random_limited_qpos(
            self.model, len(idx), generator).to(data.qpos.dtype),
        _MAX_INIT_ROUNDS)
    return data.replace(qpos=qpos)

  # the observations read the sensors only, as the reference's do
  def _xz(self, data, sl):
    v = data.sensordata[:, sl]
    return torch.stack([v[:, 0], v[:, 2]], dim=-1)

  def _tip_position(self, data):
    return self._xz(data, self._s_tip) - self._xz(data, self._s_spinner)

  def _target_position(self, data):
    return self._xz(data, self._s_target) - self._xz(data, self._s_spinner)

  def _dist_to_target(self, model, data):
    to_target = self._target_position(data) - self._tip_position(data)
    return (torch.linalg.vector_norm(to_target, dim=-1) -
            model.site_size[self._target_site, 0])

  def _base_obs(self, data):
    s = data.sensordata
    obs = collections.OrderedDict()
    obs['position'] = torch.cat([s[:, self._s_pos[0]], s[:, self._s_pos[1]],
                                 self._tip_position(data)], dim=-1)
    obs['velocity'] = torch.cat([s[:, sl] for sl in self._s_vel], dim=-1)
    obs['touch'] = torch.log1p(torch.cat([s[:, sl] for sl in self._s_touch],
                                         dim=-1))
    return obs


class Spin(_FingerTask):
  """Spin the body counter-clockwise."""

  def get_observation(self, model, data):
    return self._base_obs(data)

  def get_reward(self, model, data):
    hinge_vel = data.sensordata[:, self._s_vel[2]][:, 0]
    return (hinge_vel <= -_SPIN_VELOCITY).to(data.qpos.dtype)


class Turn(_FingerTask):
  """Turn the body until its tip is inside the target."""

  def __init__(self, model):
    super().__init__(model)
    hinge = model.names.name2id('joint', 'hinge')
    # the hinge's anchor is static: the spinner body's pos + the joint's
    anchor = (model.body_pos[model.jnt_bodyid[hinge]] + model.jnt_pos[hinge])
    self._anchor_x, self._anchor_z = float(anchor[0]), float(anchor[2])
    self._spinner_radius = float(model.geom_size[self.geom_id('cap1')].sum())

  def randomize_model(self, model, n, generator):
    angle = base.uniform(generator, (n,), -math.pi, math.pi, model.dtype)
    site_pos = model.site_pos.expand((n,) + model.site_pos.shape).clone()
    site_pos[:, self._target_site, 0] = (
        self._anchor_x + self._spinner_radius * torch.sin(angle))
    site_pos[:, self._target_site, 2] = (
        self._anchor_z + self._spinner_radius * torch.cos(angle))
    return {'site_pos': site_pos}

  def get_observation(self, model, data):
    obs = self._base_obs(data)
    obs['target_position'] = self._target_position(data)
    obs['dist_to_target'] = self._dist_to_target(model, data)
    return obs

  def get_reward(self, model, data):
    return (self._dist_to_target(model, data) <= 0).to(data.qpos.dtype)
