"""Planar manipulator domain (port of dm_control_tpu/suite/manipulator.py),
batched.

A planar arm with a two-finger hand brings a ball or a peg to a target
(bring), or into a receptacle (insert: a cup of capsules for the ball, a
slot of boxes for the peg). The model is manipulator.xml verbatim with the
unused props removed. Each episode draws its env's target pose (x, z and
the angle about y; `body_pos` and `body_quat`), and under insert the
receptacle's, which is the same. The reset rejection-samples the arm's
angles and the prop's placement (in hand, in the target or uniform) until
no contact is active, against each env's own drawn receptacle.
"""

from __future__ import annotations

import collections
import math
from xml.etree import ElementTree as etree

import torch

from dm_control_tpu_torch import models
from dm_control_tpu_torch.models import types
from dm_control_tpu_torch.ops import smooth
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import containers
from dm_control_tpu_torch.utils import rewards

_CLOSE = .01          # (meters) distance below which a thing is "close"
_CONTROL_TIMESTEP = .01
_TIME_LIMIT = 10
_P_IN_HAND = .1       # probability of object-in-hand initial state
_P_IN_TARGET = .1     # probability of object-in-target initial state
_ARM_JOINTS = ('arm_root', 'arm_shoulder', 'arm_elbow', 'arm_wrist',
               'finger', 'fingertip', 'thumb', 'thumbtip')
_ALL_PROPS = frozenset(['ball', 'target_ball', 'cup',
                        'peg', 'target_peg', 'slot'])
_TOUCH_SENSORS = ('palm_touch', 'finger_touch', 'thumb_touch',
                  'fingertip_touch', 'thumbtip_touch')
# rejection-sampling rounds for a contact-free initial state (the JAX
# package's bound)
_MAX_INIT_ROUNDS = 200
SUITE = containers.TaggedTasks()


def make_model(use_peg: bool = False, insert: bool = False) -> str:
  """manipulator.xml with the props this task does not use removed."""
  mjcf = etree.fromstring(common.read_model('manipulator.xml'))
  if use_peg:
    required_props = ['peg', 'target_peg']
    if insert:
      required_props += ['slot']
  else:
    required_props = ['ball', 'target_ball']
    if insert:
      required_props += ['cup']
  for unused in _ALL_PROPS.difference(required_props):
    for parent in mjcf.iter():
      for child in list(parent):
        if child.tag == 'body' and child.get('name') == unused:
          parent.remove(child)
  return etree.tostring(mjcf, encoding='unicode')


def _make_env(use_peg, insert, fully_observable, time_limit, device, dtype):
  model = models.from_xml_string(make_model(use_peg, insert),
                                 assets=common.read_assets(), device=device,
                                 dtype=dtype)
  task = Bring(model, use_peg=use_peg, insert=insert,
               fully_observable=fully_observable)
  return control.Environment(model, task, time_limit=time_limit,
                             control_timestep=_CONTROL_TIMESTEP)


@SUITE.add('benchmarking', 'hard')
def bring_ball(fully_observable=True, time_limit=_TIME_LIMIT, device='cuda',
               dtype=torch.float32):
  """Bring the ball to the target."""
  return _make_env(False, False, fully_observable, time_limit, device, dtype)


@SUITE.add('hard')
def bring_peg(fully_observable=True, time_limit=_TIME_LIMIT, device='cuda',
              dtype=torch.float32):
  """Bring the peg to the target."""
  return _make_env(True, False, fully_observable, time_limit, device, dtype)


@SUITE.add('hard')
def insert_ball(fully_observable=True, time_limit=_TIME_LIMIT, device='cuda',
                dtype=torch.float32):
  """Put the ball into the cup."""
  return _make_env(False, True, fully_observable, time_limit, device, dtype)


@SUITE.add('hard')
def insert_peg(fully_observable=True, time_limit=_TIME_LIMIT, device='cuda',
               dtype=torch.float32):
  """Put the peg into the slot."""
  return _make_env(True, True, fully_observable, time_limit, device, dtype)


def arm_limits(task: base.Task, joints) -> tuple:
  """(lower, upper) of the arm joints' draws: their ranges where limited,
  [-pi, pi) where not."""
  m = task.model
  jids = [m.names.name2id('joint', n) for n in joints]
  limited = torch.tensor([bool(m.jnt_limited[j]) for j in jids],
                         device=m.device)
  rng = m.jnt_range[jids]
  lower = torch.where(limited, rng[:, 0], torch.full_like(rng[:, 0], -math.pi))
  upper = torch.where(limited, rng[:, 1], torch.full_like(rng[:, 1], math.pi))
  return lower, upper


def body_2d_pose(data: types.Data, body, orientation=True) -> torch.Tensor:
  """x, z (and the quaternion's w, y) of a body, or of several: (B, 4) or
  (B, nbodies, 4)."""
  pos = data.xpos[:, body][..., [0, 2]]
  if not orientation:
    return pos
  return torch.cat([pos, data.xquat[:, body][..., [0, 2]]], dim=-1)


class Bring(base.Task):
  """Bring the prop to the target, or put it into the receptacle."""

  def __init__(self, model, use_peg, insert, fully_observable):
    super().__init__(model)
    self._use_peg = use_peg
    self._insert = insert
    self._fully_observable = fully_observable
    obj = 'peg' if use_peg else 'ball'
    self._arm_qadr = [self.joint_qposadr(n) for n in _ARM_JOINTS]
    self._arm_vadr = [self.joint_dofadr(n) for n in _ARM_JOINTS]
    self._obj_qadr = [self.joint_qposadr(f'{obj}_{dim}') for dim in 'xzy']
    self._obj_vadr = [self.joint_dofadr(f'{obj}_{dim}') for dim in 'xzy']
    self._finger_q = self.joint_qposadr('finger')
    self._thumb_q = self.joint_qposadr('thumb')
    self._touch = [self.sensor_slice(n) for n in _TOUCH_SENSORS]
    self._hand_b = self.body_id('hand')
    self._object_b = self.body_id(obj)
    self._target_b = self.body_id('target_peg' if use_peg else 'target_ball')
    # the bodies each episode places: the target, and the receptacle
    self._placed_b = [self._target_b]
    if insert:
      self._placed_b.append(self.body_id('slot' if use_peg else 'cup'))
    self._grasp_s = self.site_id('grasp')
    self._pinch_s = self.site_id('pinch')
    names = (('peg', 'target_peg', 'peg_grasp', 'peg_pinch', 'peg_tip',
              'target_peg_tip') if use_peg else ('ball', 'target_ball'))
    self._sites = {n: self.site_id(n) for n in names}
    self._arm_lower, self._arm_upper = arm_limits(self, _ARM_JOINTS)

  def randomize_model(self, model, n, generator):
    """The target's pose for each of n episodes: x in [-.4, .4), z in
    [.1, .4), the angle about y in [-pi, pi) ([-pi/3, pi/3) under insert,
    where the receptacle takes the same pose)."""
    dtype = model.dtype
    x = base.uniform(generator, (n,), -.4, .4, dtype)
    z = base.uniform(generator, (n,), .1, .4, dtype)
    lim = math.pi / 3 if self._insert else math.pi
    angle = base.uniform(generator, (n,), -lim, lim, dtype)
    zero = torch.zeros_like(angle)
    quat = torch.stack([torch.cos(angle / 2), zero, torch.sin(angle / 2),
                        zero], dim=-1)
    body_pos = model.body_pos.expand((n,) + model.body_pos.shape).clone()
    body_quat = model.body_quat.expand((n,) + model.body_quat.shape).clone()
    for b in self._placed_b:
      body_pos[:, b, 0] = x
      body_pos[:, b, 2] = z
      body_quat[:, b] = quat
    return {'body_pos': body_pos, 'body_quat': body_quat}

  def initialize_episode(self, model, data, generator):
    """Arm angles uniform in their limits (the finger mirroring the
    thumb) and the prop in the hand (p = .1, at the grasp site), in the
    env's target (p = .1) or uniform (x in [-.5, .5), z in [0, .7), any
    angle, an x velocity in [-5, 5)); only the envs that still have a
    contact are redrawn, for at most 200 rounds after the first draw."""
    dtype, nq = data.qpos.dtype, model.nq
    lower, upper = self._arm_lower.to(dtype), self._arm_upper.to(dtype)

    def draw(idx):
      n = len(idx)
      m = model.env_rows(idx)
      qpos = model.qpos0.to(dtype).expand(n, nq).clone()
      qpos[:, self._arm_qadr] = base.uniform(
          generator, (n, len(_ARM_JOINTS)), lower, upper, dtype)
      qpos[:, self._finger_q] = qpos[:, self._thumb_q]
      u = torch.rand((n,), generator=generator, device=generator.device,
                     dtype=dtype)
      in_hand = u < _P_IN_HAND
      in_target = ~in_hand & (u < _P_IN_HAND + _P_IN_TARGET)
      # the grasp site after the arm's FK
      d = smooth.kinematics(m, types.make_data(m, n, dtype=dtype).replace(
          qpos=qpos))
      grasp = d.site_xpos[:, self._grasp_s]
      gmat = d.site_xmat[:, self._grasp_s]
      hand_angle = math.pi - torch.atan2(gmat[:, 2, 0], gmat[:, 0, 0])
      tb = self._target_b
      target_x = m.body_pos[..., tb, 0].expand(n)
      target_z = m.body_pos[..., tb, 2].expand(n)
      target_angle = 2 * torch.atan2(m.body_quat[..., tb, 2],
                                     m.body_quat[..., tb, 0]).expand(n)
      ux = base.uniform(generator, (n,), -.5, .5, dtype)
      uz = base.uniform(generator, (n,), 0., .7, dtype)
      ua = base.uniform(generator, (n,), 0., 2 * math.pi, dtype)
      pick = lambda h, t, uni: torch.where(
          in_hand, h, torch.where(in_target, t, uni))
      qpos[:, self._obj_qadr] = torch.stack(
          [pick(grasp[:, 0], target_x, ux), pick(grasp[:, 2], target_z, uz),
           pick(hand_angle, target_angle, ua)], dim=-1)
      qvel = torch.zeros((n, model.nv), dtype=dtype, device=qpos.device)
      uv = base.uniform(generator, (n,), -5., 5., dtype)
      qvel[:, self._obj_vadr[0]] = torch.where(
          in_hand | in_target, torch.zeros_like(uv), uv)
      return torch.cat([qpos, qvel], dim=-1)

    rows = base.contact_free_qpos(model, data.qpos.shape[0], draw,
                                  _MAX_INIT_ROUNDS)
    return data.replace(qpos=rows[:, :nq], qvel=rows[:, nq:])

  def get_observation(self, model, data):
    obs = collections.OrderedDict()
    arm_q = data.qpos[:, self._arm_qadr]
    obs['arm_pos'] = torch.stack([torch.sin(arm_q), torch.cos(arm_q)],
                                 dim=-1)
    obs['arm_vel'] = data.qvel[:, self._arm_vadr]
    obs['touch'] = torch.log1p(torch.cat(
        [data.sensordata[:, s] for s in self._touch], dim=-1))
    if self._fully_observable:
      obs['hand_pos'] = body_2d_pose(data, self._hand_b)
      obs['object_pos'] = body_2d_pose(data, self._object_b)
      obs['object_vel'] = data.qvel[:, self._obj_vadr]
      obs['target_pos'] = body_2d_pose(data, self._target_b)
    return obs

  def _close(self, data, s1, s2):
    distance = torch.linalg.vector_norm(
        data.site_xpos[:, s1] - data.site_xpos[:, s2], dim=-1)
    return rewards.tolerance(distance, (0, _CLOSE), _CLOSE * 2)

  def get_reward(self, model, data):
    s = self._sites
    if not self._use_peg:
      return self._close(data, s['ball'], s['target_ball'])
    grasping = (self._close(data, s['peg_grasp'], self._grasp_s) +
                self._close(data, s['peg_pinch'], self._pinch_s)) / 2
    bringing = (self._close(data, s['peg'], s['target_peg']) +
                self._close(data, s['target_peg_tip'], s['peg_tip'])) / 2
    return torch.maximum(bringing, grasping / 3)
