"""Planar stacker domain (port of dm_control_tpu/suite/stacker.py),
batched.

The manipulator's planar arm stacks 2 or 4 boxes (free in x, z and the
angle about y; the slides carry `ref`, so their qpos is the world
coordinate) on a target. The model is stacker.xml verbatim with the unused
boxes removed. Each episode draws its env's target (`body_pos`): x in
[-.37, .37) and the height of one of the stack's levels. The reset
rejection-samples the arm's angles and the boxes' poses until no contact
is active.
"""

from __future__ import annotations

import collections
import math
from xml.etree import ElementTree as etree

import torch

from dm_control_tpu_torch import models
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.suite.manipulator import arm_limits
from dm_control_tpu_torch.suite.manipulator import body_2d_pose
from dm_control_tpu_torch.utils import containers
from dm_control_tpu_torch.utils import rewards

_CLOSE = .01
_CONTROL_TIMESTEP = .01
_TIME_LIMIT = 10
_ARM_JOINTS = ('arm_root', 'arm_shoulder', 'arm_elbow', 'arm_wrist',
               'finger', 'fingertip', 'thumb', 'thumbtip')
# rejection-sampling rounds for a contact-free initial state (the JAX
# package's bound)
_MAX_INIT_ROUNDS = 200
SUITE = containers.TaggedTasks()


def make_model(n_boxes: int = 2) -> str:
  """stacker.xml with the boxes past the first n_boxes removed."""
  mjcf = etree.fromstring(common.read_model('stacker.xml'))
  for b in range(n_boxes, 4):
    name = f'box{b}'
    for parent in mjcf.iter():
      for child in list(parent):
        if child.tag == 'body' and child.get('name') == name:
          parent.remove(child)
  return etree.tostring(mjcf, encoding='unicode')


def _make_env(n_boxes, fully_observable, time_limit, device, dtype):
  model = models.from_xml_string(make_model(n_boxes),
                                 assets=common.read_assets(), device=device,
                                 dtype=dtype)
  task = Stack(model, n_boxes=n_boxes, fully_observable=fully_observable)
  return control.Environment(model, task, time_limit=time_limit,
                             control_timestep=_CONTROL_TIMESTEP)


@SUITE.add('hard')
def stack_2(fully_observable=True, time_limit=_TIME_LIMIT, device='cuda',
            dtype=torch.float32):
  """Stack 2 boxes."""
  return _make_env(2, fully_observable, time_limit, device, dtype)


@SUITE.add('hard')
def stack_4(fully_observable=True, time_limit=_TIME_LIMIT, device='cuda',
            dtype=torch.float32):
  """Stack 4 boxes."""
  return _make_env(4, fully_observable, time_limit, device, dtype)


class Stack(base.Task):
  """Bring a box to the target, with the hand away from it."""

  def __init__(self, model, n_boxes, fully_observable):
    super().__init__(model)
    self._n_boxes = n_boxes
    self._fully_observable = fully_observable
    boxes = [f'box{b}' for b in range(n_boxes)]
    self._arm_qadr = [self.joint_qposadr(n) for n in _ARM_JOINTS]
    self._arm_vadr = [self.joint_dofadr(n) for n in _ARM_JOINTS]
    self._finger_q = self.joint_qposadr('finger')
    self._thumb_q = self.joint_qposadr('thumb')
    self._box_qx = [self.joint_qposadr(f'{n}_x') for n in boxes]
    self._box_qz = [self.joint_qposadr(f'{n}_z') for n in boxes]
    self._box_qy = [self.joint_qposadr(f'{n}_y') for n in boxes]
    self._box_vadr = [self.joint_dofadr(f'{n}_{dim}') for n in boxes
                      for dim in 'xyz']
    self._box_b = [self.body_id(n) for n in boxes]
    self._box_s = [self.site_id(n) for n in boxes]
    self._hand_b = self.body_id('hand')
    self._target_b = self.body_id('target')
    self._target_s = self.site_id('target')
    self._grasp_s = self.site_id('grasp')
    self._box_size = float(model.geom_size[self.geom_id('target'), 0])
    self._arm_lower, self._arm_upper = arm_limits(self, _ARM_JOINTS)

  def randomize_model(self, model, n, generator):
    """The target for each of n episodes: x in [-.37, .37), at the height
    of level 0, 1, ... n_boxes - 1 of a stack (each as likely)."""
    level = torch.randint(0, self._n_boxes, (n,), generator=generator,
                          device=generator.device)
    body_pos = model.body_pos.expand((n,) + model.body_pos.shape).clone()
    body_pos[:, self._target_b, 2] = self._box_size * (2 * level + 1).to(
        model.dtype)
    body_pos[:, self._target_b, 0] = base.uniform(generator, (n,), -.37, .37,
                                                  model.dtype)
    return {'body_pos': body_pos}

  def initialize_episode(self, model, data, generator):
    """Arm angles uniform in their limits (the finger mirroring the
    thumb); each box at x in [.1, .3), z in [0, .7), any angle, at rest;
    only the envs that still have a contact are redrawn, for at most 200
    rounds after the first draw."""
    dtype, nq, nb = data.qpos.dtype, model.nq, self._n_boxes
    lower, upper = self._arm_lower.to(dtype), self._arm_upper.to(dtype)

    def draw(idx):
      n = len(idx)
      qpos = model.qpos0.to(dtype).expand(n, nq).clone()
      qpos[:, self._arm_qadr] = base.uniform(
          generator, (n, len(_ARM_JOINTS)), lower, upper, dtype)
      qpos[:, self._finger_q] = qpos[:, self._thumb_q]
      qpos[:, self._box_qx] = base.uniform(generator, (n, nb), .1, .3, dtype)
      qpos[:, self._box_qz] = base.uniform(generator, (n, nb), 0., .7, dtype)
      qpos[:, self._box_qy] = base.uniform(generator, (n, nb), 0.,
                                           2 * math.pi, dtype)
      return qpos

    qpos = base.contact_free_qpos(model, data.qpos.shape[0], draw,
                                  _MAX_INIT_ROUNDS)
    return data.replace(qpos=qpos, qvel=torch.zeros_like(data.qvel))

  def get_observation(self, model, data):
    obs = collections.OrderedDict()
    arm_q = data.qpos[:, self._arm_qadr]
    obs['arm_pos'] = torch.stack([torch.sin(arm_q), torch.cos(arm_q)],
                                 dim=-1)
    obs['arm_vel'] = data.qvel[:, self._arm_vadr]
    obs['touch'] = torch.log1p(data.sensordata)
    if self._fully_observable:
      obs['hand_pos'] = body_2d_pose(data, self._hand_b)
      obs['box_pos'] = body_2d_pose(data, self._box_b)
      obs['box_vel'] = data.qvel[:, self._box_vadr]
      obs['target_pos'] = body_2d_pose(data, self._target_b,
                                       orientation=False)
    return obs

  def get_reward(self, model, data):
    target = data.site_xpos[:, self._target_s]
    dists = torch.linalg.vector_norm(
        data.site_xpos[:, self._box_s] - target[:, None], dim=-1)
    box_is_close = rewards.tolerance(dists.amin(dim=-1),
                                     margin=2 * self._box_size)
    hand_to_target = torch.linalg.vector_norm(
        data.site_xpos[:, self._grasp_s] - target, dim=-1)
    hand_is_far = rewards.tolerance(hand_to_target, bounds=(.1, math.inf),
                                    margin=_CLOSE)
    return box_is_close * hand_is_far
