"""LQR domain (port of dm_control_tpu/suite/lqr.py), batched.

Chains of masses on sliders with springs and a quadratic reward. The
chain is added to the asset procedurally from a numpy RandomState, so
one seed gives the same model string as the reference.
"""

from __future__ import annotations

import collections
import math
from xml.etree import ElementTree as etree

import numpy as np
import torch

from dm_control_tpu_torch import models
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import containers

_DEFAULT_TIME_LIMIT = float('inf')
_CONTROL_COST_COEF = 0.1
SUITE = containers.TaggedTasks()


def make_model(n_bodies: int, n_actuators: int,
               rng: np.random.RandomState,
               stiffness_range=(15, 25), damping_range=(0, 0)) -> str:
  """The model asset (suite/assets/lqr.xml) with a chain of n_bodies
  masses on sliders, the first n_actuators of them actuated, and joint
  stiffness and damping drawn from `rng`."""
  if n_bodies < 1 or n_actuators < 1:
    raise ValueError('at least 1 body and 1 actuator required')
  if n_actuators > n_bodies:
    raise ValueError('at most 1 actuator per body')

  mjcf = etree.fromstring(common.read_model('lqr.xml'))
  parent = mjcf.find('./worldbody')
  actuator = etree.SubElement(mjcf, 'actuator')
  tendon = etree.SubElement(mjcf, 'tendon')

  for body in range(n_bodies):
    child = etree.Element('body', name=f'body_{body}', pos='.25 0 0')
    joint = etree.SubElement(child, 'joint', name=f'joint_{body}')
    child.append(etree.Element('geom', name=f'geom_{body}'))
    joint.set('stiffness', str(rng.uniform(*stiffness_range)))
    joint.set('damping', str(rng.uniform(*damping_range)))
    site_name = f'site_{body}'
    child.append(etree.Element('site', name=site_name))
    if body == 0:
      child.set('pos', '.25 0 .1')
    if body < n_actuators:
      actuator.append(etree.Element('motor', name=f'motor_{body}',
                                    joint=f'joint_{body}'))
    if body < n_bodies - 1:
      # a tendon between consecutive bodies, for visualization only
      spatial = etree.SubElement(tendon, 'spatial', name=f'tendon_{body}')
      spatial.append(etree.Element('site', site=site_name))
      spatial.append(etree.Element('site', site=f'site_{body + 1}'))
    parent.append(child)
    parent = child

  return etree.tostring(mjcf, encoding='unicode')


def _make_lqr(n_bodies, n_actuators, time_limit, random, device, dtype):
  """random: a RandomState or a seed for one (None: an unseeded one, so
  each call draws other stiffnesses, as in the reference)."""
  rng = (random if isinstance(random, np.random.RandomState)
         else np.random.RandomState(random))
  model = models.from_xml_string(make_model(n_bodies, n_actuators, rng),
                                 assets=common.read_assets(), device=device,
                                 dtype=dtype)
  return control.Environment(model, LQRLevel(model, _CONTROL_COST_COEF),
                             time_limit=time_limit)


@SUITE.add()
def lqr_2_1(time_limit=_DEFAULT_TIME_LIMIT, random=None, device='cuda',
            dtype=torch.float32):
  """2 bodies, the first actuated."""
  return _make_lqr(2, 1, time_limit, random, device, dtype)


@SUITE.add()
def lqr_6_2(time_limit=_DEFAULT_TIME_LIMIT, random=None, device='cuda',
            dtype=torch.float32):
  """6 bodies, the first two actuated."""
  return _make_lqr(6, 2, time_limit, random, device, dtype)


class LQRLevel(base.Task):
  """Quadratic state and control cost; terminates near the origin."""

  _TERMINAL_TOL = 1e-6

  def __init__(self, model, control_cost_coef):
    if control_cost_coef <= 0:
      raise ValueError('control_cost_coef must be positive.')
    super().__init__(model)
    self._control_cost_coef = control_cost_coef

  @property
  def control_cost_coef(self):
    return self._control_cost_coef

  def initialize_episode(self, model, data, generator):
    """qpos uniform on the sphere of radius sqrt(2)."""
    unit = torch.randn(data.qpos.shape, generator=generator,
                       device=generator.device, dtype=data.qpos.dtype)
    unit = unit / torch.linalg.vector_norm(unit, dim=-1, keepdim=True)
    return data.replace(qpos=math.sqrt(2.0) * unit)

  def get_observation(self, model, data):
    obs = collections.OrderedDict()
    obs['position'] = data.qpos
    obs['velocity'] = data.qvel
    return obs

  def get_reward(self, model, data):
    state_cost = 0.5 * torch.sum(data.qpos * data.qpos, dim=-1)
    control_cost = 0.5 * torch.sum(data.ctrl * data.ctrl, dim=-1)
    return 1 - (state_cost + control_cost * self._control_cost_coef)

  def get_termination(self, model, data):
    state_norm = torch.sqrt(torch.sum(data.qpos * data.qpos, dim=-1) +
                            torch.sum(data.qvel * data.qvel, dim=-1))
    return state_norm < self._TERMINAL_TOL
