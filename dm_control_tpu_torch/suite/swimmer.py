"""Swimmer domain (port of dm_control_tpu/suite/swimmer.py), batched.

An n-link swimmer built procedurally from suite/assets/swimmer.xml; the
medium's drag (option density 3000) moves it. Each episode places the
target for its env (`geom_pos` of the target geom): with probability 0.2
in the box [-.3, .3)^2, else in [-2, 2)^2.
"""

from __future__ import annotations

import collections
from xml.etree import ElementTree as etree

import torch

from dm_control_tpu_torch import models
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import containers
from dm_control_tpu_torch.utils import rewards

_DEFAULT_TIME_LIMIT = 30
_CONTROL_TIMESTEP = .03
SUITE = containers.TaggedTasks()


def make_model(n_bodies: int) -> str:
  """swimmer.xml with the body chain, its actuators and its sensors added
  (the reference's `make_model`, the same string)."""
  if n_bodies < 3:
    raise ValueError(f'at least 3 bodies required, got {n_bodies}')
  mjcf = etree.fromstring(common.read_model('swimmer.xml'))
  head_body = mjcf.find('./worldbody/body')
  actuator = etree.SubElement(mjcf, 'actuator')
  sensor = etree.SubElement(mjcf, 'sensor')

  parent = head_body
  for body_index in range(n_bodies - 1):
    site_name = f'site_{body_index}'
    child = etree.Element('body', name=f'segment_{body_index}',
                          pos='0 .1 0')
    etree.SubElement(child, 'geom', {'class': 'visual',
                                     'name': f'visual_{body_index}'})
    etree.SubElement(child, 'geom', {'class': 'inertial',
                                     'name': f'inertial_{body_index}'})
    child.append(etree.Element('site', name=site_name))
    joint_name = f'joint_{body_index}'
    joint_limit = 360.0 / n_bodies
    child.append(etree.Element(
        'joint', {'name': joint_name,
                  'range': f'{-joint_limit} {joint_limit}'}))
    actuator.append(etree.Element('motor', name=f'motor_{body_index}',
                                  joint=joint_name))
    sensor.append(etree.Element(
        'velocimeter', name=f'velocimeter_{body_index}', site=site_name))
    sensor.append(etree.Element(
        'gyro', name=f'gyro_{body_index}', site=site_name))
    parent.append(child)
    parent = child

  # the tracking cameras move out with the swimmer's length
  cameras = mjcf.findall('./worldbody/body/camera')
  scale = n_bodies / 6.0
  for cam in cameras:
    if cam.get('mode') == 'trackcom':
      old_pos = cam.get('pos').split(' ')
      cam.set('pos', ' '.join(str(float(dim) * scale)
                              for dim in old_pos))
  return etree.tostring(mjcf, encoding='unicode')


@SUITE.add('benchmarking')
def swimmer6(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
             dtype=torch.float32):
  """A 6-link swimmer."""
  return swimmer(6, time_limit, device, dtype)


@SUITE.add('benchmarking')
def swimmer15(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
              dtype=torch.float32):
  """A 15-link swimmer."""
  return swimmer(15, time_limit, device, dtype)


def swimmer(n_links=3, time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
            dtype=torch.float32):
  """A swimmer of n links."""
  model = models.from_xml_string(make_model(n_links),
                                 assets=common.read_assets(), device=device,
                                 dtype=dtype)
  return control.Environment(model, Swimmer(model), time_limit=time_limit,
                             control_timestep=_CONTROL_TIMESTEP)


class Swimmer(base.Task):
  """Swim to the target."""

  def __init__(self, model):
    super().__init__(model)
    self._head = self.body_id('head')
    self._nose = self.geom_id('nose')
    self._target = self.geom_id('target')
    self._target_size = float(model.geom_size[self._target, 0])

  def randomize_model(self, model, n, generator):
    dtype = model.dtype
    close = base.uniform(generator, (n,), 0.0, 1.0, dtype) < 0.2
    box = torch.where(close, 0.3, 2.0).to(dtype)
    xy = base.uniform(generator, (n, 2), -1.0, 1.0, dtype) * box[:, None]
    geom_pos = model.geom_pos.expand((n,) + model.geom_pos.shape).clone()
    geom_pos[:, self._target, 0:2] = xy
    return {'geom_pos': geom_pos}

  def initialize_episode(self, model, data, generator):
    qpos = base.random_limited_qpos(model, data.qpos.shape[0], generator)
    return data.replace(qpos=qpos.to(data.qpos.dtype))

  def _nose_to_target(self, data):
    """The target in the head's frame, x and y."""
    dif = data.geom_xpos[:, self._target] - data.geom_xpos[:, self._nose]
    return torch.einsum('Bi,Bij->Bj', dif, data.xmat[:, self._head])[:, :2]

  def get_observation(self, model, data):
    obs = collections.OrderedDict()
    obs['joints'] = data.qpos[:, 3:]
    obs['to_target'] = self._nose_to_target(data)
    # each segment's local velocities vx, vy, wz (velocimeter, gyro); the
    # first 12 entries are the frame sensors
    xvel = data.sensordata[:, 12:].reshape(data.qpos.shape[0], -1, 6)
    obs['body_velocities'] = xvel[:, :, [0, 1, 5]].flatten(1)
    return obs

  def get_reward(self, model, data):
    dist = torch.linalg.vector_norm(self._nose_to_target(data), dim=-1)
    return rewards.tolerance(dist, bounds=(0, self._target_size),
                             margin=5 * self._target_size,
                             sigmoid='long_tail')
