"""Cartpole domain (port of dm_control_tpu/suite/cartpole.py), batched."""

from __future__ import annotations

import collections
import math
from xml.etree import ElementTree as etree

import torch

from dm_control_tpu_torch import models
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import containers
from dm_control_tpu_torch.utils import rewards

_DEFAULT_TIME_LIMIT = 10
SUITE = containers.TaggedTasks()


def make_model(n_poles: int = 1) -> str:
  """The reference model asset (suite/assets/cartpole.xml), with extra
  poles chained procedurally below the first."""
  xml_string = common.read_model('cartpole.xml')
  if n_poles == 1:
    return xml_string
  mjcf = etree.fromstring(xml_string)
  parent = mjcf.find('./worldbody/body/body')   # first pole
  for pole_index in range(2, n_poles + 1):
    child = etree.Element('body', name=f'pole_{pole_index}',
                          pos='0 0 1', childclass='pole')
    etree.SubElement(child, 'joint', name=f'hinge_{pole_index}')
    etree.SubElement(child, 'geom', name=f'pole_{pole_index}')
    parent.append(child)
    parent = child
  # lower the floor and pull the cameras back to fit the longer pole
  floor = mjcf.find('./worldbody/geom')
  floor.set('pos', '0 0 {}'.format(1 - n_poles - .05))
  cameras = mjcf.findall('./worldbody/camera')
  cameras[0].set('pos', '0 {} 1'.format(-1 - 2 * n_poles))
  cameras[1].set('pos', '0 {} 2'.format(-2 * n_poles))
  return etree.tostring(mjcf, encoding='unicode')


def _make_env(swing_up, sparse, n_poles, time_limit, device, dtype):
  model = models.from_xml_string(make_model(n_poles),
                                 assets=common.read_assets(), device=device,
                                 dtype=dtype)
  task = Balance(model, swing_up=swing_up, sparse=sparse)
  return control.Environment(model, task, time_limit=time_limit)


@SUITE.add('benchmarking')
def balance(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
            dtype=torch.float32):
  return _make_env(False, False, 1, time_limit, device, dtype)


@SUITE.add('benchmarking')
def balance_sparse(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
                   dtype=torch.float32):
  return _make_env(False, True, 1, time_limit, device, dtype)


@SUITE.add('benchmarking')
def swingup(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
            dtype=torch.float32):
  return _make_env(True, False, 1, time_limit, device, dtype)


@SUITE.add('benchmarking')
def swingup_sparse(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
                   dtype=torch.float32):
  return _make_env(True, True, 1, time_limit, device, dtype)


@SUITE.add()
def two_poles(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
              dtype=torch.float32):
  return _make_env(True, False, 2, time_limit, device, dtype)


@SUITE.add()
def three_poles(time_limit=_DEFAULT_TIME_LIMIT, device='cuda',
                dtype=torch.float32):
  return _make_env(True, False, 3, time_limit, device, dtype)


class Balance(base.Task):
  """Balance or swing up the pole(s) on a cart."""

  _CART_RANGE = (-.25, .25)
  _ANGLE_COSINE_RANGE = (.995, 1)

  def __init__(self, model, swing_up: bool, sparse: bool):
    super().__init__(model)
    self._sparse = sparse
    self._swing_up = swing_up
    self._slider_q = self.joint_qposadr('slider')
    # the poles are every body from index 2 on (world 0, cart 1)
    self._poles = list(range(2, model.nbody))

  def initialize_episode(self, model, data, generator):
    B, nv, dtype = data.qpos.shape[0], model.nv, data.qpos.dtype
    randn = lambda *shape: torch.randn((B,) + shape, generator=generator,
                                       device=generator.device, dtype=dtype)
    qpos = data.qpos.clone()
    if self._swing_up:
      qpos[:, 0] = .01 * randn()
      qpos[:, 1] = math.pi + .01 * randn()
      qpos[:, 2:] = .1 * randn(nv - 2)
    else:
      qpos[:, 0] = base.uniform(generator, (B,), -.1, .1, dtype)
      qpos[:, 1:] = base.uniform(generator, (B, nv - 1), -.034, .034, dtype)
    return data.replace(qpos=qpos, qvel=.01 * randn(nv))

  def _pole_angle_cosine(self, data):
    return data.xmat[:, self._poles, 2, 2]

  def get_observation(self, model, data):
    obs = collections.OrderedDict()
    # (zz, xz) of each pole's frame, pole by pole
    zz_xz = data.xmat[:, self._poles][:, :, [2, 0], 2]
    obs['position'] = torch.cat(
        [data.qpos[:, self._slider_q:self._slider_q + 1],
         zz_xz.reshape(zz_xz.shape[0], -1)], dim=-1)
    obs['velocity'] = data.qvel
    return obs

  def get_reward(self, model, data):
    cart_position = data.qpos[:, self._slider_q]
    if self._sparse:
      cart_in_bounds = rewards.tolerance(cart_position, self._CART_RANGE)
      angle_in_bounds = torch.prod(rewards.tolerance(
          self._pole_angle_cosine(data), self._ANGLE_COSINE_RANGE), dim=-1)
      return cart_in_bounds * angle_in_bounds
    upright = (self._pole_angle_cosine(data) + 1) / 2
    centered = (1 + rewards.tolerance(cart_position, margin=2)) / 2
    small_control = rewards.tolerance(
        data.ctrl, margin=1, value_at_margin=0, sigmoid='quadratic')[:, 0]
    small_control = (4 + small_control) / 5
    small_velocity = torch.amin(
        rewards.tolerance(data.qvel[:, 1:], margin=5), dim=-1)
    small_velocity = (1 + small_velocity) / 2
    return upright.mean(dim=-1) * small_control * small_velocity * centered
