"""Base class and helpers for suite tasks (port of dm_control_tpu/suite/base.py).

Random draws come from an explicitly seeded torch.Generator on the
model's device and cover the whole batch at once.
"""

from __future__ import annotations

import math

import torch

from dm_control_tpu_torch.models import constants
from dm_control_tpu_torch.models import types
from dm_control_tpu_torch.ops import collision as coll_ops
from dm_control_tpu_torch.ops import smooth
from dm_control_tpu_torch.rl import control


class Task(control.Task):
  """Suite task base: keeps the model around for name lookups."""

  def __init__(self, model: types.Model):
    self._model = model
    self.visualize_reward = False

  @property
  def model(self) -> types.Model:
    return self._model

  def body_id(self, name: str) -> int:
    return self._model.names.name2id('body', name)

  def joint_qposadr(self, name: str) -> int:
    return self._model.jnt_qposadr[self._model.names.name2id('joint', name)]

  def joint_dofadr(self, name: str) -> int:
    return self._model.jnt_dofadr[self._model.names.name2id('joint', name)]

  def geom_id(self, name: str) -> int:
    return self._model.names.name2id('geom', name)

  def site_id(self, name: str) -> int:
    return self._model.names.name2id('site', name)

  def sensor_slice(self, name: str) -> slice:
    s = self._model.names.name2id('sensor', name)
    adr = self._model.sensor_adr[s]
    return slice(adr, adr + self._model.sensor_dim[s])


def uniform(gen: torch.Generator, shape, lo, hi, dtype):
  """Uniform draws in [lo, hi) from `gen`, on its device."""
  u = torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)
  return lo + (hi - lo) * u


def _unit(q: torch.Tensor) -> torch.Tensor:
  return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                         min=1e-12)


def random_limited_qpos(model: types.Model, batch: int,
                        gen: torch.Generator) -> torch.Tensor:
  """Random positions for limited and rotational joints, (batch, nq).

  Limited hinge/slide joints are uniform in range, unlimited hinges
  uniform in [-pi, pi), unlimited ball joints uniform on the unit
  3-sphere, limited ball joints a random axis with an angle uniform in
  [0, range max], and free joints a random unit quaternion from rand(4)
  (the reference keeps this rand-not-randn quirk) with the linear part
  left at qpos0.
  """
  dtype = model.dtype
  qpos = model.qpos0.expand(batch, model.nq).clone()
  for j in range(model.njnt):
    jt = model.jnt_type[j]
    adr = model.jnt_qposadr[j]
    limited = bool(model.jnt_limited[j])
    if jt == constants.JointType.HINGE or (
        jt == constants.JointType.SLIDE and limited):
      if limited:
        lo, hi = model.jnt_range[j, 0], model.jnt_range[j, 1]
      else:
        lo, hi = -math.pi, math.pi
      qpos[:, adr] = uniform(gen, (batch,), lo, hi, dtype)
    elif jt == constants.JointType.BALL:
      if limited:
        axis = _unit(torch.randn((batch, 3), generator=gen,
                                 device=gen.device, dtype=dtype))
        angle = uniform(gen, (batch,), 0.0, model.jnt_range[j, 1], dtype)
        q = torch.cat([torch.cos(0.5 * angle)[:, None],
                       torch.sin(0.5 * angle)[:, None] * axis], dim=-1)
      else:
        q = _unit(torch.randn((batch, 4), generator=gen, device=gen.device,
                              dtype=dtype))
      qpos[:, adr:adr + 4] = q
    elif jt == constants.JointType.FREE:
      qpos[:, adr + 3:adr + 7] = _unit(
          torch.rand((batch, 4), generator=gen, device=gen.device,
                     dtype=dtype))
  return qpos


def random_limited_qpos_only_limited(model: types.Model, batch: int,
                                     gen: torch.Generator) -> torch.Tensor:
  """qpos0 with only the limited hinge and slide joints drawn uniformly
  in range, (batch, nq) (the cheetah initializer)."""
  qpos = model.qpos0.expand(batch, model.nq).clone()
  for j in range(model.njnt):
    if model.jnt_limited[j] and model.jnt_type[j] in (
        constants.JointType.HINGE, constants.JointType.SLIDE):
      qpos[:, model.jnt_qposadr[j]] = uniform(
          gen, (batch,), model.jnt_range[j, 0], model.jnt_range[j, 1],
          model.dtype)
  return qpos


def contact_free_qpos(model: types.Model, batch: int, draw,
                      max_rounds: int) -> torch.Tensor:
  """Rejection sampling of contact-free poses, (batch, nq + c).

  `draw(idx)` returns a candidate row for each env of `idx` ((n,) env
  indices): its qpos, then any c further values drawn with it (a
  velocity, say). Each env's contacts are those of its own rows of the
  model's per-env leaves (`Model.env_rows`): a drawn receptacle collides
  where that env drew it. Only the envs that still have an active contact
  are redrawn, for at most `max_rounds` rounds after the first draw; an
  env that still touches then keeps its last draw, as the reference's
  loop does.
  """

  def n_contacts(m, rows):
    qpos = rows[:, :model.nq]
    d = types.make_data(m, qpos.shape[0], dtype=qpos.dtype)
    d = smooth.kinematics(m, d.replace(qpos=qpos))
    return coll_ops.collision(m, d).contact.active.sum(dim=-1)

  rows = draw(torch.arange(batch, device=model.device))
  n = n_contacts(model, rows)
  for _ in range(max_rounds):
    redo = torch.nonzero(n > 0)[:, 0]
    if not len(redo):
      break
    rows[redo] = draw(redo)
    n[redo] = n_contacts(model.env_rows(redo), rows[redo])
  return rows
