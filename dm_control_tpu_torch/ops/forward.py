"""Forward dynamics pipeline and the Euler integrator, batched.

Port of the batched path of dm_control_tpu/ops/forward.py: position,
velocity, actuation, acceleration and constraint stages over a (B, ...)
Data, then semi-implicit Euler with implicit joint damping. The three SPD
solves of a step (smooth acceleration, Newton direction, Euler) go through
ops/cuda_kernels.chol_solve_batched. RK4 and implicitfast raise
NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from dm_control_tpu_torch.models import constants
from dm_control_tpu_torch.models import types
from dm_control_tpu_torch.models.types import Data, Model
from dm_control_tpu_torch.ops import collision as coll
from dm_control_tpu_torch.ops import constraint
from dm_control_tpu_torch.ops import cuda_kernels
from dm_control_tpu_torch.ops import math as mops
from dm_control_tpu_torch.ops import sensor as sensor_ops
from dm_control_tpu_torch.ops import smooth

_J = constants.JointType


def fwd_position(m: Model, d: Data) -> Data:
  d = smooth.kinematics(m, d)
  d = smooth.com_pos(m, d)
  d = smooth.tendon(m, d)
  d = smooth.crb(m, d)
  if not m.opt.disableflags & (constants.DisableBit.CONTACT |
                               constants.DisableBit.CONSTRAINT):
    d = coll.collision(m, d)
  return smooth.transmission(m, d)


def fwd_velocity(m: Model, d: Data) -> Data:
  d = smooth.com_vel(m, d)
  d = smooth.tendon_vel(m, d)
  if m.nu:
    d = d.replace(actuator_velocity=torch.einsum(
        'Buv,Bv->Bu', d.actuator_moment, d.qvel))
  d = smooth.rne(m, d)
  return smooth.passive(m, d)


def fwd_actuation(m: Model, d: Data) -> Data:
  B = d.qpos.shape[0]
  if not m.nu or m.opt.disableflags & constants.DisableBit.ACTUATION:
    return d.replace(qfrc_actuator=torch.zeros_like(d.qvel),
                     actuator_force=d.qpos.new_zeros((B, m.nu)),
                     act_dot=d.qpos.new_zeros((B, m.na)))
  ctrl = d.ctrl
  if not m.opt.disableflags & constants.DisableBit.CLAMPCTRL:
    limited = m.const('actuator_ctrllimited',
                      lambda: np.asarray(m.actuator_ctrllimited, dtype=bool))
    clamped = torch.clamp(ctrl, m.actuator_ctrlrange[:, 0],
                          m.actuator_ctrlrange[:, 1])
    ctrl = torch.where(limited, clamped, ctrl)

  act_dot = d.qpos.new_zeros((B, m.na))
  dyntypes = np.array(m.actuator_dyntype)
  if m.na == 0 and np.all(dyntypes == int(constants.DynType.NONE)):
    input_vec = ctrl
  else:
    stateful = np.where(dyntypes != int(constants.DynType.NONE))[0]
    adrs = np.array(m.actuator_actadr)[stateful]
    a_vals = d.act[:, adrs]
    u_ctrl = ctrl[:, stateful]
    is_int = torch.as_tensor(
        dyntypes[stateful] == int(constants.DynType.INTEGRATOR),
        device=m.device)
    tau = torch.clamp(m.actuator_dynprm[stateful, 0], min=1e-8)
    act_dot[:, adrs] = torch.where(is_int, u_ctrl, (u_ctrl - a_vals) / tau)
    input_vec = ctrl.clone()
    input_vec[:, stateful] = a_vals

  length = d.actuator_length
  velocity = d.actuator_velocity
  gp, bp = m.actuator_gainprm, m.actuator_biasprm
  fixed = m.const('gain_fixed', lambda: np.asarray(
      m.actuator_gaintype) == int(constants.GainType.FIXED))
  gain = torch.where(fixed, gp[:, 0],
                     gp[:, 0] + gp[:, 1] * length + gp[:, 2] * velocity)
  nobias = m.const('bias_none', lambda: np.asarray(
      m.actuator_biastype) == int(constants.BiasType.NONE))
  bias = torch.where(nobias, torch.zeros_like(length),
                     bp[:, 0] + bp[:, 1] * length + bp[:, 2] * velocity)
  force = gain * input_vec + bias
  flimited = m.const('actuator_forcelimited',
                     lambda: np.asarray(m.actuator_forcelimited, dtype=bool))
  force = torch.where(flimited, torch.clamp(
      force, m.actuator_forcerange[:, 0], m.actuator_forcerange[:, 1]),
                      force)
  qfrc = torch.einsum('Buv,Bu->Bv', d.actuator_moment, force)
  return d.replace(actuator_force=force, qfrc_actuator=qfrc, act_dot=act_dot)


def _qfrc_smooth_total(m: Model, d: Data) -> torch.Tensor:
  qfrc_applied = d.qfrc_applied
  if m.nbody > 1:
    frc = d.xfrc_applied[..., :3]
    trq = d.xfrc_applied[..., 3:]
    offset = d.xipos - d.subtree_com[:, smooth._rootid(m)]
    fs = torch.cat([trq + mops.cross(offset, frc), frc], dim=-1)
    ftot = smooth._subtree_sum(m, fs)
    qfrc_applied = qfrc_applied + torch.sum(
        d.cdof * ftot[:, smooth._dofbody(m)], dim=-1)
  return d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator + qfrc_applied


def fwd_acceleration_batched(m: Model, d: Data) -> Data:
  """Smooth acceleration: one batched SPD solve M qacc = qfrc_smooth."""
  qfrc = _qfrc_smooth_total(m, d)
  qacc = cuda_kernels.chol_solve_batched(d.qM, qfrc)
  return d.replace(qfrc_smooth=qfrc, qacc_smooth=qacc)


def _check_health(m: Model, d: Data) -> Data:
  bad = torch.zeros(d.qpos.shape[0], dtype=torch.bool, device=d.qpos.device)
  for x in (d.qpos, d.qvel, d.qacc):
    bad = bad | ~torch.isfinite(x).all(dim=-1)
  bad = bad | (torch.abs(d.qacc) > 1e10).any(dim=-1)
  bad = bad | (torch.abs(d.qvel) > 1e10).any(dim=-1)
  return d.replace(divergence=bad)


def fwd_pv(m: Model, d: Data, compute_sensors: bool = True) -> Data:
  """Position and velocity stages with their sensors (mj_step1)."""
  d = fwd_position(m, d)
  d = fwd_velocity(m, d)
  if compute_sensors:
    d = sensor_ops.sensors(m, d, stages='pv')
  if m.opt.enableflags & constants.EnableBit.ENERGY:
    raise NotImplementedError('energy is not ported')
  return _check_health(m, d)


def fwd_aa_batched(m: Model, d: Data, compute_sensors: bool = True) -> Data:
  """Actuation, acceleration, constraint and acceleration-stage sensors."""
  d = fwd_actuation(m, d)
  d = fwd_acceleration_batched(m, d)
  d = constraint.fwd_constraint_batched(m, d, compute_forces=compute_sensors)
  if compute_sensors:
    d = sensor_ops.sensors(m, d, stages='acc')
  return d


def forward_batched(m: Model, d: Data, compute_sensors: bool = True) -> Data:
  d = fwd_pv(m, d, compute_sensors)
  return fwd_aa_batched(m, d, compute_sensors)


def forward(m: Model, d: Data) -> Data:
  """Full forward dynamics including all sensors."""
  return forward_batched(m, d, compute_sensors=True)


def _integration_schedule(m: Model):

  def make():
    scal_q, scal_v, quat = [], [], []
    for j in range(m.njnt):
      jt = m.jnt_type[j]
      qadr, vadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
      if jt == _J.FREE:
        scal_q.extend(range(qadr, qadr + 3))
        scal_v.extend(range(vadr, vadr + 3))
        quat.append((qadr + 3, vadr + 3))
      elif jt == _J.BALL:
        quat.append((qadr, vadr))
      else:
        scal_q.append(qadr)
        scal_v.append(vadr)
    ix = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=m.device)
    return ix(scal_q), ix(scal_v), tuple(quat)

  return m.memo('integration_schedule', make)


def integrate_pos(m: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                  dt) -> torch.Tensor:
  """Quaternion-aware position integration (mj_integratePos)."""
  scal_q, scal_v, quat = _integration_schedule(m)
  out = qpos.clone()
  for qadr, vadr in quat:
    out[:, qadr:qadr + 4] = mops.quat_integrate(
        qpos[:, qadr:qadr + 4], qvel[:, vadr:vadr + 3], dt)
  if len(scal_q):
    out[:, scal_q] = qpos[:, scal_q] + dt * qvel[:, scal_v]
  return out


def _advance(m: Model, d: Data, qacc: torch.Tensor) -> Data:
  dt = m.opt.timestep.to(d.qpos.dtype)
  qvel = d.qvel + dt * qacc
  qpos = integrate_pos(m, d.qpos, qvel, dt)
  act = d.act
  if m.na:
    if any(m.actuator_dyntype[u] == constants.DynType.FILTEREXACT
           for u in range(m.nu)):
      raise NotImplementedError('filterexact activation is not ported')
    act = d.act + dt * d.act_dot
    per_slot_u = np.array([u for u in range(m.nu)
                           for _ in range(int(m.actuator_actnum[u]))])
    limited = torch.as_tensor(
        np.array(m.actuator_actlimited)[per_slot_u].astype(bool),
        device=m.device)
    rng = m.actuator_actrange[per_slot_u]
    act = torch.where(limited, torch.clamp(act, rng[:, 0], rng[:, 1]), act)
  return d.replace(qpos=qpos, qvel=qvel, act=act, time=d.time + dt)


def _euler_batched(m: Model, d: Data) -> Data:
  """Semi-implicit Euler, implicit in the joint damping:
  (M + h diag(damping)) qacc' = qfrc_smooth + qfrc_constraint."""
  dt = m.opt.timestep.to(d.qpos.dtype)
  qfrc = d.qfrc_smooth + d.qfrc_constraint
  mhd = d.qM + dt * torch.diag(m.dof_damping)
  return _advance(m, d, cuda_kernels.chol_solve_batched(mhd, qfrc))


def step_batched(m: Model, d: Data, compute_sensors: bool = True) -> Data:
  """One physics step of the batch: forward dynamics, then Euler."""
  integ = int(m.opt.integrator)
  if integ != constants.IntegratorType.EULER:
    raise NotImplementedError(
        f'integrator {constants.IntegratorType(integ).name} is not ported')
  d = forward_batched(m, d, compute_sensors)
  return _euler_batched(m, d)


# The minimal fields that determine the next step; everything else in Data
# is recomputed by the pipeline.
SLIM_STATE_FIELDS = (
    'time', 'qpos', 'qvel', 'act', 'ctrl', 'qacc', 'qacc_warmstart',
    'sensordata',
)


def slim_state(d: Data) -> dict:
  return {f: getattr(d, f) for f in SLIM_STATE_FIELDS}


def inflate(m: Model, s: dict, template: Data = None) -> Data:
  """A full Data around a slim state.

  template: a zero Data of the same batch size to reuse (the pipeline
  never writes into the tensors it is given, so one template can serve
  every call).
  """
  if template is None:
    template = types.make_data(m, s['qpos'].shape[0], dtype=s['qpos'].dtype,
                               device=s['qpos'].device)
  return template.replace(**s)
