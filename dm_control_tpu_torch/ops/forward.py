"""Forward dynamics pipeline, energy and the Euler and RK4 integrators,
batched.

Port of the batched path of dm_control_tpu/ops/forward.py: position,
velocity, actuation, acceleration and constraint stages over a (B, ...)
Data, the energy stage (potential and kinetic energy per env, when the
model enables it), then either semi-implicit Euler with implicit joint
damping or the classic four-stage RK4. Every SPD solve of a step (the
smooth acceleration, once more per RK4 stage; the Newton direction; the
Euler update) goes through ops/cuda_kernels.chol_solve_batched. The
implicitfast and implicit integrators raise NotImplementedError.
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
    d = energy(m, d)
  return _check_health(m, d)


def fwd_aa_batched(m: Model, d: Data, compute_sensors: bool = True) -> Data:
  """Actuation, acceleration, constraint and acceleration-stage sensors."""
  d = fwd_actuation(m, d)
  d = fwd_acceleration_batched(m, d)
  d = constraint.fwd_constraint_batched(m, d, compute_forces=compute_sensors)
  if compute_sensors:
    d = sensor_ops.sensors(m, d, stages='acc')
  return d


def forward_batched(m: Model, d: Data, compute_sensors: bool = True,
                    stages: str = 'all') -> Data:
  """All stages; with compute_sensors, the sensors of `stages`: 'all', or
  'acc' (the acceleration stage alone, for a caller that recomputes the
  position/velocity stage after the step)."""
  d = fwd_pv(m, d, compute_sensors and stages == 'all')
  return fwd_aa_batched(m, d, compute_sensors)


def forward(m: Model, d: Data) -> Data:
  """Full forward dynamics including all sensors."""
  return forward_batched(m, d, compute_sensors=True)


def forward_core_batched(m: Model, d: Data) -> Data:
  """The stages an RK4 stage needs: no sensors, no energy, no constraint
  forces (the pre-integration forward_batched pass computes those)."""
  d = fwd_position(m, d)
  d = fwd_velocity(m, d)
  d = fwd_actuation(m, d)
  d = fwd_acceleration_batched(m, d)
  return constraint.fwd_constraint_batched(m, d, compute_forces=False)


def _spring_schedule(m: Model):
  """qpos addresses and joint ids of the joint springs: scalar (hinge,
  slide) coordinates, quaternions (ball and free joints) and the linear
  part of free joints."""

  def make():
    scal, quat, lin = ([], []), ([], []), ([], [])
    for j in range(m.njnt):
      jt, adr = m.jnt_type[j], m.jnt_qposadr[j]
      if jt in (_J.HINGE, _J.SLIDE):
        scal[0].append(adr)
        scal[1].append(j)
      elif jt == _J.BALL:
        quat[0].append(range(adr, adr + 4))
        quat[1].append(j)
      else:
        lin[0].append(range(adr, adr + 3))
        lin[1].append(j)
        quat[0].append(range(adr + 3, adr + 7))
        quat[1].append(j)
    ix = lambda a, *w: torch.as_tensor(
        np.asarray(a, dtype=np.int64).reshape((-1,) + w), device=m.device)
    return ((ix(scal[0]), ix(scal[1])), (ix(quat[0], 4), ix(quat[1])),
            (ix(lin[0], 3), ix(lin[1])))

  return m.memo('spring_schedule', make)


def energy(m: Model, d: Data) -> Data:
  """Potential (gravity, joint and tendon springs) and kinetic energy,
  (B, 2)."""
  gravity = m.opt.gravity.to(d.qpos.dtype)
  pot = -torch.einsum('b,Bb->B', m.body_mass, d.xipos @ gravity)
  (scal_q, scal_j), (quat_q, quat_j), (lin_q, lin_j) = _spring_schedule(m)
  if len(scal_j):
    dif = d.qpos[:, scal_q] - m.qpos_spring[scal_q]
    pot = pot + 0.5 * torch.sum(m.jnt_stiffness[scal_j] * dif * dif, dim=-1)
  if len(quat_j):
    dif = mops.quat_sub(d.qpos[:, quat_q], m.qpos_spring[quat_q])
    pot = pot + 0.5 * torch.sum(
        m.jnt_stiffness[quat_j] * torch.sum(dif * dif, dim=-1), dim=-1)
  if len(lin_j):
    dif = d.qpos[:, lin_q] - m.qpos_spring[lin_q]
    pot = pot + 0.5 * torch.sum(
        m.jnt_stiffness[lin_j] * torch.sum(dif * dif, dim=-1), dim=-1)
  if m.ntendon:
    ref = torch.where(m.tendon_lengthspring[:, 0] < 0, m.tendon_length0,
                      m.tendon_lengthspring[:, 0])
    dif = d.ten_length - ref
    pot = pot + 0.5 * torch.sum(m.tendon_stiffness * dif * dif, dim=-1)
  kin = 0.5 * torch.einsum('Bi,Bij,Bj->B', d.qvel, d.qM, d.qvel)
  return d.replace(energy=torch.stack([pot, kin], dim=-1))


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


_RK4_A = ((0.5,), (0.0, 0.5), (0.0, 0.0, 1.0))
_RK4_B = (1.0 / 6, 1.0 / 3, 1.0 / 3, 1.0 / 6)


def _rk4_batched(m: Model, d: Data) -> Data:
  """Classic RK4 from a forward-computed d. Each stage restarts from d
  with the stage's qpos, qvel and act; the result keeps d's other fields
  (its warmstart among them) and advances time by one step."""
  dt = m.opt.timestep.to(d.qpos.dtype)
  kv, ka, kad = [d.qvel], [d.qacc], [d.act_dot]
  for arow in _RK4_A:
    dq = sum(a * v for a, v in zip(arow, kv) if a)
    dv = sum(a * acc for a, acc in zip(arow, ka) if a)
    di = d.replace(qpos=integrate_pos(m, d.qpos, dq, dt),
                   qvel=d.qvel + dt * dv)
    if m.na:
      dact = sum(a * ad for a, ad in zip(arow, kad) if a)
      di = di.replace(act=d.act + dt * dact)
    di = forward_core_batched(m, di)
    kv.append(di.qvel)
    ka.append(di.qacc)
    kad.append(di.act_dot)
  vbar = sum(b * v for b, v in zip(_RK4_B, kv))
  abar = sum(b * a for b, a in zip(_RK4_B, ka))
  act = d.act
  if m.na:
    act = d.act + dt * sum(b * ad for b, ad in zip(_RK4_B, kad))
  return d.replace(qpos=integrate_pos(m, d.qpos, vbar, dt),
                   qvel=d.qvel + dt * abar, act=act, time=d.time + dt)


def step_batched(m: Model, d: Data, compute_sensors: bool = True,
                 stages: str = 'all') -> Data:
  """One physics step of the batch: forward dynamics, then Euler or RK4.

  compute_sensors=False skips the per-step sensors (the rollout reads
  sensors from its position/velocity refresh after the substeps);
  stages='acc' computes only the acceleration-stage ones, with the
  constraint forces they read.
  """
  integ = int(m.opt.integrator)
  if integ not in (constants.IntegratorType.EULER,
                   constants.IntegratorType.RK4):
    raise NotImplementedError(
        f'integrator {constants.IntegratorType(integ).name} is not ported '
        '(the port has Euler and RK4)')
  d = forward_batched(m, d, compute_sensors, stages)
  if integ == constants.IntegratorType.RK4:
    return _rk4_batched(m, d)
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
