"""Sensors of the ported slice, batched.

Port of dm_control_tpu/ops/sensor.py for the sensor types of the ported
domains: jointpos, jointvel, subtreecom, subtreelinvel, velocimeter, gyro
and the frame group (framepos, framequat, framexaxis, frameyaxis,
framezaxis, framelinvel, frameangvel) in the position/velocity stage;
touch, accelerometer, force and torque in the acceleration stage. Any
other type raises NotImplementedError.
"""

from __future__ import annotations

import torch

from dm_control_tpu_torch.models import constants
from dm_control_tpu_torch.models.types import Data, Model
from dm_control_tpu_torch.ops import math as mops
from dm_control_tpu_torch.ops import smooth

_S = constants.SensorType
_OBJ = constants.ObjType

# the frame sensors read a site's, a geom's or a body's frame in world
# coordinates; as in the JAX package, objtype body and xbody both mean the
# body frame (xpos, xmat) and reftype is not read
_FRAME = (_S.FRAMEPOS, _S.FRAMEQUAT, _S.FRAMEXAXIS, _S.FRAMEYAXIS,
          _S.FRAMEZAXIS, _S.FRAMELINVEL, _S.FRAMEANGVEL)
_PV_STAGE = (_S.JOINTPOS, _S.JOINTVEL, _S.SUBTREECOM, _S.SUBTREELINVEL,
             _S.VELOCIMETER, _S.GYRO) + _FRAME
_ACC_STAGE = (_S.TOUCH, _S.ACCELEROMETER, _S.FORCE, _S.TORQUE)


def _rne_post(m: Model, d: Data):
  """Post-constraint body accelerations and interaction forces."""
  dtype = d.qpos.dtype
  cacc0 = torch.cat([torch.zeros(3, dtype=dtype, device=m.device),
                     -smooth._gravity(m, dtype)])
  contrib = d.cdof_dot * d.qvel[..., None] + d.cdof * d.qacc[..., None]
  cacc = cacc0 + torch.einsum('bv,Bvj->Bbj', m.body_dof_mask, contrib)
  fb = (torch.einsum('Bbij,Bbj->Bbi', d.cinert, cacc) +
        mops.cross_force(d.cvel, torch.einsum('Bbij,Bbj->Bbi', d.cinert,
                                              d.cvel)))
  fext = torch.zeros_like(fb)
  rootid = smooth._rootid(m)
  if m.ncon_sel:
    con = d.contact
    gbody = m.index('geom_bodyid')
    f_world = torch.einsum('Bsji,Bsj->Bsi', con.frame, con.force)
    f_world = torch.where(con.active[..., None], f_world,
                          torch.zeros_like(f_world))
    for geom, sign in ((con.geom1, -1.0), (con.geom2, 1.0)):
      b = gbody[geom]                                     # (B, s)
      o = torch.gather(d.subtree_com, 1,
                       rootid[b][..., None].expand(b.shape + (3,)))
      trq = mops.cross(con.pos - o, f_world) * sign
      src = torch.cat([trq, sign * f_world], dim=-1)
      fext = fext.scatter_add(1, b[..., None].expand(b.shape + (6,)), src)
  if m.nbody > 1:
    frc = d.xfrc_applied[..., :3]
    trq = d.xfrc_applied[..., 3:]
    off = d.xipos - d.subtree_com[:, rootid]
    fext = fext + torch.cat([trq + mops.cross(off, frc), frc], dim=-1)
  cfrc_int = smooth._subtree_sum(m, fb - fext)
  return cacc, cfrc_int


def _site_zone(m: Model, d: Data, siteid: int, point):
  """Whether world points (B, s, 3) lie inside the site's volume."""
  stype = m.site_type[siteid]
  local = torch.einsum('Bji,Bsj->Bsi', d.site_xmat[:, siteid],
                       point - d.site_xpos[:, siteid][:, None])
  size = m.site_size[siteid]
  if stype == constants.GeomType.SPHERE:
    return mops.norm(local) <= size[0]
  if stype == constants.GeomType.CAPSULE:
    z = torch.clamp(local[..., 2], -size[1], size[1])
    ez = torch.zeros_like(local)
    ez[..., 2] = z
    return mops.norm(local - ez) <= size[0]
  if stype == constants.GeomType.ELLIPSOID:
    return torch.sum((local / torch.clamp(size, min=1e-12)) ** 2,
                     dim=-1) <= 1.0
  return torch.all(torch.abs(local) <= torch.clamp(size, min=1e-12), dim=-1)


def _frame_sensor(m: Model, d: Data, st: int, objtype: int, oid: int):
  """(B, 3) or (B, 4): one frame sensor's value."""
  if objtype == _OBJ.SITE:
    pos, mat, body = (d.site_xpos[:, oid], d.site_xmat[:, oid],
                      m.site_bodyid[oid])
  elif objtype == _OBJ.GEOM:
    pos, mat, body = (d.geom_xpos[:, oid], d.geom_xmat[:, oid],
                      m.geom_bodyid[oid])
  else:  # body, xbody
    pos, mat, body = d.xpos[:, oid], d.xmat[:, oid], oid
  if st == _S.FRAMEPOS:
    return pos
  if st == _S.FRAMEQUAT:
    return (mops.mat_to_quat(mat) if objtype in (_OBJ.SITE, _OBJ.GEOM)
            else d.xquat[:, oid])
  if st in (_S.FRAMEXAXIS, _S.FRAMEYAXIS, _S.FRAMEZAXIS):
    return mat[..., st - _S.FRAMEXAXIS]
  vel = smooth.object_velocity(m, d, pos, body)
  return vel[:, 3:] if st == _S.FRAMELINVEL else vel[:, :3]


def has_acc_stage(m: Model) -> bool:
  """Whether the model has a sensor of the acceleration stage."""
  return m.memo('has_acc_stage', lambda: any(
      st in _ACC_STAGE for st in m.sensor_type))


def sensors(m: Model, d: Data, stages: str = 'all') -> Data:
  """Evaluate sensors. stages: 'all', 'pv' or 'acc'."""
  if not m.nsensor:
    return d
  for st in m.sensor_type:
    if st not in _PV_STAGE + _ACC_STAGE:
      raise NotImplementedError(
          f'sensor type {constants.SensorType(st).name} is not ported')
  selected = [i for i in range(m.nsensor)
              if stages == 'all'
              or (stages == 'acc') == (m.sensor_type[i] in _ACC_STAGE)]
  if not selected:
    return d
  cacc = cfrc_int = None
  if any(m.sensor_type[i] in (_S.ACCELEROMETER, _S.FORCE, _S.TORQUE)
         for i in selected):
    cacc, cfrc_int = _rne_post(m, d)
    d = d.replace(cacc=cacc, cfrc_int=cfrc_int)

  out = d.sensordata.clone()
  vcom = None
  for i in selected:
    st = m.sensor_type[i]
    oid = m.sensor_objid[i]
    adr, dim = m.sensor_adr[i], m.sensor_dim[i]
    if st == _S.JOINTPOS:
      val = d.qpos[:, m.jnt_qposadr[oid]]
    elif st == _S.JOINTVEL:
      val = d.qvel[:, m.jnt_dofadr[oid]]
    elif st == _S.SUBTREECOM:
      val = d.subtree_com[:, oid]
    elif st == _S.SUBTREELINVEL:
      if vcom is None:
        r = d.xipos - d.subtree_com[:, smooth._rootid(m)]
        vcom = d.cvel[..., 3:] + mops.cross(d.cvel[..., :3], r)
      mom = torch.einsum('b,Bbj->Bj', m.subtree_mask[oid],
                         m.body_mass[:, None] * vcom)
      val = mom / torch.clamp(m.body_subtreemass[oid], min=1e-12)
    elif st in (_S.VELOCIMETER, _S.GYRO):
      vel = smooth.object_velocity(m, d, d.site_xpos[:, oid],
                                   m.site_bodyid[oid])
      v = vel[:, 3:] if st == _S.VELOCIMETER else vel[:, :3]
      val = torch.einsum('Bji,Bj->Bi', d.site_xmat[:, oid], v)
    elif st in _FRAME:
      val = _frame_sensor(m, d, st, m.sensor_objtype[i], oid)
    elif st == _S.TOUCH:
      body = m.site_bodyid[oid]
      if m.ncon_sel:
        con = d.contact
        gbody = m.index('geom_bodyid')
        onbody = (gbody[con.geom1] == body) | (gbody[con.geom2] == body)
        inzone = _site_zone(m, d, oid, con.pos)
        fn = torch.clamp(con.force[..., 0], min=0.0)
        total = torch.sum(torch.where(con.active & onbody & inzone, fn,
                                      torch.zeros_like(fn)), dim=-1)
      else:
        total = d.qpos.new_zeros(d.qpos.shape[0])
      val = total[:, None]
    elif st == _S.ACCELEROMETER:
      body = m.site_bodyid[oid]
      point = d.site_xpos[:, oid]
      r = point - d.subtree_com[:, m.body_rootid[body]]
      ang_acc = cacc[:, body, :3]
      lin_acc = cacc[:, body, 3:] + mops.cross(ang_acc, r)
      vel = smooth.object_velocity(m, d, point, body)
      lin_acc = lin_acc + mops.cross(vel[:, :3], vel[:, 3:])
      val = torch.einsum('Bji,Bj->Bi', d.site_xmat[:, oid], lin_acc)
    else:  # force / torque
      body = m.site_bodyid[oid]
      o = d.subtree_com[:, m.body_rootid[body]]
      trq, frc = cfrc_int[:, body, :3], cfrc_int[:, body, 3:]
      if st == _S.TORQUE:
        frc = trq - mops.cross(d.site_xpos[:, oid] - o, frc)
      val = torch.einsum('Bji,Bj->Bi', d.site_xmat[:, oid], frc)
    cutoff = m.sensor_cutoff[i]
    val = val.reshape(-1, dim)
    val = torch.where(cutoff > 0, torch.clamp(val, -cutoff, cutoff), val)
    out[:, adr:adr + dim] = val
  return d.replace(sensordata=out)
