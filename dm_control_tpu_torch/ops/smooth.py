"""Smooth (unconstrained) dynamics: FK, com frames, CRB, RNE, passive.

Port of dm_control_tpu/ops/smooth.py with an explicit batch axis: every
Data tensor is (B, ...), Model tensors are shared by the batch. Tree
accumulations stay dense products against the model's 0/1 structure masks,
and forward kinematics sweeps the tree level by level.
"""

from __future__ import annotations

import numpy as np
import torch

from dm_control_tpu_torch.models import constants
from dm_control_tpu_torch.models.types import Data, Model
from dm_control_tpu_torch.ops import math as mops

_J = constants.JointType


def _index(m: Model, a) -> torch.Tensor:
  return torch.as_tensor(np.asarray(a, dtype=np.int64), device=m.device)


# ---------------------------------------------------------------------------
# kinematics
# ---------------------------------------------------------------------------


def _fk_schedule(m: Model):
  """[(ids, parents, slots)] per tree level; slots[s] maps joint type ->
  (local lane indices, joint ids, qpos addresses) for the s-th joint."""

  def make():
    bylevel = {}
    for b in range(1, m.nbody):
      bylevel.setdefault(m.body_treelevel[b], []).append(b)
    out = []
    for lvl in sorted(bylevel):
      ids = bylevel[lvl]
      parents = [m.body_parentid[b] for b in ids]
      maxj = max((m.body_jntnum[b] for b in ids), default=0)
      slots = []
      for s in range(maxj):
        groups = {}
        for li, b in enumerate(ids):
          if s < m.body_jntnum[b]:
            jid = m.body_jntadr[b] + s
            g = groups.setdefault(m.jnt_type[jid], ([], []))
            g[0].append(li)
            g[1].append(jid)
        slots.append({
            t: (_index(m, li), _index(m, jid),
                _index(m, [m.jnt_qposadr[j] for j in jid]))
            for t, (li, jid) in groups.items()})
      out.append((_index(m, ids), _index(m, parents), slots))
    return out

  return m.memo('fk_schedule', make)


def kinematics(m: Model, d: Data) -> Data:
  """qpos -> body, geom and site frames and joint anchors/axes."""
  qpos = d.qpos
  B, dtype, dev = qpos.shape[0], qpos.dtype, qpos.device
  xpos = torch.zeros((B, m.nbody, 3), dtype=dtype, device=dev)
  xquat = torch.zeros((B, m.nbody, 4), dtype=dtype, device=dev)
  xquat[..., 0] = 1.0
  xanchor = torch.zeros((B, m.njnt, 3), dtype=dtype, device=dev)
  xaxis = torch.zeros((B, m.njnt, 3), dtype=dtype, device=dev)
  ar3 = m.const('arange3', lambda: np.arange(3))
  ar4 = m.const('arange4', lambda: np.arange(4))

  for ids, parents, slots in _fk_schedule(m):
    pq = xquat[:, parents]
    pos = xpos[:, parents] + mops.rot_vec_quat(m.body_pos[ids], pq)
    quat = mops.mul_quat(pq, m.body_quat[ids])
    for slot in slots:
      for jt, (li, jid, qadr) in slot.items():
        if jt == _J.FREE:
          fpos = qpos[:, qadr[:, None] + ar3]
          fquat = mops.normalize_quat(qpos[:, qadr[:, None] + 3 + ar4])
          pos[:, li] = fpos
          quat[:, li] = fquat
          xanchor[:, jid] = fpos
          xaxis[:, jid] = mops.rot_vec_quat(m.jnt_axis[jid], fquat)
          continue
        jpos = m.jnt_pos[jid]
        jaxis = m.jnt_axis[jid]
        q_l = quat[:, li]
        anchor = mops.rot_vec_quat(jpos, q_l) + pos[:, li]
        axis = mops.rot_vec_quat(jaxis, q_l)
        xanchor[:, jid] = anchor
        xaxis[:, jid] = axis
        if jt == _J.SLIDE:
          pos[:, li] = pos[:, li] + axis * (
              qpos[:, qadr] - m.qpos0[qadr])[..., None]
          continue
        if jt == _J.BALL:
          qloc = mops.normalize_quat(qpos[:, qadr[:, None] + ar4])
        else:  # hinge
          qloc = mops.axis_angle_to_quat(jaxis,
                                         qpos[:, qadr] - m.qpos0[qadr])
        qn = mops.mul_quat(q_l, qloc)
        quat[:, li] = qn
        pos[:, li] = anchor - mops.rot_vec_quat(jpos, qn)
    xpos[:, ids] = pos
    xquat[:, ids] = mops.normalize_quat(quat)

  xmat = mops.quat_to_mat(xquat)
  xipos = xpos + mops.rot_vec_quat(m.body_ipos, xquat)
  ximat = mops.quat_to_mat(mops.mul_quat(xquat, m.body_iquat))
  gb = m.const('geom_bodyid', lambda: m.geom_bodyid)
  geom_xpos = xpos[:, gb] + mops.rot_vec_quat(m.geom_pos, xquat[:, gb])
  geom_xmat = mops.quat_to_mat(mops.mul_quat(xquat[:, gb], m.geom_quat))
  if m.nsite:
    sb = m.const('site_bodyid', lambda: m.site_bodyid)
    site_xpos = xpos[:, sb] + mops.rot_vec_quat(m.site_pos, xquat[:, sb])
    site_xmat = mops.quat_to_mat(mops.mul_quat(xquat[:, sb], m.site_quat))
  else:
    site_xpos = torch.zeros((B, 0, 3), dtype=dtype, device=dev)
    site_xmat = torch.zeros((B, 0, 3, 3), dtype=dtype, device=dev)
  return d.replace(
      xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos, ximat=ximat,
      xanchor=xanchor, xaxis=xaxis, geom_xpos=geom_xpos,
      geom_xmat=geom_xmat, site_xpos=site_xpos, site_xmat=site_xmat)


# ---------------------------------------------------------------------------
# com-based quantities
# ---------------------------------------------------------------------------


def _rootid(m: Model) -> torch.Tensor:
  return m.const('body_rootid', lambda: m.body_rootid)


def _dofbody(m: Model) -> torch.Tensor:
  return m.const('dof_bodyid', lambda: m.dof_bodyid)


def _subtree_sum(m: Model, x: torch.Tensor) -> torch.Tensor:
  """(B, nbody, ...) -> sums over each body's subtree."""
  return torch.einsum('bc,Bc...->Bb...', m.subtree_mask, x)


def com_pos(m: Model, d: Data) -> Data:
  """Subtree coms, com-frame spatial inertias, com-frame motion dofs."""
  mass_xipos = m.body_mass[:, None] * d.xipos
  denom = torch.clamp(m.body_subtreemass, min=1e-12)
  subtree_com = _subtree_sum(m, mass_xipos) / denom[:, None]
  subtree_com = torch.where((m.body_subtreemass > 1e-12)[:, None],
                            subtree_com, d.xpos)
  offset = d.xipos - subtree_com[:, _rootid(m)]
  scaled = d.ximat * m.body_inertia[:, None, :]
  inert3 = torch.sum(scaled[..., :, None, :] * d.ximat[..., None, :, :],
                     dim=-1)
  cinert = mops.spatial_inertia(m.body_mass, inert3, offset)

  if m.nv:
    jids, bods, roots, col, w_slide, w_col, w_hinge, ek = _cdof_schedule(m)
    arv = m.const('arange_nv', lambda: np.arange(m.nv))
    axis_col = d.xmat[:, bods].transpose(-1, -2)[:, arv, col]
    axis_jnt = d.xaxis[:, jids]
    ang = w_col[:, None] * axis_col + w_hinge[:, None] * axis_jnt
    offs = d.xanchor[:, jids] - subtree_com[:, roots]
    lin = ek + mops.cross(offs, ang) + w_slide[:, None] * axis_jnt
    cdof = torch.cat([ang, lin], dim=-1)
  else:
    cdof = d.qpos.new_zeros((d.qpos.shape[0], 0, 6))
  return d.replace(subtree_com=subtree_com, cinert=cinert, cdof=cdof)


def _cdof_schedule(m: Model):
  """Static per-dof tables for the vectorized cdof computation."""

  def make():
    jids = np.asarray(m.dof_jntid, dtype=np.int64)
    bods = np.asarray([m.jnt_bodyid[j] for j in jids], dtype=np.int64)
    roots = np.asarray([m.body_rootid[b] for b in bods], dtype=np.int64)
    t = np.asarray([m.jnt_type[j] for j in jids])
    k = np.arange(m.nv) - np.asarray([m.jnt_dofadr[j] for j in jids])
    free_trans = (t == _J.FREE) & (k < 3)
    rot_col = ((t == _J.FREE) & (k >= 3)) | (t == _J.BALL)
    col = np.where(t == _J.FREE, k - 3, k).clip(0, 2)
    ek = np.where(free_trans[:, None], np.eye(3)[k.clip(0, 2)], 0.0)
    f = lambda a: torch.as_tensor(a, dtype=m.dtype, device=m.device)
    return (_index(m, jids), _index(m, bods), _index(m, roots),
            _index(m, col), f((t == _J.SLIDE).astype(np.float64)),
            f(rot_col.astype(np.float64)),
            f((t == _J.HINGE).astype(np.float64)), f(ek))

  return m.memo('cdof_schedule', make)


def com_vel(m: Model, d: Data) -> Data:
  """Body spatial velocities and dof-axis time derivatives."""
  cdof_qvel = d.cdof * d.qvel[..., None]
  cvel = torch.einsum('bv,Bvj->Bbj', m.body_dof_mask, cdof_qvel)
  vpart = torch.einsum('vw,Bwj->Bvj', m.dof_vel_mask, cdof_qvel)
  cdof_dot = mops.cross_motion(vpart, d.cdof)
  if m.nv:
    # translational dofs of free joints have constant axes
    keep = m.const('cdof_dot_keep', lambda: np.array(
        [0.0 if (m.jnt_type[m.dof_jntid[v]] == _J.FREE and
                 v - m.jnt_dofadr[m.dof_jntid[v]] < 3) else 1.0
         for v in range(m.nv)]))
    cdof_dot = cdof_dot * keep[:, None]
  return d.replace(cvel=cvel, cdof_dot=cdof_dot)


# ---------------------------------------------------------------------------
# inertia matrix (CRB) and bias forces (RNE)
# ---------------------------------------------------------------------------


def crb(m: Model, d: Data) -> Data:
  """Composite-rigid-body joint-space inertia matrix, dense."""
  crb_inert = _subtree_sum(m, d.cinert)
  f = torch.einsum('Bvij,Bvj->Bvi', crb_inert[:, _dofbody(m)], d.cdof)
  raw = torch.einsum('Bvi,Bwi->Bvw', d.cdof, f)
  lower = raw.transpose(-1, -2) * m.dof_ancestor_mask
  qm = (lower + lower.transpose(-1, -2) -
        torch.diag_embed(torch.diagonal(lower, dim1=-2, dim2=-1)))
  return d.replace(qM=qm + torch.diag(m.dof_armature))


def _gravity(m: Model, dtype) -> torch.Tensor:
  if m.opt.disableflags & constants.DisableBit.GRAVITY:
    return torch.zeros(3, dtype=dtype, device=m.device)
  return m.opt.gravity.to(dtype)


def rne(m: Model, d: Data) -> Data:
  """Bias forces: coriolis/centrifugal plus gravity."""
  dtype = d.qpos.dtype
  cacc0 = torch.cat([torch.zeros(3, dtype=dtype, device=m.device),
                     -_gravity(m, dtype)])
  cdd_qvel = d.cdof_dot * d.qvel[..., None]
  cacc = cacc0 + torch.einsum('bv,Bvj->Bbj', m.body_dof_mask, cdd_qvel)
  iv = torch.einsum('Bbij,Bbj->Bbi', d.cinert, d.cvel)
  fb = torch.einsum('Bbij,Bbj->Bbi', d.cinert, cacc) + mops.cross_force(
      d.cvel, iv)
  ftot = _subtree_sum(m, fb)
  qfrc_bias = torch.sum(d.cdof * ftot[:, _dofbody(m)], dim=-1)
  return d.replace(qfrc_bias=qfrc_bias)


# ---------------------------------------------------------------------------
# jacobians
# ---------------------------------------------------------------------------


def jac(m: Model, d: Data, point: torch.Tensor, bodyid: int):
  """Translational and rotational jacobians of world points (B, 3) on one
  body: each (B, 3, nv)."""
  offset = point - d.subtree_com[:, m.body_rootid[bodyid]]
  ang = d.cdof[..., :3]
  lin = d.cdof[..., 3:] + mops.cross(ang, offset[:, None, :])
  mask = m.body_dof_mask[bodyid]
  return ((lin * mask[:, None]).transpose(-1, -2),
          (ang * mask[:, None]).transpose(-1, -2))


def object_velocity(m: Model, d: Data, point: torch.Tensor, bodyid: int):
  """[ang; lin] world-frame velocity (B, 6) of a body-fixed point."""
  vel = d.cvel[:, bodyid]
  offset = point - d.subtree_com[:, m.body_rootid[bodyid]]
  return torch.cat([vel[:, :3], vel[:, 3:] + mops.cross(vel[:, :3], offset)],
                   dim=-1)


# ---------------------------------------------------------------------------
# tendons
# ---------------------------------------------------------------------------


def tendon(m: Model, d: Data) -> Data:
  """Tendon lengths and moment arms (fixed and straight spatial paths)."""
  if not m.ntendon:
    return d
  B, dtype, dev = d.qpos.shape[0], d.qpos.dtype, d.qpos.device
  lengths, jacs = [], []
  for t in range(m.ntendon):
    adr, num = m.tendon_adr[t], m.tendon_num[t]
    wtypes = m.wrap_type[adr:adr + num]
    length = torch.zeros(B, dtype=dtype, device=dev)
    j = torch.zeros((B, m.nv), dtype=dtype, device=dev)
    if all(w == constants.WrapType.JOINT for w in wtypes):
      for k in range(num):
        jid = m.wrap_objid[adr + k]
        coef = m.wrap_prm[adr + k]
        length = length + coef * d.qpos[:, m.jnt_qposadr[jid]]
        j[:, m.jnt_dofadr[jid]] += coef
    else:
      for k in range(num - 1):
        s1, s2 = m.wrap_objid[adr + k], m.wrap_objid[adr + k + 1]
        p1, p2 = d.site_xpos[:, s1], d.site_xpos[:, s2]
        dif = p2 - p1
        seg = mops.norm(dif)
        unit = dif / torch.clamp(seg, min=1e-12)[:, None]
        length = length + seg
        jp1, _ = jac(m, d, p1, m.site_bodyid[s1])
        jp2, _ = jac(m, d, p2, m.site_bodyid[s2])
        j = j + torch.einsum('Bi,Biv->Bv', unit, jp2 - jp1)
    lengths.append(length)
    jacs.append(j)
  return d.replace(ten_length=torch.stack(lengths, dim=1),
                   ten_J=torch.stack(jacs, dim=1))


def tendon_vel(m: Model, d: Data) -> Data:
  if not m.ntendon:
    return d
  return d.replace(
      ten_velocity=torch.einsum('Btv,Bv->Bt', d.ten_J, d.qvel))


# ---------------------------------------------------------------------------
# actuator transmission
# ---------------------------------------------------------------------------


def _trn_schedule(m: Model):
  """Static transmission tables: scalar joints, wide joints, tendons."""

  def make():
    scal_u, scal_q, scal_v, wide, ten_u, ten_t = [], [], [], [], [], []
    for u in range(m.nu):
      trn = m.actuator_trntype[u]
      tid = m.actuator_trnid[u][0]
      if trn == constants.TrnType.JOINT:
        jt = m.jnt_type[tid]
        if jt in (_J.HINGE, _J.SLIDE):
          scal_u.append(u)
          scal_q.append(m.jnt_qposadr[tid])
          scal_v.append(m.jnt_dofadr[tid])
        else:
          wide.append((u, m.jnt_dofadr[tid], 3 if jt == _J.BALL else 6))
      elif trn == constants.TrnType.TENDON:
        ten_u.append(u)
        ten_t.append(tid)
      else:
        # BODY (adhesion) transmission is outside the ported slice
        raise NotImplementedError(f'transmission type {trn}')
    return (_index(m, scal_u), _index(m, scal_q), _index(m, scal_v),
            tuple(wide), _index(m, ten_u), _index(m, ten_t))

  return m.memo('trn_schedule', make)


def transmission(m: Model, d: Data) -> Data:
  """Actuator lengths and moment rows."""
  if not m.nu:
    return d
  B, dtype, dev = d.qpos.shape[0], d.qpos.dtype, d.qpos.device
  scal_u, scal_q, scal_v, wide, ten_u, ten_t = _trn_schedule(m)
  lengths = torch.zeros((B, m.nu), dtype=dtype, device=dev)
  moments = torch.zeros((B, m.nu, m.nv), dtype=dtype, device=dev)
  if len(scal_u):
    gear0 = m.actuator_gear[scal_u, 0]
    lengths[:, scal_u] = d.qpos[:, scal_q] * gear0
    moments[:, scal_u, scal_v] = gear0
  for u, vadr, n in wide:
    moments[:, u, vadr:vadr + n] = m.actuator_gear[u, :n].to(dtype)
  if len(ten_u):
    gear0 = m.actuator_gear[ten_u, 0]
    lengths[:, ten_u] = d.ten_length[:, ten_t] * gear0
    moments[:, ten_u] = d.ten_J[:, ten_t] * gear0[:, None]
  return d.replace(actuator_length=lengths, actuator_moment=moments)


# ---------------------------------------------------------------------------
# passive forces
# ---------------------------------------------------------------------------


def _jnt_type_groups(m: Model):
  """(jids, qadr, vadr) index tensors for scalar, ball and free joints."""

  def make():
    def grp(pred):
      jids = [j for j in range(m.njnt) if pred(m.jnt_type[j])]
      return (_index(m, jids), _index(m, [m.jnt_qposadr[j] for j in jids]),
              _index(m, [m.jnt_dofadr[j] for j in jids]))
    return (grp(lambda t: t in (_J.HINGE, _J.SLIDE)),
            grp(lambda t: t == _J.BALL), grp(lambda t: t == _J.FREE))

  return m.memo('jnt_type_groups', make)


def passive(m: Model, d: Data) -> Data:
  """Joint springs and dampers, tendon springs, and fluid forces."""
  qfrc = torch.zeros_like(d.qvel)
  if m.opt.disableflags & constants.DisableBit.PASSIVE:
    return d.replace(qfrc_passive=qfrc)
  ar3 = m.const('arange3', lambda: np.arange(3))
  ar4 = m.const('arange4', lambda: np.arange(4))
  scalar, ball, free = _jnt_type_groups(m)
  if len(scalar[0]):
    jids, qadr, vadr = scalar
    qfrc[:, vadr] += -m.jnt_stiffness[jids] * (
        d.qpos[:, qadr] - m.qpos_spring[qadr])
  if len(ball[0]):
    jids, qadr, vadr = ball
    q4 = qadr[:, None] + ar4
    dif = mops.quat_sub(d.qpos[:, q4], m.qpos_spring[q4])
    qfrc[:, vadr[:, None] + ar3] += -m.jnt_stiffness[jids][:, None] * dif
  if len(free[0]):
    jids, qadr, vadr = free
    k = m.jnt_stiffness[jids][:, None]
    q3 = qadr[:, None] + ar3
    qfrc[:, vadr[:, None] + ar3] += -k * (d.qpos[:, q3] - m.qpos_spring[q3])
    q4 = qadr[:, None] + 3 + ar4
    difq = mops.quat_sub(d.qpos[:, q4], m.qpos_spring[q4])
    qfrc[:, vadr[:, None] + 3 + ar3] += -k * difq

  qfrc = qfrc - m.dof_damping * d.qvel

  if m.ntendon:
    ref = torch.where(m.tendon_lengthspring[:, 0] < 0, m.tendon_length0,
                      m.tendon_lengthspring[:, 0])
    frc = -m.tendon_stiffness * (d.ten_length - ref)
    frc = frc - m.tendon_damping * d.ten_velocity
    qfrc = qfrc + torch.einsum('Btv,Bt->Bv', d.ten_J, frc)

  # fluid forces (inertia-box model); zero when density and viscosity are
  dtype = d.qpos.dtype
  density = m.opt.density.to(dtype)
  viscosity = m.opt.viscosity.to(dtype)
  offset = d.xipos - d.subtree_com[:, _rootid(m)]
  vang = d.cvel[..., :3]
  vlin = d.cvel[..., 3:] + mops.cross(vang, offset)
  vlin = vlin - m.opt.wind.to(dtype)
  ximat_t = d.ximat.transpose(-1, -2)
  lvel = torch.einsum('Bbij,Bbj->Bbi', ximat_t, vlin)
  lang = torch.einsum('Bbij,Bbj->Bbi', ximat_t, vang)
  inert = m.body_inertia
  mass = torch.clamp(m.body_mass, min=1e-12)
  ii = torch.stack([inert[:, 1] + inert[:, 2] - inert[:, 0],
                    inert[:, 0] + inert[:, 2] - inert[:, 1],
                    inert[:, 0] + inert[:, 1] - inert[:, 2]], dim=-1)
  box = torch.sqrt(torch.clamp(6.0 * ii / mass[:, None], min=1e-12))
  has_mass = (m.body_mass > 1e-12).to(dtype)[:, None]
  diam = torch.mean(box, dim=-1, keepdim=True)
  ltrq = -np.pi * diam ** 3 * viscosity * lang
  lfrc = -3.0 * np.pi * diam * viscosity * lvel
  b0, b1, b2 = box[:, 0:1], box[:, 1:2], box[:, 2:3]
  area = torch.cat([b1 * b2, b0 * b2, b0 * b1], dim=-1)
  lfrc = lfrc - 0.5 * density * area * torch.abs(lvel) * lvel
  brot = torch.cat([b0 * (b1 ** 4 + b2 ** 4), b1 * (b0 ** 4 + b2 ** 4),
                    b2 * (b0 ** 4 + b1 ** 4)], dim=-1)
  ltrq = ltrq - density * brot * torch.abs(lang) * lang / 64.0
  ltrq = ltrq * has_mass
  lfrc = lfrc * has_mass
  wtrq = torch.einsum('Bbij,Bbj->Bbi', d.ximat, ltrq)
  wfrc = torch.einsum('Bbij,Bbj->Bbi', d.ximat, lfrc)
  fs = torch.cat([wtrq + mops.cross(offset, wfrc), wfrc], dim=-1)
  ftot = _subtree_sum(m, fs)
  qfrc = qfrc + torch.sum(d.cdof * ftot[:, _dofbody(m)], dim=-1)
  return d.replace(qfrc_passive=qfrc)
