"""Post-compile calibration: quantities defined at qpos0.

Port of dm_control_tpu/models/calibrate.py. Inverse weights (diagonal
approximations of J M^-1 J' for the constraint impedance model), resting
tendon lengths and equality auxiliary data come from the port's own
position stage (kinematics, com_pos, tendon, crb), run once at qpos0 in
float64 on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from dm_control_tpu_torch.models import constants
from dm_control_tpu_torch.models import types


def calibrate(m: types.Model) -> types.Model:
  """m: a float64 CPU model straight from the builder."""
  from dm_control_tpu_torch.ops import smooth  # deferred: import cycle

  with torch.no_grad():
    d = types.make_data(m, 1, dtype=torch.float64)
    d = smooth.kinematics(m, d)
    d = smooth.com_pos(m, d)
    d = smooth.tendon(m, d)
    d = smooth.crb(m, d)
  np1 = lambda t: t[0].cpu().numpy().astype(np.float64)
  qm = np1(d.qM)
  minv = np.linalg.inv(qm) if m.nv else np.zeros((0, 0))
  dof_invweight0 = np.diag(minv).copy() if m.nv else np.zeros(0)

  # free joints average the inverse-inertia diagonal over the translation
  # and the rotation triple, ball joints over their rotation triple
  for j in range(m.njnt):
    v = int(m.jnt_dofadr[j])
    jt = int(m.jnt_type[j])
    if jt == int(constants.JointType.FREE):
      dof_invweight0[v:v + 3] = dof_invweight0[v:v + 3].mean()
      dof_invweight0[v + 3:v + 6] = dof_invweight0[v + 3:v + 6].mean()
    elif jt == int(constants.JointType.BALL):
      dof_invweight0[v:v + 3] = dof_invweight0[v:v + 3].mean()

  # springdamper joints: k = M/(timeconst*dampratio)^2, d = 2M/timeconst
  # with the apparent joint inertia M = 1/dof_invweight0
  jnt_stiffness = m.jnt_stiffness.cpu().numpy().astype(np.float64).copy()
  dof_damping = m.dof_damping.cpu().numpy().astype(np.float64).copy()
  for j, (tc, dr) in enumerate(m.jnt_springdamper):
    if tc > 0 and dr > 0:
      v = m.jnt_dofadr[j]
      M = 1.0 / max(dof_invweight0[v], 1e-300)
      jnt_stiffness[j] = M / (tc * dr) ** 2
      ndof = {int(constants.JointType.FREE): 6,
              int(constants.JointType.BALL): 3}.get(int(m.jnt_type[j]), 1)
      for k in range(ndof):
        Mk = 1.0 / max(dof_invweight0[v + k], 1e-300)
        dof_damping[v + k] = 2.0 * Mk / tc

  body_ipos = m.body_ipos.cpu().numpy()
  jnt_axis = m.jnt_axis.cpu().numpy()
  body_mass = m.body_mass.cpu().numpy()

  # "simple" leaf bodies (world parent, slide-only orthogonal joints,
  # centered inertia) use 1/mass directly
  def _simple2(b):
    if m.body_parentid[b] != 0:
      return False
    if any(m.body_parentid[c] == b for c in range(1, m.nbody)):
      return False
    jadr, jnum = m.body_jntadr[b], m.body_jntnum[b]
    if jnum == 0:
      return False
    axes = []
    for j in range(jadr, jadr + jnum):
      if m.jnt_type[j] != constants.JointType.SLIDE:
        return False
      axes.append(np.asarray(jnt_axis[j], dtype=np.float64))
    for i in range(len(axes)):
      for k in range(i + 1, len(axes)):
        if abs(np.dot(axes[i], axes[k])) > 1e-10:
          return False
    return bool(np.all(np.abs(body_ipos[b]) < 1e-12))

  cdof = np1(d.cdof)
  xipos = np1(d.xipos)
  scom = np1(d.subtree_com)
  dofmask = m.body_dof_mask.cpu().numpy().astype(np.float64)

  body_invweight0 = np.zeros((m.nbody, 2))
  for b in range(1, m.nbody):
    if _simple2(b):
      body_invweight0[b, 0] = 1.0 / max(float(body_mass[b]), 1e-12)
      continue
    offset = xipos[b] - scom[m.body_rootid[b]]
    ang = cdof[:, :3]
    lin = cdof[:, 3:] + np.cross(ang, offset[None, :])
    jacp = (lin * dofmask[b][:, None]).T
    jacr = (ang * dofmask[b][:, None]).T
    body_invweight0[b, 0] = np.trace(jacp @ minv @ jacp.T) / 3.0
    body_invweight0[b, 1] = np.trace(jacr @ minv @ jacr.T) / 3.0

  tendon_invweight0 = np.zeros(m.ntendon)
  tendon_length0 = np.zeros(m.ntendon)
  if m.ntendon:
    tj = np1(d.ten_J)
    tendon_invweight0 = np.einsum('tv,vw,tw->t', tj, minv, tj)
    tendon_length0 = np1(d.ten_length)

  # equality auxiliary data: connect anchor in body2 frame, weld relpose
  eq_data = m.eq_data.cpu().numpy().astype(np.float64).copy()
  xpos, xmat, xquat = np1(d.xpos), np1(d.xmat), np1(d.xquat)
  for e in range(m.neq):
    b1, b2 = m.eq_obj1id[e], m.eq_obj2id[e]
    if m.eq_type[e] == constants.EqType.CONNECT:
      anchor_world = xpos[b1] + xmat[b1] @ eq_data[e, :3]
      eq_data[e, 3:6] = xmat[b2].T @ (anchor_world - xpos[b2])
    elif m.eq_type[e] == constants.EqType.WELD:
      given = eq_data[e, 3:10]
      if not np.any(given[:3]) and given[3] == 1.0 and not np.any(
          given[4:]):
        relpos = xmat[b2].T @ (xpos[b1] - xpos[b2])
        w1, x1, y1, z1 = xquat[b2] * np.array([1.0, -1, -1, -1])
        w2, x2, y2, z2 = xquat[b1]
        eq_data[e, 3:6] = relpos
        eq_data[e, 6:10] = [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2]

  t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                dtype=m.dtype, device=m.device)
  return m.replace(
      jnt_stiffness=t(jnt_stiffness), dof_damping=t(dof_damping),
      dof_invweight0=t(dof_invweight0), body_invweight0=t(body_invweight0),
      tendon_invweight0=t(tendon_invweight0),
      tendon_length0=t(tendon_length0), eq_data=t(eq_data), consts={})
