"""Constraint rows and the batched primal Newton solver (pyramidal cones).

Port of dm_control_tpu/ops/constraint.py. The row layout is static
(equality rows, joint limits, tendon limits, then contact rows by
ascending condim), inactive rows carry zero weight, and the solver
minimizes

    0.5 (x - a0)' M (x - a0) + 0.5 sum_i D_i s_i(J_i x - aref_i)^2

over qacc x with damped Newton steps and an exact line search. The
Newton direction is one batched SPD solve per iteration
(ops/cuda_kernels.chol_solve_batched).

Equality rows of types JOINT and TENDON are ported; CONNECT and WELD
rows, elliptic cones and frictionloss rows raise NotImplementedError.
Differences from the JAX solver, kept simple for bring-up: the loop runs
every env to convergence or solver_iterations (the JAX B < 1024 branch)
with no straggler-tail compaction, there is no top-K row compaction (the
JAX solver keeps the 64 rows of largest weight when a model has more than
160, so the two agree only where at most 64 rows are live), and the
Hessian is assembled in the working dtype (the JAX float32 path
assembles it in bfloat16).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dm_control_tpu_torch.models import constants
from dm_control_tpu_torch.models.types import Data, Model
from dm_control_tpu_torch.ops import cuda_kernels
from dm_control_tpu_torch.ops import math as mops

_J = constants.JointType
_EQ_PORTED = (constants.EqType.JOINT, constants.EqType.TENDON)


class Rows(NamedTuple):
  J: torch.Tensor          # (B, nv, nefc) transposed Jacobian
  pos: torch.Tensor        # (B, nefc)
  margin: torch.Tensor
  solref: torch.Tensor     # (B, nefc, 2)
  solimp: torch.Tensor     # (B, nefc, 5)
  invweight: torch.Tensor
  slot_active: torch.Tensor  # 1.0 where the row exists this step
  eq: torch.Tensor         # (nefc,) bool: equality rows, always acting


def _check_supported(m: Model):
  dis = m.opt.disableflags
  if not dis & constants.DisableBit.EQUALITY:
    for et in m.eq_type:
      if et not in _EQ_PORTED:
        raise NotImplementedError(
            f'{constants.EqType(et).name} equality rows are not ported')
  if any(m.dof_hasfrictionloss) and not dis & constants.DisableBit.FRICTIONLOSS:
    raise NotImplementedError('frictionloss rows are not ported')
  if (int(m.opt.cone) == int(constants.ConeType.ELLIPTIC) and m.ncon_sel
      and not dis & constants.DisableBit.CONTACT):
    raise NotImplementedError('elliptic cones are not ported')


def _impedance(solimp, pos):
  """Constraint impedance d(pos), solimp = (d0, dmax, width, mid, power)."""
  d0 = torch.clamp(solimp[..., 0], constants.MINIMP, constants.MAXIMP)
  dmax = torch.clamp(solimp[..., 1], constants.MINIMP, constants.MAXIMP)
  width, mid, power = solimp[..., 2], solimp[..., 3], solimp[..., 4]
  x = torch.clamp(torch.abs(pos) / torch.clamp(width, min=1e-12), 0.0, 1.0)
  mid = torch.clamp(mid, 0.0001, 0.9999)
  power = torch.clamp(power, min=1.0)
  a = 1.0 / torch.pow(mid, power - 1.0)
  b = 1.0 / torch.pow(1.0 - mid, power - 1.0)
  y = torch.where(x < mid, a * torch.pow(x, power),
                  1.0 - b * torch.pow(1.0 - x, power))
  d = d0 + y * (dmax - d0)
  return torch.clamp(d, constants.MINIMP, constants.MAXIMP)


def _kbip(m: Model, solref, solimp, imp, pos_minus_margin, vel):
  """Reference acceleration aref per row."""
  dmax = solimp[..., 1]
  timeconst = solref[..., 0]
  dampratio = solref[..., 1]
  if not m.opt.disableflags & constants.DisableBit.REFSAFE:
    timeconst = torch.maximum(timeconst,
                              2.0 * m.opt.timestep.to(timeconst.dtype))
  b_std = 2.0 / torch.clamp(dmax * timeconst, min=1e-12)
  k_std = 1.0 / torch.clamp(
      dmax * dmax * timeconst * timeconst * dampratio * dampratio, min=1e-12)
  dmax_sq = torch.clamp(dmax * dmax, min=1e-12)
  b = torch.where(solref[..., 1] <= 0,
                  -solref[..., 1] / torch.clamp(dmax, min=1e-12), b_std)
  k = torch.where(solref[..., 0] <= 0, -solref[..., 0] / dmax_sq, k_std)
  return -b * vel - k * imp * pos_minus_margin


def _contact_condim_groups(m: Model):
  return sorted(set(m.sel_condim))


def _limit_schedule(m: Model):

  def make():
    lim = [j for j in range(m.njnt) if m.jnt_limited[j]]
    sl_j = [j for j in lim if m.jnt_type[j] in (_J.HINGE, _J.SLIDE)]
    ball_j = [j for j in lim if m.jnt_type[j] == _J.BALL]
    tl = [t for t in range(m.ntendon) if m.tendon_limited[t]]
    ix = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=m.device)
    onehot = np.zeros((m.nv, len(sl_j)))
    onehot[[m.jnt_dofadr[j] for j in sl_j], np.arange(len(sl_j))] = 1.0
    return dict(
        sl_j=ix(sl_j), sl_q=ix([m.jnt_qposadr[j] for j in sl_j]),
        sl_v=ix([m.jnt_dofadr[j] for j in sl_j]),
        sl_onehot=torch.as_tensor(onehot, dtype=m.dtype, device=m.device),
        ball_j=ix(ball_j), ball_q=ix([m.jnt_qposadr[j] for j in ball_j]),
        ball_v=ix([m.jnt_dofadr[j] for j in ball_j]), tl=ix(tl))

  return m.memo('limit_schedule', make)


def make_rows(m: Model, d: Data) -> Rows:
  """Assemble all constraint rows of the batch (static layout)."""
  _check_supported(m)
  B, dtype, dev = d.qpos.shape[0], d.qpos.dtype, d.qpos.device
  nv = m.nv
  disable = m.opt.disableflags
  # (J (B, nv, k), pos, margin, solref, solimp, iw, active), equality
  # rows first
  parts = []
  n_eq = 0

  def bcast(x, *shape):
    return x.expand((B,) + shape)

  if m.neq and not disable & constants.DisableBit.EQUALITY:
    parts.append(_equality_rows(m, d))
    n_eq = m.neq

  if not disable & constants.DisableBit.LIMIT:
    ls = _limit_schedule(m)
    k = len(ls['sl_j'])
    if k:
      j = ls['sl_j']
      q = d.qpos[:, ls['sl_q']]
      lo = q - m.jnt_range[j, 0]
      hi = m.jnt_range[j, 1] - q
      dist = torch.minimum(lo, hi)
      sign = torch.where(lo < hi, 1.0, -1.0).to(dtype)
      margin = bcast(m.jnt_margin[j], k)
      parts.append((ls['sl_onehot'] * sign[:, None, :], dist, margin,
                    bcast(m.jnt_solref[j], k, 2),
                    bcast(m.jnt_solimp[j], k, 5),
                    bcast(m.dof_invweight0[ls['sl_v']], k),
                    (dist < margin).to(dtype)))
    k = len(ls['ball_j'])
    if k:
      j = ls['ball_j']
      ar3 = torch.arange(3, device=dev)
      ar4 = torch.arange(4, device=dev)
      q4 = d.qpos[:, ls['ball_q'][:, None] + ar4]
      axisangle = mops.quat_to_vel(q4)
      angle = mops.norm(axisangle)
      axis = axisangle / torch.clamp(angle, min=1e-12)[..., None]
      limit = torch.maximum(torch.abs(m.jnt_range[j, 0]),
                            torch.abs(m.jnt_range[j, 1]))
      dist = limit - angle
      Jblk = torch.zeros((B, nv, k), dtype=dtype, device=dev)
      Jblk[:, ls['ball_v'][:, None] + ar3, torch.arange(k, device=dev)[
          :, None]] = -axis
      margin = bcast(m.jnt_margin[j], k)
      parts.append((Jblk, dist, margin, bcast(m.jnt_solref[j], k, 2),
                    bcast(m.jnt_solimp[j], k, 5),
                    bcast(m.dof_invweight0[ls['ball_v']], k),
                    (dist < margin).to(dtype)))
    k = len(ls['tl'])
    if k:
      t = ls['tl']
      lo = d.ten_length[:, t] - m.tendon_range[t, 0]
      hi = m.tendon_range[t, 1] - d.ten_length[:, t]
      dist = torch.minimum(lo, hi)
      sign = torch.where(lo < hi, 1.0, -1.0).to(dtype)
      margin = bcast(m.tendon_margin[t], k)
      parts.append((d.ten_J[:, t].transpose(-1, -2) * sign[:, None, :],
                    dist, margin, bcast(m.tendon_solref_lim[t], k, 2),
                    bcast(m.tendon_solimp_lim[t], k, 5),
                    bcast(m.tendon_invweight0[t], k),
                    (dist < margin).to(dtype)))

  if not disable & constants.DisableBit.CONTACT and m.ncon_sel:
    parts.extend(_contact_rows(m, d))

  if not parts:
    z = torch.zeros((B, 0), dtype=dtype, device=dev)
    return Rows(torch.zeros((B, nv, 0), dtype=dtype, device=dev), z, z,
                torch.zeros((B, 0, 2), dtype=dtype, device=dev),
                torch.zeros((B, 0, 5), dtype=dtype, device=dev), z, z,
                torch.zeros(0, dtype=torch.bool, device=dev))
  cols = list(zip(*parts))
  J = torch.cat(cols[0], dim=-1)
  eq = torch.arange(J.shape[-1], device=dev) < n_eq
  return Rows(J, *[torch.cat(c, dim=1) for c in cols[1:]], eq)


def _equality_rows(m: Model, d: Data):
  """One row per JOINT or TENDON equality, in the model's order: a joint
  held at a polynomial of another joint (or at a constant), a tendon
  held at its rest length plus a constant."""
  B, dtype, dev = d.qpos.shape[0], d.qpos.dtype, d.qpos.device
  cols, pos, iw = [], [], []
  for e in range(m.neq):
    if m.eq_type[e] == constants.EqType.JOINT:
      j1, j2 = m.eq_obj1id[e], m.eq_obj2id[e]
      poly = m.eq_data[e, :5]
      q1, v1 = m.jnt_qposadr[j1], m.jnt_dofadr[j1]
      col = torch.zeros((B, m.nv), dtype=dtype, device=dev)
      col[:, v1] = 1.0
      if j2 >= 0:
        q2, v2 = m.jnt_qposadr[j2], m.jnt_dofadr[j2]
        dif = d.qpos[:, q2] - m.qpos0[q2]
        rhs = sum(poly[i] * dif ** i for i in range(5))
        col[:, v2] = -sum(poly[i] * (i * dif ** (i - 1)) for i in range(1, 5))
        pos.append(d.qpos[:, q1] - m.qpos0[q1] - rhs)
        iw.append(m.dof_invweight0[v1] + m.dof_invweight0[v2])
      else:
        pos.append(d.qpos[:, q1] - m.qpos0[q1] - poly[0])
        iw.append(m.dof_invweight0[v1])
      cols.append(col)
    else:
      t = m.eq_obj1id[e]
      cols.append(d.ten_J[:, t])
      pos.append(d.ten_length[:, t] - m.tendon_length0[t] - m.eq_data[e, 0])
      iw.append(m.tendon_invweight0[t])
  k = m.neq
  return (torch.stack(cols, dim=-1), torch.stack(pos, dim=-1),
          torch.zeros((B, k), dtype=dtype, device=dev),
          m.eq_solref.expand(B, k, 2), m.eq_solimp.expand(B, k, 5),
          torch.stack(iw).expand(B, k), m.eq_active0.expand(B, k))


def _contact_rows(m: Model, d: Data):
  """Pyramidal contact rows, one block per condim group."""
  con = d.contact
  B, dtype = d.qpos.shape[0], d.qpos.dtype
  nv = m.nv
  gbody = m.const('geom_bodyid', lambda: m.geom_bodyid)
  rootid = m.const('body_rootid', lambda: m.body_rootid)
  b1s = gbody[con.geom1]                               # (B, s)
  b2s = gbody[con.geom2]
  root_com = d.subtree_com[:, rootid]                  # (B, nb, 3)
  idx3 = lambda b: b[..., None].expand(b.shape + (3,))
  off1 = con.pos - torch.gather(root_com, 1, idx3(b1s))
  off2 = con.pos - torch.gather(root_com, 1, idx3(b2s))
  mask1_t = m.body_dof_mask[b1s].transpose(-1, -2)     # (B, nv, s)
  mask2_t = m.body_dof_mask[b2s].transpose(-1, -2)
  dm_t = mask2_t - mask1_t
  ang = d.cdof[..., :3]                                # (B, nv, 3)
  lin = d.cdof[..., 3:]
  # translational jacobian difference per world axis (B, nv, s)
  qq = [mask2_t * off2[:, None, :, b] - mask1_t * off1[:, None, :, b]
        for b in range(3)]
  jd = []
  for j in range(3):
    a, b = (j + 1) % 3, (j + 2) % 3
    jd.append(dm_t * lin[..., j:j + 1] + ang[..., a:a + 1] * qq[b] -
              ang[..., b:b + 1] * qq[a])
  frame = con.frame
  jn = [frame[:, None, :, i, 0] * jd[0] + frame[:, None, :, i, 1] * jd[1] +
        frame[:, None, :, i, 2] * jd[2] for i in range(3)]
  groups = _contact_condim_groups(m)
  if any(c >= 4 for c in groups):
    jrd = [dm_t * ang[..., j:j + 1] for j in range(3)]
    jr = [frame[:, None, :, i, 0] * jrd[0] + frame[:, None, :, i, 1] *
          jrd[1] + frame[:, None, :, i, 2] * jrd[2] for i in range(3)]
  biw = m.body_invweight0[:, 0]
  iw_all = biw[b1s] + biw[b2s]                         # (B, s)

  parts = []
  for c in groups:
    slots = [s for s in range(m.ncon_sel) if m.sel_condim[s] == c]
    k = len(slots)
    sl = (slice(None) if k == m.ncon_sel else
          m.const(('condim_slots', c), lambda: slots))
    dist = con.dist[:, sl]
    margin = con.includemargin[:, sl]
    active = con.active[:, sl].to(dtype)
    solref = con.solref[:, sl]
    solimp = con.solimp[:, sl]
    iw = iw_all[:, sl]
    if c == 1:
      parts.append((jn[0][:, :, sl], dist, margin, solref, solimp, iw,
                    active))
      continue
    naxes = c - 1
    axes = [jn[1][:, :, sl], jn[2][:, :, sl]]
    if c >= 4:
      axes.append(jr[0][:, :, sl])
      if c >= 6:
        axes += [jr[1][:, :, sl], jr[2][:, :, sl]]
    axes = torch.stack(axes[:naxes], dim=3)            # (B, nv, k, naxes)
    mu = con.friction[:, sl, :naxes]                   # (B, k, naxes)
    normal = jn[0][:, :, sl][..., None]                # (B, nv, k, 1)
    plus = normal + mu[:, None] * axes
    minus = normal - mu[:, None] * axes
    rows = torch.stack([plus, minus], dim=4).reshape(B, nv, k * naxes * 2)
    rep = lambda x: torch.repeat_interleave(x, naxes * 2, dim=1)
    # pyramidal regularizer weight: 2 mu^2 (1 + mu^2) (iw1 + iw2)
    iw_pyr = iw[..., None] * 2.0 * mu * mu * (1.0 + mu * mu)
    parts.append((rows, rep(dist), rep(margin), rep(solref), rep(solimp),
                  torch.repeat_interleave(iw_pyr.reshape(B, -1), 2, dim=1),
                  rep(active)))
  return parts


def _num_noncontact_rows(m: Model) -> int:
  n = 0
  if not m.opt.disableflags & constants.DisableBit.EQUALITY:
    n += m.neq   # JOINT and TENDON equalities: one row each
  if not m.opt.disableflags & constants.DisableBit.LIMIT:
    n += sum(1 for j in range(m.njnt) if m.jnt_limited[j])
    n += sum(1 for t in range(m.ntendon) if m.tendon_limited[t])
  return n


def _contact_forces(m: Model, d: Data, force: torch.Tensor):
  """Per-slot contact-frame forces (B, ncon_sel, 3) from row forces."""
  B = force.shape[0]
  confrc = force.new_zeros((B, m.ncon_sel, 3))
  if m.ncon_sel == 0 or m.opt.disableflags & constants.DisableBit.CONTACT:
    return confrc
  idx = _num_noncontact_rows(m)
  for c in _contact_condim_groups(m):
    slots = m.const(('condim_slots', c), lambda: [
        s for s in range(m.ncon_sel) if m.sel_condim[s] == c])
    k = len(slots)
    if c == 1:
      confrc[:, slots, 0] = force[:, idx:idx + k]
      idx += k
      continue
    naxes = c - 1
    grp = force[:, idx:idx + k * naxes * 2].reshape(B, k, naxes, 2)
    mu = d.contact.friction[:, slots, :naxes]
    ft = mu * (grp[..., 0] - grp[..., 1])
    confrc[:, slots, 0] = torch.sum(grp, dim=(2, 3))
    confrc[:, slots, 1] = ft[..., 0]
    if naxes >= 2:
      confrc[:, slots, 2] = ft[..., 1]
    idx += k * naxes * 2
  return confrc


def _unconstrained(m: Model, D: Data) -> Data:
  B = D.qpos.shape[0]
  return D.replace(
      qacc=D.qacc_smooth, qfrc_constraint=torch.zeros_like(D.qacc_smooth),
      efc_force=D.qpos.new_zeros((B, m.nefc_max)),
      qacc_warmstart=D.qacc_smooth)


def fwd_constraint_batched(m: Model, D: Data,
                           compute_forces: bool = True) -> Data:
  """Constrained qacc for the whole batch by primal Newton iterations."""
  if m.opt.disableflags & constants.DisableBit.CONSTRAINT:
    return _unconstrained(m, D)
  rows = make_rows(m, D)
  nefc = rows.J.shape[-1]
  if nefc == 0:
    return _unconstrained(m, D)
  dtype = D.qpos.dtype
  B = D.qpos.shape[0]
  J = rows.J

  pmm = rows.pos - rows.margin
  imp = _impedance(rows.solimp, pmm)
  vel = torch.einsum('bv,bve->be', D.qvel, J)
  aref = _kbip(m, rows.solref, rows.solimp, imp, pmm, vel)
  r = torch.clamp((1.0 - imp) / imp * rows.invweight, min=1e-12)
  dweight = torch.where(rows.slot_active > 0, 1.0 / r, torch.zeros_like(r))

  M = D.qM
  a0 = D.qacc_smooth

  def jmul(x):
    return torch.einsum('bv,bve->be', x, J)

  def jtmul(f):
    return torch.einsum('bve,be->bv', J, f)

  def mmul(x):
    return torch.einsum('bij,bj->bi', M, x)

  def row_weight(jar):
    # equality rows always act, inequality rows only while violated
    return torch.where(rows.eq | (jar < 0), dweight, torch.zeros_like(dweight))

  def row_cost(jar):
    return torch.sum(0.5 * row_weight(jar) * jar * jar, dim=-1)

  def row_force(jar):
    return -row_weight(jar) * jar

  # start from the warmstart where it is finite and cheaper than qacc_smooth
  ws = torch.where(torch.isfinite(D.qacc_warmstart).all(-1, keepdim=True),
                   D.qacc_warmstart, a0)
  jar_ws = jmul(ws) - aref
  jar_a0 = jmul(a0) - aref
  dv_ws = ws - a0
  cost_ws = 0.5 * torch.sum(dv_ws * mmul(dv_ws), dim=-1) + row_cost(jar_ws)
  cost_a0 = row_cost(jar_a0)
  use_ws = cost_ws < cost_a0
  x = torch.where(use_ws[:, None], ws, a0)
  jar = torch.where(use_ws[:, None], jar_ws, jar_a0)
  cost = torch.where(use_ws, cost_ws, cost_a0)

  tol = m.opt.tolerance.to(dtype)
  ls_iters = min(m.opt.ls_iterations, 8)
  # improvements below ~8 eps |cost| are rounding noise
  eps = torch.finfo(dtype).eps
  scale = torch.clamp(
      torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) / max(m.nv, 1), min=1e-12)
  done = torch.zeros(B, dtype=torch.bool, device=D.qpos.device)
  niter = 0
  while niter < m.opt.solver_iterations and not bool(done.all()):
    w = row_weight(jar)
    m_dx = mmul(x - a0)
    grad = m_dx - jtmul(row_force(jar))
    H = M + torch.einsum('bve,be,bwe->bvw', J, w, J)
    p = -cuda_kernels.chol_solve_batched(H, grad)
    jp = jmul(p)
    m_p = mmul(p)
    pMp = torch.sum(p * m_p, dim=-1)
    pM_dx = torch.sum(p * m_dx, dim=-1)
    # exact line search on the piecewise quadratic phi(alpha): Newton on
    # phi' inside a sign bracket, bisecting when Newton leaves it
    alpha = torch.ones(B, dtype=dtype, device=x.device)
    lo = torch.zeros_like(alpha)
    hi = torch.full_like(alpha, 4.0)
    for _ in range(ls_iters):
      ra = jar + alpha[:, None] * jp
      wr = row_weight(ra)
      dphi = pM_dx + alpha * pMp - torch.sum(-wr * ra * jp, dim=-1)
      ddphi = pMp + torch.sum(wr * jp * jp, dim=-1)
      lo = torch.where(dphi < 0, torch.maximum(lo, alpha), lo)
      hi = torch.where(dphi > 0, torch.minimum(hi, alpha), hi)
      newton = alpha - dphi / torch.clamp(ddphi, min=1e-12)
      inside = (newton > lo) & (newton < hi)
      alpha = torch.where(inside, newton, 0.5 * (lo + hi))
    alpha = torch.clamp(alpha, 0.0, 4.0)
    x_new = x + alpha[:, None] * p
    jar_new = jar + alpha[:, None] * jp
    m_dvn = m_dx + alpha[:, None] * m_p
    cost_new = 0.5 * torch.sum((x_new - a0) * m_dvn, dim=-1) + row_cost(
        jar_new)
    improved = (cost_new < cost) & ~done
    x = torch.where(improved[:, None], x_new, x)
    jar = torch.where(improved[:, None], jar_new, jar)
    thresh = torch.maximum(tol * scale, 8 * eps * torch.abs(cost))
    done = done | ~((cost - cost_new) >= thresh) | ~torch.isfinite(cost_new)
    cost = torch.where(improved, cost_new, cost)
    niter += 1

  force = row_force(jar)
  D = D.replace(
      qacc=x, qfrc_constraint=jtmul(force), qacc_warmstart=x,
      solver_niter=torch.full((B,), niter, dtype=torch.int64,
                              device=x.device))
  if not compute_forces:
    return D
  efc_force = force.new_zeros((B, m.nefc_max))
  efc_force[:, :nefc] = force
  return D.replace(efc_force=efc_force, contact=D.contact.replace(
      force=_contact_forces(m, D, force)))
