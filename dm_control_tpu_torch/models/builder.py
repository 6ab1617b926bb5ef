# Port of dm_control_tpu/models/builder.py: numpy instead of jnp dtypes,
# and no renderer-only material/texture tables.
"""Second compiler stage: parsed MJCF spec -> device-resident Model.

Assigns qpos/dof addresses, computes body inertials from geoms, builds the
static topology metadata + dense structure masks, enumerates the compile-time
contact candidate list, sizes the padded contact/constraint buffers, and
assembles the `types.Model` pytree.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import numpy as np

from dm_control_tpu_torch.models import compiler as compiler_lib
from dm_control_tpu_torch.models import constants
from dm_control_tpu_torch.models import names as names_lib
from dm_control_tpu_torch.models import types

_J = constants.JointType
_G = constants.GeomType


def _principal_inertia(mass: float, fullinertia: np.ndarray,
                       com: np.ndarray, balance: bool):
  """Diagonalize a body inertia tensor -> (diag3, iquat)."""
  if mass <= 0.0:
    return np.zeros(3), np.array([1.0, 0, 0, 0])
  offdiag = fullinertia - np.diag(np.diag(fullinertia))
  if np.abs(offdiag).max() <= 1e-10 * max(np.abs(fullinertia).max(), 1e-12):
    # already principal: keep the axis order (matches oracle compiler)
    return np.maximum(np.diag(fullinertia), 0.0), np.array([1.0, 0, 0, 0])
  w, v = np.linalg.eigh(fullinertia)
  # descending eigenvalues
  order = np.argsort(w)[::-1]
  w = w[order]
  v = v[:, order]
  if np.linalg.det(v) < 0:
    v[:, 2] = -v[:, 2]
  if balance:
    # enforce the triangle inequality by lifting the small moments
    for _ in range(2):
      if w[0] > w[1] + w[2]:
        delta = (w[0] - w[1] - w[2]) / 2 + 1e-12
        w[1] += delta
        w[2] += delta
  q = compiler_lib._quat_from_mat(v)
  return np.maximum(w, 0.0), q


def build(c: compiler_lib.Compiler, dtype=torch.float32,
          contact_budget=None, device='cpu') -> types.Model:
  """Parsed MJCF spec -> Model with float64-computed parameters, cast to
  `dtype` on `device` (calibration runs afterwards, see calibrate.py)."""
  nbody = len(c.bodies)
  njnt = len(c.joints)
  ngeom = len(c.geoms)
  nsite = len(c.sites)

  # ---------------- joint addressing ----------------
  jnt_qposadr, jnt_dofadr = [], []
  nq = nv = 0
  for j in c.joints:
    jnt_qposadr.append(nq)
    jnt_dofadr.append(nv)
    nq += constants.QPOS_WIDTH[_J(j.jtype)]
    nv += constants.DOF_WIDTH[_J(j.jtype)]

  body_jntadr = [-1] * nbody
  body_jntnum = [0] * nbody
  body_dofadr = [-1] * nbody
  body_dofnum = [0] * nbody
  for ji, j in enumerate(c.joints):
    b = j.bodyid
    if body_jntnum[b] == 0:
      body_jntadr[b] = ji
      body_dofadr[b] = jnt_dofadr[ji]
    elif body_jntadr[b] + body_jntnum[b] != ji:
      raise ValueError('joints of one body must be contiguous')
    body_jntnum[b] += 1
    body_dofnum[b] += constants.DOF_WIDTH[_J(j.jtype)]

  body_parentid = [b.parentid if b.parentid >= 0 else 0 for b in c.bodies]
  body_rootid = [0] * nbody
  body_weldid = [0] * nbody
  body_treelevel = [0] * nbody
  for i in range(1, nbody):
    p = body_parentid[i]
    body_treelevel[i] = body_treelevel[p] + 1
    body_rootid[i] = i if p == 0 else body_rootid[p]
    body_weldid[i] = i if body_jntnum[i] > 0 else body_weldid[p]

  # dof tables
  dof_bodyid = np.zeros(nv, dtype=int)
  dof_jntid = np.zeros(nv, dtype=int)
  dof_armature = np.zeros(nv)
  dof_damping = np.zeros(nv)
  dof_frictionloss = np.zeros(nv)
  for ji, j in enumerate(c.joints):
    adr = jnt_dofadr[ji]
    w = constants.DOF_WIDTH[_J(j.jtype)]
    dof_bodyid[adr:adr + w] = j.bodyid
    dof_jntid[adr:adr + w] = ji
    dof_armature[adr:adr + w] = j.armature
    dof_damping[adr:adr + w] = j.damping
    dof_frictionloss[adr:adr + w] = j.frictionloss

  # dof_parentid: previous dof within same joint, else last dof of the
  # nearest ancestor body that has dofs, else -1.
  last_body_dof = [-1] * nbody  # last dof index of body's chain incl. self
  for b in range(1, nbody):
    p = body_parentid[b]
    prev = last_body_dof[p]
    if body_dofnum[b] > 0:
      last_body_dof[b] = body_dofadr[b] + body_dofnum[b] - 1
    else:
      last_body_dof[b] = prev
  dof_parentid = np.full(nv, -1, dtype=int)
  for b in range(1, nbody):
    if body_dofnum[b] == 0:
      continue
    prev = last_body_dof[body_parentid[b]]
    for d in range(body_dofadr[b], body_dofadr[b] + body_dofnum[b]):
      dof_parentid[d] = prev
      prev = d

  # ---------------- body inertial properties ----------------
  body_mass = np.zeros(nbody)
  body_ipos = np.zeros((nbody, 3))
  body_iquat = np.tile(np.array([1.0, 0, 0, 0]), (nbody, 1))
  body_inertia = np.zeros((nbody, 3))

  geoms_by_body: Dict[int, List[int]] = {}
  for gi, g in enumerate(c.geoms):
    geoms_by_body.setdefault(g.bodyid, []).append(gi)

  # geom masses (needed for settotalmass even when inertial is explicit)
  def _gvolume(g):
    if g.mesh is not None:
      return g.mesh.volume
    return compiler_lib._geom_volume(g.gtype, g.size)

  def _gidiag(g, mass):
    if g.mesh is not None:
      return g.mesh.geom_inertia(mass)
    return compiler_lib._geom_inertia_diag(g.gtype, g.size, mass)

  geom_mass = np.zeros(ngeom)
  for gi, g in enumerate(c.geoms):
    if g.mass is not None:
      geom_mass[gi] = g.mass
    else:
      geom_mass[gi] = g.density * _gvolume(g)

  use_geoms_for = lambda b: (
      c.inertiafromgeom == 'true' or
      (c.inertiafromgeom == 'auto' and not b.explicit_inertial))

  for bi in range(1, nbody):
    b = c.bodies[bi]
    if use_geoms_for(b):
      glist = [gi for gi in geoms_by_body.get(bi, [])
               if c.inertiagrouprange[0] <= c.geoms[gi].group <=
               c.inertiagrouprange[1]]
      total = sum(geom_mass[gi] for gi in glist)
      if total <= 0.0:
        continue
      com = sum(geom_mass[gi] * c.geoms[gi].pos for gi in glist) / total
      body_mass[bi] = total
      body_ipos[bi] = com
      massive = [gi for gi in glist if geom_mass[gi] > 0]
      if len(massive) == 1:
        # single massive geom: its frame IS the inertial frame (matches
        # the oracle compiler, which skips diagonalization here)
        g = c.geoms[massive[0]]
        body_inertia[bi] = _gidiag(g, geom_mass[massive[0]])
        body_iquat[bi] = g.quat
        continue
      inertia = np.zeros((3, 3))
      for gi in glist:
        g = c.geoms[gi]
        diag = _gidiag(g, geom_mass[gi])
        rot = compiler_lib._quat_to_mat(g.quat)
        ig = rot @ np.diag(diag) @ rot.T
        r = g.pos - com
        ig += geom_mass[gi] * (np.dot(r, r) * np.eye(3) - np.outer(r, r))
        inertia += ig
      body_inertia[bi], body_iquat[bi] = _principal_inertia(
          total, inertia, com, c.balanceinertia)
    else:
      body_mass[bi] = b.mass
      body_ipos[bi] = b.ipos
      if np.any(b.fullinertia != 0):
        # inertia given in the inertial frame already
        rot = compiler_lib._quat_to_mat(b.iquat)
        full = rot @ b.fullinertia @ rot.T if np.any(
            b.fullinertia != np.diag(np.diag(b.fullinertia))) else None
        if full is None:
          body_inertia[bi] = np.diag(b.fullinertia)
          body_iquat[bi] = b.iquat
        else:
          body_inertia[bi], body_iquat[bi] = _principal_inertia(
              b.mass, full, b.ipos, c.balanceinertia)
      else:
        body_iquat[bi] = b.iquat

  # bound mass/inertia
  if c.boundmass > 0:
    body_mass[1:] = np.maximum(body_mass[1:], c.boundmass)
  if c.boundinertia > 0:
    body_inertia[1:] = np.maximum(body_inertia[1:], c.boundinertia)

  # settotalmass
  if c.settotalmass > 0:
    total = body_mass.sum()
    if total > 0:
      scale = c.settotalmass / total
      body_mass *= scale
      body_inertia *= scale

  # subtree masks & masses
  subtree_mask = np.zeros((nbody, nbody))
  for b in range(nbody):
    cur = b
    while cur >= 0:
      subtree_mask[cur, b] = 1.0
      if cur == 0:
        break
      cur = body_parentid[cur]
  body_subtreemass = subtree_mask @ body_mass

  # dof / body masks
  body_dof_mask = np.zeros((nbody, nv))
  for b in range(1, nbody):
    cur = b
    while cur != 0:
      adr, num = body_dofadr[cur], body_dofnum[cur]
      if num > 0:
        body_dof_mask[b, adr:adr + num] = 1.0
      cur = body_parentid[cur]
  dof_ancestor_mask = np.zeros((nv, nv))
  for d in range(nv):
    cur = d
    while cur >= 0:
      dof_ancestor_mask[d, cur] = 1.0
      cur = dof_parentid[cur]
  qM_mask = ((dof_ancestor_mask + dof_ancestor_mask.T) > 0).astype(
      np.float64)

  # partial-velocity mask for cdof_dot (see smooth.com_vel)
  dof_vel_mask = np.zeros((nv, nv))
  for di in range(nv):
    ji = dof_jntid[di]
    jadr = jnt_dofadr[ji]
    jwidth = constants.DOF_WIDTH[_J(c.joints[ji].jtype)]
    for dj in range(nv):
      if not dof_ancestor_mask[di, dj] or dj == di:
        continue
      same_joint = jadr <= dj < jadr + jwidth
      if not same_joint:
        dof_vel_mask[di, dj] = 1.0
      elif (c.joints[ji].jtype == _J.FREE and di - jadr >= 3
            and dj - jadr < 3):
        # free-joint rotation sees the joint's own translation velocity
        dof_vel_mask[di, dj] = 1.0

  # ---------------- qpos0 / qpos_spring ----------------
  qpos0 = np.zeros(nq)
  qpos_spring = np.zeros(nq)
  for ji, j in enumerate(c.joints):
    adr = jnt_qposadr[ji]
    if j.jtype == _J.FREE:
      qpos0[adr:adr + 3] = c.bodies[j.bodyid].pos
      qpos0[adr + 3:adr + 7] = c.bodies[j.bodyid].quat
      qpos_spring[adr:adr + 7] = qpos0[adr:adr + 7]
    elif j.jtype == _J.BALL:
      qpos0[adr:adr + 4] = [1, 0, 0, 0]
      qpos_spring[adr:adr + 4] = [1, 0, 0, 0]
    else:
      qpos0[adr] = j.ref
      qpos_spring[adr] = j.springref

  # ---------------- name tables ----------------
  names = names_lib.Names({
      'body': tuple(b.name for b in c.bodies),
      'joint': tuple(j.name for j in c.joints),
      'geom': tuple(g.name for g in c.geoms),
      'site': tuple(s['name'] for s in c.sites),
      'camera': tuple(cam['name'] for cam in c.cams),
      'light': tuple(c.lights),
      'actuator': tuple(a['name'] for a in c.actuators),
      'tendon': tuple(t['name'] for t in c.tendons),
      'sensor': tuple(s['name'] for s in c.sensors),
      'equality': tuple(e['name'] for e in c.equalities),
      'key': tuple(k['name'] for k in c.keys),
  })

  def _resolve(ns: str, name: str) -> int:
    return names.name2id(ns, name)

  # ---------------- tendons ----------------
  ntendon = len(c.tendons)
  tendon_adr, tendon_num = [], []
  wrap_type, wrap_objid, wrap_prm = [], [], []
  for t in c.tendons:
    tendon_adr.append(len(wrap_type))
    tendon_num.append(len(t['wraps']))
    for (wt, target, prm) in t['wraps']:
      wrap_type.append(wt)
      if wt == constants.WrapType.JOINT:
        wrap_objid.append(_resolve('joint', target))
      elif wt == constants.WrapType.SITE:
        wrap_objid.append(_resolve('site', target))
      else:
        wrap_objid.append(-1)
      wrap_prm.append(prm)
  nwrap = len(wrap_type)

  # ---------------- actuators ----------------
  nu = len(c.actuators)
  actuator_trnid = []
  actuator_actadr, actuator_actnum = [], []
  na = 0
  for a in c.actuators:
    actuator_trnid.append((_resolve(a['target_ns'], a['target']), -1))
    if a['dyntype'] == constants.DynType.NONE:
      actuator_actadr.append(-1)
      actuator_actnum.append(0)
    else:
      actuator_actadr.append(na)
      actuator_actnum.append(1)
      na += 1

  # ---------------- sensors ----------------
  sensor_adr, nsensordata = [], 0
  sensor_objid, sensor_objtype = [], []
  _OBJ = constants.ObjType
  ns_to_objtype = {'body': _OBJ.BODY, 'joint': _OBJ.JOINT, 'geom': _OBJ.GEOM,
                   'site': _OBJ.SITE, 'camera': _OBJ.CAMERA,
                   'tendon': _OBJ.TENDON, 'actuator': _OBJ.ACTUATOR}
  for s in c.sensors:
    sensor_adr.append(nsensordata)
    nsensordata += s['dim']
    if s['target_ns'] is None or not s['target']:
      sensor_objid.append(-1)
      sensor_objtype.append(-1)
    else:
      sensor_objid.append(_resolve(s['target_ns'], s['target']))
      sensor_objtype.append(int(ns_to_objtype[s['target_ns']]))

  # ---------------- equality ----------------
  neq = len(c.equalities)
  eq_obj1id, eq_obj2id = [], []
  for e in c.equalities:
    eq_obj1id.append(_resolve(e['ns'], e['obj1']) if e['obj1'] else -1)
    if e['ns'] == 'body' and e['obj2'] == 'world':
      eq_obj2id.append(0)
    else:
      eq_obj2id.append(_resolve(e['ns'], e['obj2']) if e['obj2'] else -1)

  # ---------------- contact candidate pairs ----------------
  geom_types = [g.gtype for g in c.geoms]
  exclude_body_pairs = set()
  for (b1, b2) in c.excludes:
    i1, i2 = _resolve('body', b1), _resolve('body', b2)
    exclude_body_pairs.add((min(i1, i2), max(i1, i2)))

  filterparent = not (c.option['disableflags'] &
                      constants.DisableBit.FILTERPARENT)
  pair_geom1, pair_geom2, pair_condim, pair_explicit = [], [], [], []

  def _add_pair(g1, g2, condim, explicit_idx):
    t1, t2 = geom_types[g1], geom_types[g2]
    if t1 > t2:
      g1, g2 = g2, g1
      t1, t2 = t2, t1
    if (t1, t2) not in _PAIR_NCON_LOCAL:
      import warnings
      n1 = c.geoms[g1].name or f'geom#{g1}'
      n2 = c.geoms[g2].name or f'geom#{g2}'
      def _tname(t):
        try:
          return constants.GeomType(t).name.lower()
        except ValueError:
          return str(t)
      warnings.warn(
          f'no narrowphase kernel for geom pair ({n1}:{_tname(t1)}, '
          f'{n2}:{_tname(t2)}); these geoms will interpenetrate '
          'without contact forces', stacklevel=2)
      return False
    pair_geom1.append(g1)
    pair_geom2.append(g2)
    pair_condim.append(condim)
    pair_explicit.append(explicit_idx)
    return True

  _PAIR_NCON_LOCAL = compiler_lib._PAIR_NCON

  explicit_set = set()
  for pi, p in enumerate(c.explicit_pairs):
    g1 = _resolve('geom', p['geom1'])
    g2 = _resolve('geom', p['geom2'])
    _add_pair(g1, g2, p['condim'], pi)
    explicit_set.add((min(g1, g2), max(g1, g2)))

  contact_enabled = not (c.option['disableflags'] &
                         constants.DisableBit.CONTACT)
  if contact_enabled:
    for g1 in range(ngeom):
      for g2 in range(g1 + 1, ngeom):
        if (g1, g2) in explicit_set:
          continue
        gg1, gg2 = c.geoms[g1], c.geoms[g2]
        b1, b2 = gg1.bodyid, gg2.bodyid
        w1, w2 = body_weldid[b1], body_weldid[b2]
        if w1 == w2:
          continue
        if not ((gg1.contype & gg2.conaffinity) or
                (gg2.contype & gg1.conaffinity)):
          continue
        if filterparent and w1 != 0 and w2 != 0:
          wp1 = body_weldid[body_parentid[w1]]
          wp2 = body_weldid[body_parentid[w2]]
          if w1 == wp2 or w2 == wp1:
            continue
        if (min(b1, b2), max(b1, b2)) in exclude_body_pairs:
          continue
        # merged condim: priority wins, else max
        if gg1.priority != gg2.priority:
          condim = gg1.condim if gg1.priority > gg2.priority else gg2.condim
        else:
          condim = max(gg1.condim, gg2.condim)
        _add_pair(g1, g2, condim, -1)

  # contact slots: each candidate pair occupies _PAIR_NCON slots
  slot_geom1, slot_geom2, slot_dim, slot_explicit = [], [], [], []
  for (g1, g2, condim, exp) in zip(pair_geom1, pair_geom2, pair_condim,
                                   pair_explicit):
    t1, t2 = geom_types[g1], geom_types[g2]
    ncon = _PAIR_NCON_LOCAL[(min(t1, t2), max(t1, t2))]
    for _ in range(ncon):
      slot_geom1.append(g1)
      slot_geom2.append(g2)
      slot_dim.append(condim)
      slot_explicit.append(exp)
  ncon_max = len(slot_geom1)

  # contact compaction (runtime top-K broadphase): when the candidate
  # slot count is large, only the deepest `budget` contacts per condim
  # group enter the constraint system each step. This keeps the padded
  # constraint Jacobian small for big scenes (e.g. humanoid: 277
  # candidate slots but <~40 ever simultaneously active) — a first-order
  # TPU throughput lever. Exact (no selection) for small models, so
  # oracle parity tests are unaffected.
  sel_condim = []
  _SELECT_THRESHOLD = 96
  # measured on humanoid.run rollouts: p99 = 2 simultaneously active
  # contact slots, max ~6 — 16 deepest slots is a generous envelope,
  # and every solver iteration's cost scales with the resulting row
  # count (48 slots made humanoid carry 225 constraint rows)
  _GROUP_BUDGET = contact_budget if contact_budget else 16
  for cdim in sorted(set(slot_dim)):
    n_c = sum(1 for s in slot_dim if s == cdim)
    k_c = n_c if ncon_max <= _SELECT_THRESHOLD else min(n_c, _GROUP_BUDGET)
    sel_condim.extend([cdim] * k_c)
  ncon_sel = len(sel_condim)
  if ncon_sel == ncon_max:
    # no compaction: keep the original (unsorted) slot layout so the
    # slot -> candidate mapping stays the identity
    sel_condim = list(slot_dim)

  # constraint row budget
  nefc_max = 0
  for e in c.equalities:
    nefc_max += {int(constants.EqType.CONNECT): 3,
                 int(constants.EqType.WELD): 6,
                 int(constants.EqType.JOINT): 1,
                 int(constants.EqType.TENDON): 1}[e['etype']]
  nefc_max += int(np.sum(dof_frictionloss > 0))
  nefc_max += sum(1 for j in c.joints if j.limited)
  nefc_max += sum(1 for t in c.tendons if t['limited'])
  elliptic = int(c.option['cone']) == int(constants.ConeType.ELLIPTIC)
  for dim in sel_condim:
    if dim == 1:
      nefc_max += 1
    elif elliptic:
      nefc_max += dim        # raw rows: normal + (dim-1) friction axes
    else:
      nefc_max += 2 * (dim - 1)   # pyramid edge pairs

  # ---------------- assemble ----------------
  # Parameters stay float64 numpy arrays here; model_from_numpy casts
  # them to `dtype` on `device` at the end.
  f = lambda x: np.asarray(x, dtype=np.float64)

  opt = dict(
      timestep=f(c.option['timestep']),
      gravity=f(c.option['gravity']),
      wind=f(c.option['wind']),
      magnetic=f(c.option['magnetic']),
      density=f(c.option['density']),
      viscosity=f(c.option['viscosity']),
      impratio=f(c.option['impratio']),
      tolerance=f(c.option['tolerance']),
      integrator=int(c.option['integrator']),
      cone=int(c.option['cone']),
      solver_iterations=min(int(c.option['iterations']), 32),
      ls_iterations=min(int(c.option['ls_iterations']), 16),
      disableflags=int(c.option['disableflags']),
      enableflags=int(c.option['enableflags']),
  )

  # heightfield assets (grid shape static; elevation a device leaf so
  # tasks can re-randomize terrain per episode)
  hf_names = [h['name'] for h in c.hfields]
  hfield_adr = []
  _adr = 0
  for h in c.hfields:
    hfield_adr.append(_adr)
    _adr += h['nrow'] * h['ncol']
  hfield_data = np.zeros(_adr)
  for h, a0 in zip(c.hfields, hfield_adr):
    if h['data'] is not None:
      hfield_data[a0:a0 + h['nrow'] * h['ncol']] = h['data'].reshape(-1)
  hfield_size = (np.stack([h['size'] for h in c.hfields])
                 if c.hfields else np.zeros((0, 4)))
  mesh_list = list(c.meshes.values())
  mesh_names = [mm.name for mm in mesh_list]
  mesh_vertadr, mesh_vertnum = [], []
  _madr = 0
  for mm in mesh_list:
    mesh_vertadr.append(_madr)
    mesh_vertnum.append(len(mm.hull_verts))
    _madr += len(mm.hull_verts)
  mesh_vert = (np.concatenate([mm.hull_verts for mm in mesh_list])
               if mesh_list else np.zeros((0, 3)))

  def _dataid(g):
    if (g.gtype == int(constants.GeomType.HFIELD)
        and g.dataname in hf_names):
      return hf_names.index(g.dataname)
    if (g.gtype == int(constants.GeomType.MESH)
        and g.dataname in mesh_names):
      return mesh_names.index(g.dataname)
    return -1

  geom_dataid = tuple(_dataid(g) for g in c.geoms)
  for g in c.geoms:
    # hfield geom size mirrors its asset's (rx, ry, ztop)
    if g.gtype == int(constants.GeomType.HFIELD) and g.dataname in hf_names:
      g.size = np.array(
          c.hfields[hf_names.index(g.dataname)]['size'][:3])

  kw = dict(
      nq=nq, nv=nv, nu=nu, na=na, nbody=nbody, njnt=njnt, ngeom=ngeom,
      nsite=nsite, ncam=len(c.cams), nlight=len(c.lights),
      ntendon=ntendon, nwrap=nwrap,
      nhfield=len(c.hfields),
      hfield_nrow=tuple(h['nrow'] for h in c.hfields),
      hfield_ncol=tuple(h['ncol'] for h in c.hfields),
      hfield_adr=tuple(hfield_adr),
      hfield_size=f(hfield_size),
      hfield_data=f(hfield_data),
      nmesh=len(mesh_list),
      mesh_vertadr=tuple(mesh_vertadr),
      mesh_vertnum=tuple(mesh_vertnum),
      mesh_vert=f(mesh_vert),
      geom_dataid=geom_dataid,
      nsensor=len(c.sensors), nsensordata=nsensordata, neq=neq,
      nmocap=c.nmocap, nkey=len(c.keys),
      body_parentid=tuple(body_parentid),
      body_rootid=tuple(body_rootid),
      body_weldid=tuple(body_weldid),
      body_jntadr=tuple(body_jntadr),
      body_jntnum=tuple(body_jntnum),
      body_dofadr=tuple(body_dofadr),
      body_dofnum=tuple(body_dofnum),
      body_mocapid=tuple(b.mocapid for b in c.bodies),
      body_treelevel=tuple(body_treelevel),
      jnt_type=tuple(j.jtype for j in c.joints),
      jnt_qposadr=tuple(jnt_qposadr),
      jnt_dofadr=tuple(jnt_dofadr),
      jnt_bodyid=tuple(j.bodyid for j in c.joints),
      jnt_limited=tuple(int(j.limited) for j in c.joints),
      jnt_actgravcomp=tuple(0 for _ in c.joints),
      dof_bodyid=tuple(int(x) for x in dof_bodyid),
      dof_jntid=tuple(int(x) for x in dof_jntid),
      dof_parentid=tuple(int(x) for x in dof_parentid),
      dof_hasfrictionloss=tuple(
          int(x > 0) for x in dof_frictionloss),
      geom_type=tuple(g.gtype for g in c.geoms),
      geom_bodyid=tuple(g.bodyid for g in c.geoms),
      geom_contype=tuple(g.contype for g in c.geoms),
      geom_conaffinity=tuple(g.conaffinity for g in c.geoms),
      geom_condim=tuple(g.condim for g in c.geoms),
      geom_priority=tuple(g.priority for g in c.geoms),
      site_bodyid=tuple(s['bodyid'] for s in c.sites),
      site_type=tuple(s['stype'] for s in c.sites),
      cam_bodyid=tuple(cam['bodyid'] for cam in c.cams),
      cam_mode=tuple(cam['mode'] for cam in c.cams),
      cam_targetbodyid=tuple(
          names.name2id('body', cam['target']) if cam['target'] else -1
          for cam in c.cams),
      actuator_trntype=tuple(a['trntype'] for a in c.actuators),
      actuator_dyntype=tuple(a['dyntype'] for a in c.actuators),
      actuator_gaintype=tuple(a['gaintype'] for a in c.actuators),
      actuator_biastype=tuple(a['biastype'] for a in c.actuators),
      actuator_trnid=tuple(actuator_trnid),
      actuator_actadr=tuple(actuator_actadr),
      actuator_actnum=tuple(actuator_actnum),
      actuator_ctrllimited=tuple(
          int(a['ctrllimited']) for a in c.actuators),
      actuator_forcelimited=tuple(
          int(a['forcelimited']) for a in c.actuators),
      actuator_actlimited=tuple(int(a['actlimited']) for a in c.actuators),
      tendon_adr=tuple(tendon_adr),
      tendon_num=tuple(tendon_num),
      tendon_limited=tuple(int(t['limited']) for t in c.tendons),
      wrap_type=tuple(wrap_type),
      wrap_objid=tuple(wrap_objid),
      sensor_type=tuple(s['stype'] for s in c.sensors),
      sensor_objtype=tuple(sensor_objtype),
      sensor_objid=tuple(sensor_objid),
      sensor_adr=tuple(sensor_adr),
      sensor_dim=tuple(s['dim'] for s in c.sensors),
      eq_type=tuple(e['etype'] for e in c.equalities),
      eq_obj1id=tuple(eq_obj1id),
      eq_obj2id=tuple(eq_obj2id),
      pair_geom1=tuple(slot_geom1),
      pair_geom2=tuple(slot_geom2),
      pair_condim=tuple(slot_dim),
      sel_condim=tuple(sel_condim),
      cpair_geom1=tuple(pair_geom1),
      cpair_geom2=tuple(pair_geom2),
      cpair_condim=tuple(pair_condim),
      cpair_explicit=tuple(pair_explicit),
      npair_explicit=len(c.explicit_pairs),
      names=names,
      qpos0=f(qpos0),
      qpos_spring=f(qpos_spring),
      body_pos=f(np.stack([b.pos for b in c.bodies])),
      body_quat=f(np.stack([b.quat for b in c.bodies])),
      body_ipos=f(body_ipos),
      body_iquat=f(body_iquat),
      body_mass=f(body_mass),
      body_subtreemass=f(body_subtreemass),
      body_inertia=f(body_inertia),
      body_invweight0=f(np.zeros((nbody, 2))),
      body_gravcomp=f(np.array([b.gravcomp for b in c.bodies])),
      jnt_pos=f(np.stack([j.pos for j in c.joints]) if njnt else
                np.zeros((0, 3))),
      jnt_axis=f(np.stack([j.axis for j in c.joints]) if njnt else
                 np.zeros((0, 3))),
      jnt_range=f(np.stack([j.range for j in c.joints]) if njnt else
                  np.zeros((0, 2))),
      jnt_stiffness=f(np.array([j.stiffness for j in c.joints])),
      jnt_springdamper=tuple(
          (float(j.springdamper[0]), float(j.springdamper[1]))
          if j.springdamper is not None else (0.0, 0.0)
          for j in c.joints),
      jnt_solref=f(np.stack([j.solref for j in c.joints]) if njnt else
                   np.zeros((0, 2))),
      jnt_solimp=f(np.stack([j.solimp for j in c.joints]) if njnt else
                   np.zeros((0, 5))),
      jnt_margin=f(np.array([j.margin for j in c.joints])),
      dof_armature=f(dof_armature),
      dof_damping=f(dof_damping),
      dof_invweight0=f(np.zeros(nv)),
      dof_frictionloss=f(dof_frictionloss),
      geom_pos=f(np.stack([g.pos for g in c.geoms]) if ngeom else
                 np.zeros((0, 3))),
      geom_quat=f(np.stack([g.quat for g in c.geoms]) if ngeom else
                  np.zeros((0, 4))),
      geom_size=f(np.stack([g.size for g in c.geoms]) if ngeom else
                  np.zeros((0, 3))),
      geom_friction=f(np.stack([g.friction for g in c.geoms]) if ngeom
                      else np.zeros((0, 3))),
      geom_solref=f(np.stack([g.solref for g in c.geoms]) if ngeom else
                    np.zeros((0, 2))),
      geom_solimp=f(np.stack([g.solimp for g in c.geoms]) if ngeom else
                    np.zeros((0, 5))),
      geom_solmix=f(np.array([g.solmix for g in c.geoms])),
      geom_margin=f(np.array([g.margin for g in c.geoms])),
      geom_gap=f(np.array([g.gap for g in c.geoms])),
      geom_rgba=f(np.stack([g.rgba for g in c.geoms]) if ngeom else
                  np.zeros((0, 4))),
      site_pos=f(np.stack([s['pos'] for s in c.sites]) if nsite else
                 np.zeros((0, 3))),
      site_quat=f(np.stack([s['quat'] for s in c.sites]) if nsite else
                  np.zeros((0, 4))),
      site_size=f(np.stack([s['size'] for s in c.sites]) if nsite else
                  np.zeros((0, 3))),
      cam_pos=f(np.stack([cam['pos'] for cam in c.cams]) if c.cams else
                np.zeros((0, 3))),
      cam_quat=f(np.stack([cam['quat'] for cam in c.cams]) if c.cams else
                 np.zeros((0, 4))),
      cam_fovy=f(np.array([cam['fovy'] for cam in c.cams])),
      actuator_gear=f(np.stack([a['gear'] for a in c.actuators]) if nu
                      else np.zeros((0, 6))),
      actuator_ctrlrange=f(np.stack([a['ctrlrange'] for a in c.actuators])
                           if nu else np.zeros((0, 2))),
      actuator_forcerange=f(np.stack(
          [a['forcerange'] for a in c.actuators]) if nu else
          np.zeros((0, 2))),
      actuator_actrange=f(np.stack([a['actrange'] for a in c.actuators])
                          if nu else np.zeros((0, 2))),
      actuator_dynprm=f(np.stack([a['dynprm'] for a in c.actuators]) if nu
                        else np.zeros((0, 3))),
      actuator_gainprm=f(np.stack([a['gainprm'] for a in c.actuators])
                         if nu else np.zeros((0, 9))),
      actuator_biasprm=f(np.stack([a['biasprm'] for a in c.actuators])
                         if nu else np.zeros((0, 9))),
      actuator_acc0=f(np.zeros(nu)),
      tendon_range=f(np.stack([t['range'] for t in c.tendons]) if ntendon
                     else np.zeros((0, 2))),
      tendon_stiffness=f(np.array([t['stiffness'] for t in c.tendons])),
      tendon_damping=f(np.array([t['damping'] for t in c.tendons])),
      tendon_lengthspring=f(np.stack(
          [t['springlength'] for t in c.tendons]) if ntendon else
          np.zeros((0, 2))),
      tendon_length0=f(np.zeros(ntendon)),
      tendon_invweight0=f(np.zeros(ntendon)),
      tendon_solref_lim=f(np.stack([t['solref'] for t in c.tendons])
                          if ntendon else np.zeros((0, 2))),
      tendon_solimp_lim=f(np.stack([t['solimp'] for t in c.tendons])
                          if ntendon else np.zeros((0, 5))),
      tendon_margin=f(np.array([t['margin'] for t in c.tendons])),
      wrap_prm=f(np.array(wrap_prm)),
      eq_data=f(np.stack([e['data'] for e in c.equalities]) if neq else
                np.zeros((0, 11))),
      eq_solref=f(np.stack([e['solref'] for e in c.equalities]) if neq
                  else np.zeros((0, 2))),
      eq_solimp=f(np.stack([e['solimp'] for e in c.equalities]) if neq
                  else np.zeros((0, 5))),
      eq_active0=f(np.array([float(e['active']) for e in c.equalities])),
      sensor_cutoff=f(np.array([s['cutoff'] for s in c.sensors])),
      xpair_friction=f(np.stack(
          [p['friction'] for p in c.explicit_pairs]) if c.explicit_pairs
          else np.zeros((0, 5))),
      xpair_solref=f(np.stack(
          [p['solref'] for p in c.explicit_pairs]) if c.explicit_pairs
          else np.zeros((0, 2))),
      xpair_solimp=f(np.stack(
          [p['solimp'] for p in c.explicit_pairs]) if c.explicit_pairs
          else np.zeros((0, 5))),
      xpair_margin=f(np.array([p['margin'] for p in c.explicit_pairs])),
      xpair_gap=f(np.array([p['gap'] for p in c.explicit_pairs])),
      key_qpos=f(np.stack(
          [compiler_lib._floats(k['qpos'], nq) if k['qpos'] else qpos0
           for k in c.keys]) if c.keys else np.zeros((0, nq))),
      key_qvel=f(np.stack(
          [compiler_lib._floats(k['qvel'], nv) if k['qvel'] else
           np.zeros(nv) for k in c.keys]) if c.keys else
          np.zeros((0, nv))),
      key_ctrl=f(np.stack(
          [compiler_lib._floats(k['ctrl'], nu) if k['ctrl'] else
           np.zeros(nu) for k in c.keys]) if c.keys else
          np.zeros((0, nu))),
      subtree_mask=f(subtree_mask),
      dof_vel_mask=f(dof_vel_mask),
      body_dof_mask=f(body_dof_mask),
      dof_ancestor_mask=f(dof_ancestor_mask),
      qM_mask=f(qM_mask),
      opt=opt,
      ncon_max=ncon_max,
      ncon_sel=ncon_sel,
      nefc_max=nefc_max,
  )
  opt = kw.pop('opt')
  arrays = {k: v for k, v in kw.items() if isinstance(v, np.ndarray)}
  meta = {k: v for k, v in kw.items() if k not in arrays}
  arrays['opt'] = {k: v for k, v in opt.items() if isinstance(v, np.ndarray)}
  meta['opt'] = {k: v for k, v in opt.items() if k not in arrays['opt']}
  return types.model_from_numpy(arrays, meta, device=device, dtype=dtype)
