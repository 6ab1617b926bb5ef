"""Model, Data, Contact and Option as dataclasses of torch tensors.

Counterpart of dm_control_tpu/models/types.py with the same field names.
Static structure (sizes, tree topology, joint types, slot layouts) stays as
Python ints and tuples. Parameters are tensors on the model's device in its
float dtype, shared by every environment of a batch, except the leaves a
task may draw anew each episode (`RANDOMIZED`: geom_pos, site_pos,
wrap_prm, body_pos and body_quat): those may carry a leading batch axis,
one row an environment (`Model.with_leaves`, `Model.env_rows`). Every Data
tensor has a leading batch axis: `(B, ...)`.

`model_from_numpy` and `data_from_numpy` build these from plain numpy
arrays. The builder uses the first; tests use both to hand the JAX
package's Model and Data leaves to the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _to_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
  """numpy -> torch: bool stays bool, integers become int64 (indices),
  floats become `dtype`."""
  a = np.asarray(x)
  if a.dtype == np.bool_:
    return torch.as_tensor(a, device=device)
  if np.issubdtype(a.dtype, np.integer):
    return torch.as_tensor(a.astype(np.int64), device=device)
  if not np.issubdtype(a.dtype, np.floating):
    raise TypeError(f'not a numeric array: {a.dtype}')
  return torch.as_tensor(a.astype(np.float64), device=device).to(dtype)


# The leaves that a task may draw for each environment (reacher, fish.swim
# and swimmer move a target geom, finger.turn a target site,
# point_mass.hard redraws its tendon coefficients, manipulator and stacker
# move their target and receptacle bodies). Unbatched by default:
# (ngeom, 3), (nsite, 3), (nwrap,), (nbody, 3), (nbody, 4); per
# environment (B, ngeom, 3), (B, nsite, 3), (B, nwrap), (B, nbody, 3),
# (B, nbody, 4). Only `smooth.kinematics` and `smooth.tendon` read them.
RANDOMIZED = ('geom_pos', 'site_pos', 'wrap_prm', 'body_pos', 'body_quat')
# the rank of each such leaf without its batch axis
_LEAF_RANK = {'geom_pos': 2, 'site_pos': 2, 'wrap_prm': 1, 'body_pos': 2,
              'body_quat': 2}


def _meta(default=None):
  """A static (non-tensor) field."""
  return dataclasses.field(default=default, metadata={'static': True})


class _Base:

  def replace(self, **updates):
    return dataclasses.replace(self, **updates)


@dataclasses.dataclass(frozen=True)
class Option(_Base):
  """Simulation options (the MJCF <option> element)."""
  timestep: torch.Tensor = None
  gravity: torch.Tensor = None
  wind: torch.Tensor = None
  magnetic: torch.Tensor = None
  density: torch.Tensor = None
  viscosity: torch.Tensor = None
  impratio: torch.Tensor = None
  tolerance: torch.Tensor = None
  integrator: int = _meta(0)
  cone: int = _meta(0)
  solver_iterations: int = _meta(8)
  ls_iterations: int = _meta(8)
  disableflags: int = _meta(0)
  enableflags: int = _meta(0)


@dataclasses.dataclass(frozen=True, eq=False)
class Model(_Base):
  """Compiled model: static structure plus parameter tensors."""

  # ---- static sizes ----
  nq: int = _meta(0)
  nv: int = _meta(0)
  nu: int = _meta(0)
  na: int = _meta(0)
  nbody: int = _meta(1)
  njnt: int = _meta(0)
  ngeom: int = _meta(0)
  nsite: int = _meta(0)
  ncam: int = _meta(0)
  nlight: int = _meta(0)
  ntendon: int = _meta(0)
  nwrap: int = _meta(0)
  nsensor: int = _meta(0)
  nsensordata: int = _meta(0)
  neq: int = _meta(0)
  nmocap: int = _meta(0)
  nkey: int = _meta(0)
  nhfield: int = _meta(0)
  nmesh: int = _meta(0)
  npair_explicit: int = _meta(0)
  ncon_max: int = _meta(0)
  ncon_sel: int = _meta(0)
  nefc_max: int = _meta(0)

  # ---- static structure ----
  body_parentid: Tuple[int, ...] = _meta(())
  body_rootid: Tuple[int, ...] = _meta(())
  body_weldid: Tuple[int, ...] = _meta(())
  body_jntadr: Tuple[int, ...] = _meta(())
  body_jntnum: Tuple[int, ...] = _meta(())
  body_dofadr: Tuple[int, ...] = _meta(())
  body_dofnum: Tuple[int, ...] = _meta(())
  body_mocapid: Tuple[int, ...] = _meta(())
  body_treelevel: Tuple[int, ...] = _meta(())
  jnt_type: Tuple[int, ...] = _meta(())
  jnt_qposadr: Tuple[int, ...] = _meta(())
  jnt_dofadr: Tuple[int, ...] = _meta(())
  jnt_bodyid: Tuple[int, ...] = _meta(())
  jnt_limited: Tuple[int, ...] = _meta(())
  jnt_actgravcomp: Tuple[int, ...] = _meta(())
  jnt_springdamper: Tuple[Tuple[float, float], ...] = _meta(())
  dof_bodyid: Tuple[int, ...] = _meta(())
  dof_jntid: Tuple[int, ...] = _meta(())
  dof_parentid: Tuple[int, ...] = _meta(())
  dof_hasfrictionloss: Tuple[int, ...] = _meta(())
  geom_type: Tuple[int, ...] = _meta(())
  geom_bodyid: Tuple[int, ...] = _meta(())
  geom_contype: Tuple[int, ...] = _meta(())
  geom_conaffinity: Tuple[int, ...] = _meta(())
  geom_condim: Tuple[int, ...] = _meta(())
  geom_priority: Tuple[int, ...] = _meta(())
  geom_dataid: Tuple[int, ...] = _meta(())
  hfield_nrow: Tuple[int, ...] = _meta(())
  hfield_ncol: Tuple[int, ...] = _meta(())
  hfield_adr: Tuple[int, ...] = _meta(())
  mesh_vertadr: Tuple[int, ...] = _meta(())
  mesh_vertnum: Tuple[int, ...] = _meta(())
  site_bodyid: Tuple[int, ...] = _meta(())
  site_type: Tuple[int, ...] = _meta(())
  cam_bodyid: Tuple[int, ...] = _meta(())
  cam_mode: Tuple[int, ...] = _meta(())
  cam_targetbodyid: Tuple[int, ...] = _meta(())
  actuator_trntype: Tuple[int, ...] = _meta(())
  actuator_dyntype: Tuple[int, ...] = _meta(())
  actuator_gaintype: Tuple[int, ...] = _meta(())
  actuator_biastype: Tuple[int, ...] = _meta(())
  actuator_trnid: Tuple[Tuple[int, int], ...] = _meta(())
  actuator_actadr: Tuple[int, ...] = _meta(())
  actuator_actnum: Tuple[int, ...] = _meta(())
  actuator_ctrllimited: Tuple[int, ...] = _meta(())
  actuator_forcelimited: Tuple[int, ...] = _meta(())
  actuator_actlimited: Tuple[int, ...] = _meta(())
  tendon_adr: Tuple[int, ...] = _meta(())
  tendon_num: Tuple[int, ...] = _meta(())
  tendon_limited: Tuple[int, ...] = _meta(())
  wrap_type: Tuple[int, ...] = _meta(())
  wrap_objid: Tuple[int, ...] = _meta(())
  sensor_type: Tuple[int, ...] = _meta(())
  sensor_objtype: Tuple[int, ...] = _meta(())
  sensor_objid: Tuple[int, ...] = _meta(())
  sensor_adr: Tuple[int, ...] = _meta(())
  sensor_dim: Tuple[int, ...] = _meta(())
  eq_type: Tuple[int, ...] = _meta(())
  eq_obj1id: Tuple[int, ...] = _meta(())
  eq_obj2id: Tuple[int, ...] = _meta(())
  # contact slots (one entry per narrowphase slot), compacted slot
  # condims, and the candidate-pair view (one entry per geom pair)
  pair_geom1: Tuple[int, ...] = _meta(())
  pair_geom2: Tuple[int, ...] = _meta(())
  pair_condim: Tuple[int, ...] = _meta(())
  sel_condim: Tuple[int, ...] = _meta(())
  cpair_geom1: Tuple[int, ...] = _meta(())
  cpair_geom2: Tuple[int, ...] = _meta(())
  cpair_condim: Tuple[int, ...] = _meta(())
  cpair_explicit: Tuple[int, ...] = _meta(())
  names: Any = _meta(None)

  # ---- parameter tensors ----
  qpos0: torch.Tensor = None
  qpos_spring: torch.Tensor = None
  body_pos: torch.Tensor = None
  body_quat: torch.Tensor = None
  body_ipos: torch.Tensor = None
  body_iquat: torch.Tensor = None
  body_mass: torch.Tensor = None
  body_subtreemass: torch.Tensor = None
  body_inertia: torch.Tensor = None
  body_invweight0: torch.Tensor = None
  body_gravcomp: torch.Tensor = None
  jnt_pos: torch.Tensor = None
  jnt_axis: torch.Tensor = None
  jnt_range: torch.Tensor = None
  jnt_stiffness: torch.Tensor = None
  jnt_solref: torch.Tensor = None
  jnt_solimp: torch.Tensor = None
  jnt_margin: torch.Tensor = None
  dof_armature: torch.Tensor = None
  dof_damping: torch.Tensor = None
  dof_invweight0: torch.Tensor = None
  dof_frictionloss: torch.Tensor = None
  geom_pos: torch.Tensor = None
  geom_quat: torch.Tensor = None
  geom_size: torch.Tensor = None
  geom_friction: torch.Tensor = None
  geom_solref: torch.Tensor = None
  geom_solimp: torch.Tensor = None
  geom_solmix: torch.Tensor = None
  geom_margin: torch.Tensor = None
  geom_gap: torch.Tensor = None
  geom_rgba: torch.Tensor = None
  hfield_size: torch.Tensor = None
  hfield_data: torch.Tensor = None
  mesh_vert: torch.Tensor = None
  site_pos: torch.Tensor = None
  site_quat: torch.Tensor = None
  site_size: torch.Tensor = None
  cam_pos: torch.Tensor = None
  cam_quat: torch.Tensor = None
  cam_fovy: torch.Tensor = None
  actuator_gear: torch.Tensor = None
  actuator_ctrlrange: torch.Tensor = None
  actuator_forcerange: torch.Tensor = None
  actuator_actrange: torch.Tensor = None
  actuator_dynprm: torch.Tensor = None
  actuator_gainprm: torch.Tensor = None
  actuator_biasprm: torch.Tensor = None
  actuator_acc0: torch.Tensor = None
  tendon_range: torch.Tensor = None
  tendon_stiffness: torch.Tensor = None
  tendon_damping: torch.Tensor = None
  tendon_lengthspring: torch.Tensor = None
  tendon_length0: torch.Tensor = None
  tendon_invweight0: torch.Tensor = None
  tendon_solref_lim: torch.Tensor = None
  tendon_solimp_lim: torch.Tensor = None
  tendon_margin: torch.Tensor = None
  wrap_prm: torch.Tensor = None
  eq_data: torch.Tensor = None
  eq_solref: torch.Tensor = None
  eq_solimp: torch.Tensor = None
  eq_active0: torch.Tensor = None
  sensor_cutoff: torch.Tensor = None
  xpair_friction: torch.Tensor = None
  xpair_solref: torch.Tensor = None
  xpair_solimp: torch.Tensor = None
  xpair_margin: torch.Tensor = None
  xpair_gap: torch.Tensor = None
  key_qpos: torch.Tensor = None
  key_qvel: torch.Tensor = None
  key_ctrl: torch.Tensor = None
  # 0/1 structure masks (see dm_control_tpu/models/types.py)
  subtree_mask: torch.Tensor = None
  body_dof_mask: torch.Tensor = None
  dof_ancestor_mask: torch.Tensor = None
  qM_mask: torch.Tensor = None
  dof_vel_mask: torch.Tensor = None

  opt: Option = None
  # memo of constant index/mask tensors built from the static structure
  consts: Dict[Any, torch.Tensor] = dataclasses.field(
      default_factory=dict, repr=False, compare=False,
      metadata={'static': True})

  def replace(self, **updates):
    # a replaced model may have other tensors: start a fresh memo
    updates.setdefault('consts', {})
    return dataclasses.replace(self, **updates)

  def with_leaves(self, **leaves) -> 'Model':
    """This model with some RANDOMIZED leaves replaced by one row an
    environment, (B,) + the compiled leaf's shape. The memo (schedules,
    plans, index tensors) is shared, not rebuilt: nothing in it reads
    those leaves."""
    bad = set(leaves) - set(RANDOMIZED)
    if bad:
      raise ValueError(f'not a per-env leaf: {sorted(bad)}')
    for k, v in leaves.items():
      rank = _LEAF_RANK[k]
      if v.dim() != rank + 1 or v.shape[1:] != getattr(self, k).shape[-rank:]:
        raise ValueError(f'{k} of shape {tuple(v.shape)} is not one row an '
                         'environment')
    return dataclasses.replace(self, consts=self.consts, **leaves)

  def env_rows(self, idx: torch.Tensor) -> 'Model':
    """The model of the environments `idx` ((n,) indices): each per-env
    leaf cut to their rows; a model without per-env leaves is itself."""
    leaves = {k: getattr(self, k)[idx] for k in RANDOMIZED
              if getattr(self, k).dim() == _LEAF_RANK[k] + 1}
    return self.with_leaves(**leaves) if leaves else self

  @property
  def device(self) -> torch.device:
    return self.qpos0.device

  @property
  def dtype(self) -> torch.dtype:
    return self.qpos0.dtype

  def const(self, key, make) -> torch.Tensor:
    """A tensor built once from static structure and kept on the device.

    `make()` returns a numpy array or a list (see `_to_tensor`).
    """
    return self.memo(key, lambda: _to_tensor(make(), self.dtype,
                                             self.device))

  def index(self, name: str) -> torch.Tensor:
    """The static index field `name` (e.g. 'dof_bodyid') as an int64
    tensor on the device. The dtype is explicit, so an empty field (a
    model without dofs, sites or contacts) is an index tensor too."""
    return self.memo(('index', name), lambda: torch.as_tensor(
        np.asarray(getattr(self, name), dtype=np.int64), device=self.device))

  def memo(self, key, make):
    """Any value derived once from static structure (e.g. a schedule)."""
    if key not in self.consts:
      self.consts[key] = make()
    return self.consts[key]


def put_envs(leaves: Dict[str, torch.Tensor], idx: torch.Tensor,
             rows: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
  """Per-env leaves with `rows` ({name: (len(idx), ...)}) written at the
  environments `idx`; the other rows are kept as they are."""
  return {k: v.index_put((idx,), rows[k].to(v.dtype))
          for k, v in leaves.items()}


@dataclasses.dataclass(frozen=True)
class Contact(_Base):
  """Compacted contact slots of a batch: every tensor is (B, ncon, ...)."""
  dist: torch.Tensor
  pos: torch.Tensor
  frame: torch.Tensor          # (B, ncon, 3, 3) rows = [normal, t1, t2]
  includemargin: torch.Tensor
  friction: torch.Tensor       # (B, ncon, 5)
  solref: torch.Tensor
  solimp: torch.Tensor
  active: torch.Tensor         # bool
  force: torch.Tensor          # (B, ncon, 3) in the contact frame
  geom1: torch.Tensor = None   # int64
  geom2: torch.Tensor = None
  overflow: torch.Tensor = None  # (B,) bool
  gap: torch.Tensor = None
  dim: Tuple[int, ...] = _meta(())


@dataclasses.dataclass(frozen=True)
class Data(_Base):
  """State and derived quantities of a batch of environments."""
  time: torch.Tensor
  qpos: torch.Tensor
  qvel: torch.Tensor
  act: torch.Tensor
  ctrl: torch.Tensor
  qacc: torch.Tensor
  qacc_warmstart: torch.Tensor
  qfrc_applied: torch.Tensor
  xfrc_applied: torch.Tensor
  mocap_pos: torch.Tensor
  mocap_quat: torch.Tensor
  xpos: torch.Tensor
  xquat: torch.Tensor
  xmat: torch.Tensor
  xipos: torch.Tensor
  ximat: torch.Tensor
  xanchor: torch.Tensor
  xaxis: torch.Tensor
  geom_xpos: torch.Tensor
  geom_xmat: torch.Tensor
  site_xpos: torch.Tensor
  site_xmat: torch.Tensor
  subtree_com: torch.Tensor
  cinert: torch.Tensor
  cdof: torch.Tensor
  qM: torch.Tensor
  qLD: torch.Tensor
  ten_length: torch.Tensor
  ten_J: torch.Tensor
  contact: Contact = None
  cvel: torch.Tensor = None
  cdof_dot: torch.Tensor = None
  qfrc_bias: torch.Tensor = None
  qfrc_passive: torch.Tensor = None
  ten_velocity: torch.Tensor = None
  actuator_length: torch.Tensor = None
  actuator_moment: torch.Tensor = None
  actuator_velocity: torch.Tensor = None
  actuator_force: torch.Tensor = None
  act_dot: torch.Tensor = None
  qfrc_actuator: torch.Tensor = None
  qfrc_smooth: torch.Tensor = None
  qacc_smooth: torch.Tensor = None
  qfrc_constraint: torch.Tensor = None
  efc_force: torch.Tensor = None
  cacc: torch.Tensor = None
  cfrc_int: torch.Tensor = None
  sensordata: torch.Tensor = None
  energy: torch.Tensor = None
  divergence: torch.Tensor = None
  solver_niter: torch.Tensor = None


def _static_names(cls):
  return {f.name for f in dataclasses.fields(cls)
          if f.metadata.get('static')}


def model_from_numpy(arrays: Dict[str, Any], meta: Dict[str, Any],
                     device='cuda', dtype=torch.float32) -> Model:
  """Builds a Model from numpy parameter arrays and static metadata.

  arrays: parameter name -> array (float arrays are cast to `dtype`),
    plus 'opt' -> dict of the Option's array fields.
  meta: static field name -> int or tuple, plus 'opt' -> dict of the
    Option's static fields. Keys that are not Model fields are ignored,
    so the JAX package's full leaf set can be passed as it is.
  """
  dev = torch.device(device)
  tens = lambda x: _to_tensor(x, dtype, dev)
  opt_arrays = dict(arrays.get('opt', {}))
  opt_meta = dict(meta.get('opt', {}))
  opt_fields = {f.name for f in dataclasses.fields(Option)}
  opt = Option(**{k: tens(v) for k, v in opt_arrays.items()
                  if k in opt_fields},
               **{k: int(v) for k, v in opt_meta.items() if k in opt_fields})
  static = _static_names(Model) - {'consts'}
  fields = {f.name for f in dataclasses.fields(Model)}
  kw = {k: v for k, v in meta.items() if k in static}
  for k, v in arrays.items():
    if k in fields and k not in static and k != 'opt':
      kw[k] = tens(v)
  return Model(opt=opt, **kw)


def model_to_numpy(m: Model):
  """Inverse of `model_from_numpy`: (arrays, meta) as plain numpy/tuples."""
  arrays, meta = {}, {}
  for f in dataclasses.fields(Model):
    v = getattr(m, f.name)
    if f.name in ('consts',):
      continue
    if f.name == 'opt':
      arrays['opt'] = {g.name: getattr(v, g.name).cpu().numpy()
                       for g in dataclasses.fields(Option)
                       if not g.metadata.get('static')}
      meta['opt'] = {g.name: getattr(v, g.name)
                     for g in dataclasses.fields(Option)
                     if g.metadata.get('static')}
    elif f.metadata.get('static'):
      meta[f.name] = v
    else:
      arrays[f.name] = v.cpu().numpy()
  return arrays, meta


def make_data(m: Model, batch: int, dtype: Optional[torch.dtype] = None,
              device=None) -> Data:
  """Fresh Data for `batch` environments at qpos0."""
  dtype = dtype or m.dtype
  dev = torch.device(device) if device is not None else m.device
  B = batch

  def z(*shape):
    return torch.zeros((B,) + shape, dtype=dtype, device=dev)

  def tile(x, *shape):
    return torch.as_tensor(x, dtype=dtype, device=dev).expand(
        (B,) + shape).clone()

  nb, nv, ncon = m.nbody, m.nv, m.ncon_sel
  eye3 = np.eye(3)
  contact = Contact(
      dist=z(ncon), pos=z(ncon, 3), frame=tile(eye3, ncon, 3, 3),
      includemargin=z(ncon), gap=z(ncon),
      friction=tile(np.ones(5), ncon, 5),
      solref=tile([0.02, 1.0], ncon, 2),
      solimp=tile([0.9, 0.95, 0.001, 0.5, 2.0], ncon, 5),
      active=torch.zeros((B, ncon), dtype=torch.bool, device=dev),
      force=z(ncon, 3),
      geom1=torch.zeros((B, ncon), dtype=torch.int64, device=dev),
      geom2=torch.zeros((B, ncon), dtype=torch.int64, device=dev),
      overflow=torch.zeros(B, dtype=torch.bool, device=dev),
      dim=m.sel_condim)
  nmocap = max(m.nmocap, 1)
  return Data(
      time=z(), qpos=m.qpos0.to(device=dev, dtype=dtype).expand(
          B, m.nq).clone(),
      qvel=z(nv), act=z(m.na), ctrl=z(m.nu), qacc=z(nv),
      qacc_warmstart=z(nv), qfrc_applied=z(nv), xfrc_applied=z(nb, 6),
      mocap_pos=z(nmocap, 3), mocap_quat=tile([1.0, 0, 0, 0], nmocap, 4),
      xpos=z(nb, 3), xquat=tile([1.0, 0, 0, 0], nb, 4),
      xmat=tile(eye3, nb, 3, 3), xipos=z(nb, 3), ximat=tile(eye3, nb, 3, 3),
      xanchor=z(m.njnt, 3), xaxis=z(m.njnt, 3), geom_xpos=z(m.ngeom, 3),
      geom_xmat=tile(eye3, m.ngeom, 3, 3), site_xpos=z(m.nsite, 3),
      site_xmat=tile(eye3, m.nsite, 3, 3), subtree_com=z(nb, 3),
      cinert=z(nb, 6, 6), cdof=z(nv, 6), qM=z(nv, nv), qLD=z(nv, nv),
      ten_length=z(m.ntendon), ten_J=z(m.ntendon, nv), contact=contact,
      cvel=z(nb, 6), cdof_dot=z(nv, 6), qfrc_bias=z(nv),
      qfrc_passive=z(nv), ten_velocity=z(m.ntendon),
      actuator_length=z(m.nu), actuator_moment=z(m.nu, nv),
      actuator_velocity=z(m.nu), actuator_force=z(m.nu), act_dot=z(m.na),
      qfrc_actuator=z(nv), qfrc_smooth=z(nv), qacc_smooth=z(nv),
      qfrc_constraint=z(nv), efc_force=z(m.nefc_max), cacc=z(nb, 6),
      cfrc_int=z(nb, 6), sensordata=z(m.nsensordata), energy=z(2),
      divergence=torch.zeros(B, dtype=torch.bool, device=dev),
      solver_niter=torch.zeros(B, dtype=torch.int64, device=dev))


def data_from_numpy(m: Model, fields: Dict[str, Any],
                    dtype: Optional[torch.dtype] = None) -> Data:
  """A Data batch at qpos0 with the given fields overwritten.

  fields: Data field name -> (B, ...) numpy array. Contact fields go
  under 'contact' as a dict. Float arrays are cast to `dtype` (default:
  the model's), integer and bool arrays keep their kind.
  """
  dtype = dtype or m.dtype
  tens = lambda x: _to_tensor(x, dtype, m.device)
  fields = dict(fields)
  con = fields.pop('contact', None)
  B = int(np.asarray(next(iter(fields.values()))).shape[0]) if fields else (
      int(np.asarray(next(iter(con.values()))).shape[0]))
  d = make_data(m, B, dtype=dtype)
  if con:
    d = d.replace(contact=d.contact.replace(
        **{k: tens(v) for k, v in con.items() if k != 'dim'}))
  return d.replace(**{k: tens(v) for k, v in fields.items()})
