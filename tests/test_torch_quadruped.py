"""Parity of the port's quadruped domain (walk, run, fetch) against the JAX
package.

Both sides run in float64 on the CPU from the same numpy inputs; the JAX
side enables x64 only inside a scoped context. What is held: the port's
build of the walk and fetch models; the five new closed-form pair
functions, MPR and its support functions, eagerly on seeded random
poses; and, through one jitted JAX substep on the fetch model, every
stage of a substep from a state with condim 1, 3 and 6 contact rows and
the four tendon-equality rows live (and JOINT equality rows on the same
model with its couplings swapped), the sensors (SUBTREECOM and the
acceleration stage among them), one control step of four substeps, and
the observations and rewards of fetch, walk and run. The walk and run
tasks are held on the fetch model's states: their task code reads only
the quadruped's body, which the two models share. The initializers draw
from torch generators and are checked for range and distribution only.

The lane budget: the JAX side compiles one function, the fetch substep,
used by one test item; the rest of its calls run eagerly.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dm_control_tpu import models as jmodels
from dm_control_tpu.models import types as jtypes
from dm_control_tpu.ops import collision as jcollision
from dm_control_tpu.ops import constraint as jconstraint
from dm_control_tpu.ops import forward as jforward
from dm_control_tpu.ops import mpr as jmpr
from dm_control_tpu.ops import sensor as jsensor
from dm_control_tpu.suite import common as jcommon
from dm_control_tpu.suite import quadruped as jquadruped

from dm_control_tpu_torch import models as tmodels
from dm_control_tpu_torch import suite
from dm_control_tpu_torch.models import constants
from dm_control_tpu_torch.models import types as ttypes
from dm_control_tpu_torch.models.compiler import _PAIR_NCON
from dm_control_tpu_torch.ops import collision as tcollision
from dm_control_tpu_torch.ops import constraint as tconstraint
from dm_control_tpu_torch.ops import forward as tforward
from dm_control_tpu_torch.ops import mpr as tmpr
from dm_control_tpu_torch.ops import sensor as tsensor
from dm_control_tpu_torch.ops import smooth as tsmooth
from dm_control_tpu_torch.parallel import BatchedEnvironment
from dm_control_tpu_torch.suite import quadruped as tquadruped

from test_torch_slice import (CONTACT_FIELDS, POS_FIELDS, ROW_FIELDS,
                              SOLVE_FIELDS, TOL_SMOOTH, TOL_SOLVE,
                              assert_close, jax_model_to_numpy, np_)

# One intra-op thread: the batches here are tiny, and pytest-xdist workers
# share the host's cores, where a thread pool per worker only contends.
torch.set_num_threads(1)

_G = constants.GeomType
B = 4
N_SUB = 4
# MPR's loops compare against fixed thresholds (1e-7 convergence, sign
# tests); the two sides agree to rounding unless one of those flips
TOL_MPR = 1e-8
# the JAX batched solver keeps at most this many live rows an env when a
# model has more than 160 rows (fetch has 260); with no more than this
# many live rows it drops none, and the two solvers solve the same problem
JAX_ROW_BUDGET = 64

MODELS = {'walk': dict(floor_size=10), 'fetch': dict(walls_and_ball=True)}


@functools.lru_cache(maxsize=None)
def _jax_model(name):
  with jax.enable_x64(True):
    return jmodels.from_xml_string(jquadruped.make_model(**MODELS[name]),
                                   assets=jcommon.ASSETS, dtype=jnp.float64)


@functools.lru_cache(maxsize=None)
def _torch_env(task):
  return suite.load('quadruped', task, device='cpu', dtype=torch.float64)


# ---------------------------------------------------------------------------
# the model build


@pytest.mark.parametrize('name', list(MODELS))
def test_model_matches_jax_build(name):
  """The port's make_model and compiler against the JAX build: the XML,
  static fields (pair lists, slot layout, equality and actuator structure)
  exactly, parameters (eq_*, tendon_invweight0, actuator dynamics, ...)
  to 1e-12."""
  assert tquadruped.make_model(**MODELS[name]) == jquadruped.make_model(
      **MODELS[name])
  mj = _jax_model(name)
  tm = _torch_env(name).model
  arrays, meta = jax_model_to_numpy(mj)
  t_arrays, t_meta = tmodels.model_to_numpy(tm)
  for k, v in t_meta.items():
    if k == 'names':
      assert all(v.names(ns) == meta[k].names(ns) for ns in v.NAMESPACES)
    elif k != 'opt':
      assert v == meta[k], k
  assert t_meta['opt'] == meta['opt']
  for k, v in t_arrays.items():
    if k == 'opt':
      for kk, vv in v.items():
        assert_close(vv, arrays['opt'][kk], 1e-12, f'opt.{kk}')
    else:
      assert_close(v, arrays[k], 1e-12, k)
  nv, ncon_sel, ncon_max, condims = {
      'walk': (22, 32, 251, {1, 3}), 'fetch': (28, 48, 423, {1, 3, 6})}[name]
  assert (tm.nv, tm.na, tm.neq) == (nv, 12, 4)
  assert (tm.ncon_sel, tm.ncon_max) == (ncon_sel, ncon_max)
  assert set(tm.sel_condim) == condims
  assert all(t == constants.EqType.TENDON for t in tm.eq_type)
  assert all(t == constants.DynType.FILTER for t in tm.actuator_dyntype)
  slots = sum(_PAIR_NCON[(tm.geom_type[g1], tm.geom_type[g2])]
              for g1, g2 in zip(tm.cpair_geom1, tm.cpair_geom2))
  assert slots == tm.ncon_max


# ---------------------------------------------------------------------------
# CONNECT and WELD rows

_EQ_XML = """
<mujoco>
  <default><geom contype="0" conaffinity="0"/></default>
  <worldbody>
    <body name="a">
      <joint name="j1" type="hinge" axis="0 1 0" limited="true" range="-1 1"/>
      <geom type="capsule" size=".05" fromto="0 0 0 .3 0 0"/>
      <body name="b" pos=".3 0 0">
        <joint name="j2" type="hinge" axis="0 1 0"/>
        <geom type="capsule" size=".05" fromto="0 0 0 .3 0 0"/>
      </body>
    </body>
    <body name="c" pos="0 1 0">
      <joint name="j3" type="slide" axis="1 0 0"/>
      <geom type="sphere" size=".1"/>
    </body>
  </worldbody>
  <equality>
    <joint joint1="j1" joint2="j2" polycoef="0.1 0.5 -0.3 0.2 0.05"
           solref=".02 1"/>
    <joint joint1="j3" polycoef="0.2 0 0 0 0" solimp=".8 .9 .01"/>
    %s
  </equality>
</mujoco>
"""


def test_connect_and_weld_rows_raise():
  """JOINT equality rows assemble (they are held against the JAX package
  in test_fetch_step_matches_jax); CONNECT and WELD rows still raise."""
  tm = tmodels.from_xml_string(_EQ_XML % '', device='cpu',
                               dtype=torch.float64)
  assert list(tm.eq_type) == [constants.EqType.JOINT] * 2
  d = tforward.forward(tm, ttypes.make_data(tm, 2).replace(
      qpos=torch.tensor([[0.3, -0.2, 0.1], [-1.1, 0.4, 0.5]],
                        dtype=torch.float64)))
  assert torch.isfinite(d.qacc).all()
  for extra in ('<connect body1="a" body2="c" anchor="0 0 0"/>',
                '<weld body1="a" body2="c"/>'):
    tm = tmodels.from_xml_string(_EQ_XML % extra, device='cpu',
                                 dtype=torch.float64)
    with pytest.raises(NotImplementedError):
      tconstraint.make_rows(tm, ttypes.make_data(tm, 1))


# ---------------------------------------------------------------------------
# pair functions and MPR

def _rot(rng, n):
  q = rng.normal(size=(n, 4))
  q /= np.linalg.norm(q, axis=1, keepdims=True)
  w, x, y, z = q.T
  return np.stack([
      np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                2 * (x * z + w * y)], -1),
      np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                2 * (y * z - w * x)], -1),
      np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                1 - 2 * (x * x + y * y)], -1)], axis=1)


def _size(rng, gtype, n):
  s = np.zeros((n, 3))
  if gtype == _G.ELLIPSOID:
    return rng.uniform(0.1, 0.3, (n, 3))
  s[:, 0] = rng.uniform(0.05, 0.2, n)
  if gtype in (_G.CAPSULE, _G.CYLINDER):
    s[:, 1] = rng.uniform(0.1, 0.3, n)
  return s


def _bounding_radius(gtype, s):
  if gtype == _G.ELLIPSOID:
    return s.max(axis=1)
  if gtype == _G.CAPSULE:
    return s[:, 0] + s[:, 1]
  if gtype == _G.CYLINDER:
    return np.hypot(s[:, 0], s[:, 1])
  return s[:, 0]


N_POSES = 8   # poses a pair: the first half penetrating, the rest apart


def _poses(t1, t2, seed):
  """Seeded poses of geom1 (type t1) and geom2 (t2). The first half
  penetrate clearly: a plane cuts the other geom's center, a sphere's or
  capsule end's center lies within 0.02 of the other geom's center. The
  second half are 0.1 apart beyond their bounding spheres (a plane: above
  the other geom's bounding sphere)."""
  rng = np.random.default_rng(seed)
  n, h = N_POSES, N_POSES // 2
  m1, m2 = _rot(rng, n), _rot(rng, n)
  s1, s2 = _size(rng, t1, n), _size(rng, t2, n)
  p2 = rng.uniform(-1, 1, (n, 3))
  r2 = _bounding_radius(t2, s2)
  if t1 == _G.PLANE:
    s1 = np.tile([5.0, 5.0, 0.5], (n, 1))
    normal = m1[:, :, 2]
    height = np.where(np.arange(n) < h, rng.uniform(-0.03, 0.03, n),
                      r2 + 0.1)
    p1 = p2 - normal * height[:, None]
  else:
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    near = p2 + u * rng.uniform(0, 0.02, n)[:, None]
    far = p2 + u * (_bounding_radius(t1, s1) + r2 + 0.1)[:, None]
    p1 = np.where((np.arange(n) < h)[:, None], near, far)
    if t1 == _G.CAPSULE:   # the capsule's lower end at `near`
      p1[:h] += m1[:h, :, 2] * s1[:h, 1:2]
  return p1, m1, s1, p2, m2, s2


PAIRS = {
    'plane-cylinder': (_G.PLANE, _G.CYLINDER),
    'plane-ellipsoid': (_G.PLANE, _G.ELLIPSOID),
    'sphere-cylinder': (_G.SPHERE, _G.CYLINDER),
    'sphere-ellipsoid': (_G.SPHERE, _G.ELLIPSOID),
    'capsule-cylinder': (_G.CAPSULE, _G.CYLINDER),
    'capsule-ellipsoid-mpr': (_G.CAPSULE, _G.ELLIPSOID),
}


@pytest.mark.parametrize('pair', list(PAIRS))
def test_pair_matches_jax(pair):
  """Depth, position and normal of every slot against the JAX pair
  function (MPR: the JAX MPR kernel, with the quadruped's zero margin and
  a positive one), on penetrating and separated poses. The JAX functions
  run eagerly under vmap: no compile beyond their primitives."""
  t1, t2 = PAIRS[pair]
  p1, m1, s1, p2, m2, s2 = _poses(t1, t2, list(PAIRS).index(pair))
  h = N_POSES // 2
  mpr = pair.endswith('-mpr')
  margins = (0.0, 0.01) if mpr else (None,)
  for margin in margins:
    with jax.enable_x64(True):
      if mpr:
        zero_v = np.zeros((N_POSES, 1, 3))
        want = jax.vmap(jmpr.make_kernel(t1, t2))(
            p1, m1, s1, zero_v, p2, m2, s2, zero_v,
            np.full(N_POSES, margin))
      else:
        fn = jcollision._FUNCS[(t1, t2)][0]
        want = jax.vmap(fn)(p1, m1, s1, p2, m2, s2)
      want = [np.asarray(w) for w in want]
    args = [torch.as_tensor(a) for a in (p1, m1, s1, p2, m2, s2)]
    if mpr:
      got = tmpr.collide(t1, t2, *args, margin=torch.full((N_POSES,),
                                                          margin))
    else:
      got = tcollision._FUNCS[(t1, t2)](*args)
    k = _PAIR_NCON[(t1, t2)]
    dist = want[0]
    assert dist.shape == (N_POSES, k)
    # the reference itself: penetrating poses touch, separated ones do not
    assert (dist[:h].min(axis=1) < 0).all(), dist
    assert (dist[h:] > 0).all(), dist
    tol = TOL_MPR if mpr else TOL_SMOOTH
    for name, g, w in zip(('dist', 'pos', 'normal'), got, want):
      assert_close(np_(g), w, tol, f'{pair} {name} (margin {margin})')


@pytest.mark.parametrize('gtype', tmpr.PRIMITIVES,
                         ids=lambda t: _G(t).name.lower())
def test_support_matches_jax(gtype):
  """MPR's support function of each primitive against the JAX one, on
  seeded directions, axis-aligned ones (a zero z or a zero xy part) among
  them."""
  rng = np.random.default_rng(int(gtype))
  size = _size(rng, gtype, 1)[0] if gtype != _G.BOX else rng.uniform(
      0.05, 0.3, 3)
  dirs = np.concatenate([rng.normal(size=(8, 3)), np.eye(3), -np.eye(3),
                         [[0.3, -0.4, 0.0]]])
  with jax.enable_x64(True):
    want = np.stack([np.asarray(jmpr._support_local(gtype, size, None, d))
                     for d in dirs])
  got = tmpr._support_local(gtype, torch.as_tensor(size),
                            torch.as_tensor(dirs))
  assert_close(np_(got), want, TOL_SMOOTH, _G(gtype).name)


# ---------------------------------------------------------------------------
# a fetch substep and control step

def _start_state(m, seed=5):
  """B fetch envs, each with the torso pushed 0.02 into the floor, the
  ball 0.01 into the floor and 0.025 into the lowest toe, random hinge
  angles in range but one past its upper limit, orientations,
  velocities, activations, controls and warmstarts.

  The poses come from a seeded draw of 256 candidates: the first B whose
  live rows include condim 1, 3 and 6 contacts (a toe on the ball, the
  ball on the floor) and number at most JAX_ROW_BUDGET, the JAX solver's
  budget (a state with more live rows is a different problem there)."""
  tm = _torch_env('fetch').model
  rng = np.random.default_rng(seed)
  n = 256
  qpos = np.tile(np.asarray(m.qpos0), (n, 1))
  quat = rng.normal(size=(n, 4))
  qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
  hinges = [j for j in range(m.njnt)
            if m.jnt_type[j] == constants.JointType.HINGE]
  rng_ = np.asarray(m.jnt_range)
  for j in hinges:
    qpos[:, m.jnt_qposadr[j]] = rng.uniform(*rng_[j], n)
  qpos[:, m.jnt_qposadr[hinges[1]]] = rng_[hinges[1], 1] + rng.uniform(
      0.005, 0.03, n)

  def kin(q):
    d = ttypes.make_data(tm, n).replace(qpos=torch.as_tensor(q))
    return tsmooth.kinematics(tm, d)

  # the torso's lowest point (its support along -z) 0.02 below the floor
  torso = tm.names.name2id('geom', 'torso')
  d = kin(qpos)
  axes = np_(d.geom_xmat[:, torso])[:, 2, :] * np_(tm.geom_size[torso])
  qpos[:, 2] = np.linalg.norm(axes, axis=1) - 0.02
  # the ball beside the lowest toe, away from the root
  d = kin(qpos)
  toes = [tm.names.name2id('geom', f'toe_{a}_{b}')
          for a in ('front', 'back') for b in ('left', 'right')]
  toe_pos = np_(d.geom_xpos[:, toes])
  low = toe_pos[np.arange(n), toe_pos[:, :, 2].argmin(axis=1)]
  ball_q = tm.jnt_qposadr[tm.names.name2id('joint', 'ball_root')]
  radius = float(tm.geom_size[tm.names.name2id('geom', 'ball'), 0])
  ball_z = radius - 0.01
  out = low[:, :2] - qpos[:, :2]
  out /= np.linalg.norm(out, axis=1, keepdims=True)
  reach = 0.08 + radius - 0.025
  dz = low[:, 2] - ball_z
  qpos[:, ball_q:ball_q + 2] = low[:, :2] + out * np.sqrt(
      np.maximum(reach ** 2 - dz ** 2, 0.0))[:, None]
  qpos[:, ball_q + 2] = ball_z

  d = tforward.fwd_position(tm, ttypes.make_data(tm, n).replace(
      qpos=torch.as_tensor(qpos)))
  live = np_(tconstraint.make_rows(tm, d).slot_active > 0).sum(axis=1)
  con = d.contact
  gb = tm.names.name2id('geom', 'ball')
  floor = tm.names.name2id('geom', 'floor')
  act = np_(con.active)
  g1, g2 = np_(con.geom1), np_(con.geom2)
  sel = np.asarray(tm.sel_condim)
  toe_ball = (act & np.isin(g1, toes) & (g2 == gb)).any(axis=1)
  ball_floor = (act & (g1 == floor) & (g2 == gb)).any(axis=1)
  torso_floor = (act & (g1 == floor) & (g2 == torso)).any(axis=1)
  ok = (toe_ball & ball_floor & torso_floor & act[:, sel == 1].any(axis=1)
        & (dz < reach) & (live <= JAX_ROW_BUDGET))
  pick = np.nonzero(ok)[0][:B]
  assert len(pick) == B, 'fewer than B candidates hold every row type'
  qpos = qpos[pick]
  lo, hi = np.asarray(m.actuator_ctrlrange).T
  return {'time': np.zeros(B), 'qpos': qpos,
          'qvel': rng.normal(0.0, 0.5, (B, m.nv)),
          'act': rng.uniform(-1.0, 1.0, (B, m.na)),
          'ctrl': rng.uniform(lo, hi, (B, m.nu)),
          'qacc': np.zeros((B, m.nv)),
          'qacc_warmstart': rng.normal(0.0, 1.0, (B, m.nv)),
          'sensordata': np.zeros((B, m.nsensordata))}


TASKS = {
    'fetch': (lambda mod, m: mod.Fetch(m)),
    'walk': (lambda mod, m: mod.Move(m, desired_speed=0.5)),
    'run': (lambda mod, m: mod.Move(m, desired_speed=5)),
}
# Move's observations do not depend on its speed: the JAX side computes
# walk's, and run's are held against them
OBS_OF = {'fetch': 'fetch', 'walk': 'walk', 'run': 'walk'}


def _jax_substep(m, m_joint):
  """The one jitted JAX function of this file: a batched Euler substep of
  the fetch model on a slim state with every stage's fields, the
  observations and rewards of the three tasks on the forward state (all
  sensors fresh), and the next slim state. The next state keeps the
  input's sensordata, as BatchedEnvironment's substeps (no sensors) do.
  Beside it, the rows of `m_joint` (_joint_equality_models) at the same
  qpos."""
  tasks = {k: make(jquadruped, m) for k, make in TASKS.items()}
  vm = lambda f: jax.vmap(lambda d: f(m, d))

  def substep(state):
    joint_rows = jax.vmap(lambda q: jconstraint.make_rows(
        m_joint, jtypes.make_data(m_joint, dtype=jnp.float64).replace(
            qpos=q)))(state['qpos'])
    D = jax.vmap(lambda s: jforward.inflate(m, s))(state)
    D = vm(lambda mm, d: jforward.fwd_position(mm, d, factor=False))(D)
    out = {'pos.' + k: getattr(D, k) for k in POS_FIELDS}
    out.update({'contact.' + k: getattr(D.contact, k)
                for k in CONTACT_FIELDS})
    D = vm(jforward.fwd_velocity)(D)
    D = vm(lambda mm, d: jsensor.sensors(mm, d, stages='pv'))(D)
    D = vm(jforward.fwd_actuation)(D)
    D = jforward.fwd_acceleration_batched(m, D)
    out.update({'vel.' + k: getattr(D, k)
                for k in ('qfrc_bias', 'qfrc_passive', 'actuator_velocity',
                          'actuator_force', 'act_dot', 'qfrc_actuator',
                          'qacc_smooth')})
    rows = vm(jconstraint.make_rows)(D)
    out.update({'rows.' + k: getattr(rows, k) for k in ROW_FIELDS})
    out['rows.eq_mask'] = rows.eq_mask
    D = jconstraint.fwd_constraint_batched(m, D)
    out.update({'solve.' + k: getattr(D, k) for k in SOLVE_FIELDS})
    out['solve.contact_force'] = D.contact.force
    D = vm(lambda mm, d: jsensor.sensors(mm, d, stages='acc'))(D)
    out['sensordata'] = D.sensordata
    out['obs'] = {k: jax.vmap(lambda d, t=tasks[k]: t.get_observation(
        m, d))(D) for k in set(OBS_OF.values())}
    out['reward'] = {k: jax.vmap(lambda d, t=t: t.get_reward(m, d))(D)
                     for k, t in tasks.items()}
    nxt = jforward.slim_state(jforward._euler_batched(m, D))
    nxt['sensordata'] = state['sensordata']
    out['next'] = nxt
    out.update({'joint_rows.' + k: getattr(joint_rows, k)
                for k in ROW_FIELDS + ('eq_mask',)})
    return out

  return substep


def _port_substep(tm, state):
  """The port's stages on the same state, with the same keys."""
  d = tforward.inflate(tm, {k: torch.as_tensor(v) for k, v in state.items()})
  out = {}
  d = tforward.fwd_position(tm, d)
  out.update({'pos.' + k: getattr(d, k) for k in POS_FIELDS})
  out.update({'contact.' + k: getattr(d.contact, k) for k in CONTACT_FIELDS})
  d = tforward.fwd_velocity(tm, d)
  d = tsensor.sensors(tm, d, stages='pv')
  d = tforward.fwd_actuation(tm, d)
  d = tforward.fwd_acceleration_batched(tm, d)
  out.update({'vel.' + k: getattr(d, k)
              for k in ('qfrc_bias', 'qfrc_passive', 'actuator_velocity',
                        'actuator_force', 'act_dot', 'qfrc_actuator',
                        'qacc_smooth')})
  rows = tconstraint.make_rows(tm, d)
  out.update({'rows.' + k: getattr(rows, k) for k in ROW_FIELDS})
  out['rows.eq_mask'] = rows.eq.to(torch.float64).expand(B, -1)
  d = tconstraint.fwd_constraint_batched(tm, d)
  out.update({'solve.' + k: getattr(d, k) for k in SOLVE_FIELDS})
  out['solve.contact_force'] = d.contact.force
  d = tsensor.sensors(tm, d, stages='acc')
  out['sensordata'] = d.sensordata
  d = tforward._euler_batched(tm, d)
  out.update({'next.' + k: getattr(d, k) for k in ('qpos', 'qvel', 'act')})
  return {k: np_(v) for k, v in out.items()}


@pytest.fixture(scope='module')
def fetch_case():
  """(JAX fetch model, start state, the JAX first substep, the JAX state
  after N_SUB substeps, the JAX outputs on that state)."""
  m = _jax_model('fetch')
  start = _start_state(m)
  m_joint, _ = _joint_equality_models(m, _torch_env('fetch').model)
  with jax.enable_x64(True):
    substep = jax.jit(_jax_substep(m, m_joint))
    first = jax.tree.map(np.asarray, substep(start))
    state = first['next']
    for _ in range(N_SUB - 1):
      state = jax.tree.map(np.asarray, substep(state)['next'])
    last = jax.tree.map(np.asarray, substep(state))
  return m, start, first, state, last


def _joint_equality_models(m, tm):
  """The fetch models with their four tendon couplings replaced by two
  JOINT equalities (a knee held at a quartic of its hip's pitch, an ankle
  at a constant) and with contacts and limits off, so that their rows are
  functions of qpos alone: (JAX model, port model)."""
  jid = lambda name: tm.names.name2id('joint', name)
  obj1 = (jid('knee_front_left'), jid('ankle_back_right'))
  obj2 = (jid('pitch_front_left'), -1)
  data = np.zeros((2, 11))
  data[0, :5] = [0.1, 0.5, -0.3, 0.2, 0.05]
  data[1, 0] = 0.2
  solref = np.array([[0.02, 1.0], [0.01, 0.8]])
  solimp = np.array([[0.9, 0.95, 0.001, 0.5, 2.0],
                     [0.8, 0.9, 0.01, 0.5, 2.0]])
  off = int(constants.DisableBit.CONTACT | constants.DisableBit.LIMIT)
  eq = dict(neq=2, eq_type=(int(constants.EqType.JOINT),) * 2,
            eq_obj1id=obj1, eq_obj2id=obj2)
  with jax.enable_x64(True):
    mj = m.replace(opt=m.opt.replace(disableflags=m.opt.disableflags | off),
                   eq_data=jnp.asarray(data), eq_solref=jnp.asarray(solref),
                   eq_solimp=jnp.asarray(solimp),
                   eq_active0=jnp.ones(2, dtype=jnp.float64), **eq)
  t = lambda a: torch.as_tensor(a, dtype=torch.float64)
  tm = tm.replace(opt=tm.opt.replace(disableflags=tm.opt.disableflags | off),
                  eq_data=t(data), eq_solref=t(solref), eq_solimp=t(solimp),
                  eq_active0=torch.ones(2, dtype=torch.float64), **eq)
  return mj, tm


def _check_joint_equality(tm_joint, qpos, want):
  """JOINT equality rows against the JAX ones, and a solve through them."""
  d = ttypes.make_data(tm_joint, B).replace(qpos=torch.as_tensor(qpos))
  got = tconstraint.make_rows(tm_joint, d)
  assert got.J.shape[-1] == 2 and got.eq.all()
  assert (want['joint_rows.eq_mask'] == 1.0).all()
  for k in ROW_FIELDS:
    assert_close(np_(getattr(got, k)), want['joint_rows.' + k], TOL_SMOOTH,
                 'joint_rows.' + k)
  assert torch.isfinite(tforward.forward(tm_joint, d).qacc).all()


def _compare(want, got, prefix, tol):
  keys = [k for k in want if k.startswith(prefix)]
  assert keys
  for k in keys:
    assert_close(got[k], want[k], tol, k)


def test_fetch_step_matches_jax(fetch_case):
  """One test item, so that one worker compiles the JAX substep:

  - JOINT equality rows, on the fetch model with its couplings replaced
    by two joint equalities, at TOL_SMOOTH;
  - the first substep's stages: kinematics, collision (the five new pair
    functions and MPR inside the model), smooth dynamics with the filter
    activations, at TOL_SMOOTH; the rows (tendon equality, limits, condim
    1, 3 and 6 contacts) at TOL_SMOOTH; the solve, the contact forces,
    every sensor (FORCE, TORQUE and ACCELEROMETER on live contacts,
    SUBTREECOM) and the Euler update of qpos, qvel and act at TOL_SOLVE;
  - one control step of BatchedEnvironment.step_core (N_SUB substeps),
    then the observations and rewards of fetch, walk and run on the full
    forward of its end state, at TOL_SOLVE. step_core's own observations
    are held too, but for `imu` and `force_torque`: like the JAX
    environment it carries the acceleration-stage sensors of the state
    it was given.
  """
  m, start, first, state, last = fetch_case
  env = _torch_env('fetch')
  tm = env.model
  assert env.n_sub_steps == N_SUB
  got = _port_substep(tm, start)

  # the inputs hold every row type
  sel = np.asarray(tm.sel_condim)
  active = first['contact.active']
  for c in (1, 3, 6):
    assert active[:, sel == c].any(axis=1).all(), f'condim {c}'
  eq = first['rows.eq_mask'][0] == 1.0
  assert eq.sum() == 4 and (first['rows.slot_active'][:, eq] == 1).all()
  limits = slice(4, 4 + 12)   # the hinges' limit rows follow
  assert (first['rows.slot_active'][:, limits].sum(axis=1) >= 1).all()
  assert ((first['rows.slot_active'] > 0).sum(axis=1) <= JAX_ROW_BUDGET).all()

  _compare(first, got, 'pos.', TOL_SMOOTH)
  _compare(first, got, 'vel.', TOL_SMOOTH)
  # slots and rows that do not act are held in what they mean, depth and
  # activity: the compaction of the slots keeps the deepest of each
  # condim group, and among slots out of reach it breaks ties that are
  # exact in real arithmetic (the thighs' inner ends sit 0.4 apart at any
  # angle) by the rounding of their depths, which differs between sides
  live_slot = active
  live_row = first['rows.slot_active'] > 0
  for k in CONTACT_FIELDS:
    want, have = first['contact.' + k], got['contact.' + k]
    if k not in ('dist', 'active'):
      want, have = want[live_slot], have[live_slot]
    assert_close(have, want, TOL_SMOOTH, 'contact.' + k)
  for k in ROW_FIELDS + ('eq_mask',):
    want, have = first['rows.' + k], got['rows.' + k]
    if k == 'J':
      want, have = want.swapaxes(1, 2), have.swapaxes(1, 2)
    if k not in ('slot_active', 'eq_mask'):
      want, have = want[live_row], have[live_row]
    assert_close(have, want, TOL_SMOOTH, 'rows.' + k)
  _compare(first, got, 'solve.', TOL_SOLVE)
  assert_close(got['sensordata'], first['sensordata'], TOL_SOLVE,
               'sensordata')
  for k in ('qpos', 'qvel', 'act'):
    assert_close(got['next.' + k], first['next'][k], TOL_SOLVE, 'next.' + k)
  _check_joint_equality(_joint_equality_models(m, tm)[1], start['qpos'],
                        first)

  tasks = {k: make(tquadruped, tm) for k, make in TASKS.items()}
  benv = BatchedEnvironment(tm, tasks['fetch'], batch_size=B,
                            n_sub_steps=N_SUB)
  s0 = {k: torch.as_tensor(np.array(v)) for k, v in start.items()}
  new_state, obs, reward, _, diverged = benv.step_core(s0, s0['ctrl'])
  assert not bool(diverged.any())
  for k in ('qpos', 'qvel', 'act'):
    assert_close(np_(new_state[k]), state[k], TOL_SOLVE, k)
  for k, v in obs.items():
    if k not in ('imu', 'force_torque'):
      assert_close(np_(v), last['obs']['fetch'][k], TOL_SOLVE,
                   f'step_core obs.{k}')
  assert_close(np_(reward), last['reward']['fetch'], TOL_SOLVE, 'reward')
  d = tforward.forward(tm, tforward.inflate(tm, new_state))
  for name, task in tasks.items():
    o = task.get_observation(tm, d)
    want = last['obs'][OBS_OF[name]]
    assert list(o) == list(want)
    for k, v in o.items():
      assert_close(np_(v), want[k], TOL_SOLVE, f'{name} {k}')
    assert_close(np_(task.get_reward(tm, d)), last['reward'][name],
                 TOL_SOLVE, f'{name} reward')


# ---------------------------------------------------------------------------
# the initializers

@pytest.mark.parametrize('task', ['walk', 'fetch'])
def test_initializer_draws_contact_free_lowest_height(task):
  """suite.load builds the task on the CPU (its factory defaults to the
  card); initialize_episode leaves every env without an active contact,
  at the lowest height on the 0.01 grid that has none (0.01 lower
  touches), with a random unit root quaternion; fetch's spawn: a pure
  azimuth, the root and the ball within 0.9 of the floor's half-size, the
  ball at z = 2 with a planar velocity and every other velocity 0."""
  assert inspect.signature(getattr(tquadruped, task)).parameters[
      'device'].default == 'cuda'
  env = _torch_env(task)
  tm, n = env.model, 4
  data = env.task.initialize_episode(tm, ttypes.make_data(tm, n),
                                     torch.Generator().manual_seed(3))
  q = data.qpos.clone()

  def n_contacts(qpos):
    d = ttypes.make_data(tm, n).replace(qpos=qpos)
    d = tsmooth.kinematics(tm, d)
    return np_(tcollision.collision(tm, d).contact.active.sum(dim=-1))

  assert (n_contacts(q) == 0).all()
  z = np_(q[:, 2])
  assert (z > 0).all() and np.allclose(np.round(z / 0.01) * 0.01, z,
                                       atol=1e-9)
  lower = q.clone()
  lower[:, 2] -= 0.01
  assert (n_contacts(lower) > 0).all()
  quat = np_(q[:, 3:7])
  assert np.allclose(np.linalg.norm(quat, axis=1), 1.0)
  if task == 'fetch':
    floor = float(tm.geom_size[tm.names.name2id('geom', 'floor'), 0])
    assert (np.abs(quat[:, 1:3]) < 1e-12).all() and quat[:, 3].std() > 0.1
    ball_q = tm.jnt_qposadr[tm.names.name2id('joint', 'ball_root')]
    ball_v = tm.jnt_dofadr[tm.names.name2id('joint', 'ball_root')]
    for xy in (np_(q[:, :2]), np_(q[:, ball_q:ball_q + 2])):
      assert (np.abs(xy) <= 0.9 * floor).all() and xy.std() > 1.0
    assert (np_(q[:, ball_q + 2]) == 2.0).all()
    v = np_(data.qvel)
    assert (v[:, ball_v:ball_v + 2] != 0).all()
    v[:, ball_v:ball_v + 2] = 0
    assert (v == 0).all()
  else:
    assert (np_(q[:, :2]) == 0).all() and quat.std(axis=0).min() > 0.1
    # run: the same initializer and task code on a larger floor
    run = tquadruped.run(device='cpu', dtype=torch.float64)
    assert inspect.signature(tquadruped.run).parameters[
        'device'].default == 'cuda'
    assert isinstance(run.task, tquadruped.Move)
    assert run.task._desired_speed == 5 and env.task._desired_speed == 0.5
    assert float(run.model.geom_size[0, 0]) == 100.0
