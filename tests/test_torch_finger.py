"""The port's eleventh slice: dof frictionloss rows, elliptic contact cones,
the JOINTPOS and JOINTVEL sensors, and finger (spin, turn_easy, turn_hard).

Both sides run in float64 on the CPU from the same numpy inputs; the JAX
side enables x64 only inside a scoped context and reaches its SPD solve
through `linalg.solve_psd` (its CPU path). The lane budget: the JAX side
compiles three functions, each once for the module: the rows and the
batched solve of a small elliptic model (`_jax_solve_fn` on _CONE_XML),
the same on finger, and finger's unbatched pipeline vmapped over the
per-env model leaves (`_jax_env_fn`), which every task's control steps
reuse. The oracle and the pyramidal control compile nothing on the JAX
side.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dm_control_tpu import models as jmodels
from dm_control_tpu.ops import constraint as jconstraint
from dm_control_tpu.ops import forward as jforward
from dm_control_tpu.ops import sensor as jsensor
from dm_control_tpu.suite import common as jcommon
from dm_control_tpu.suite import finger as jfinger

from dm_control_tpu_torch import models as tmodels
from dm_control_tpu_torch import suite
from dm_control_tpu_torch.models import constants
from dm_control_tpu_torch.models import types as ttypes
from dm_control_tpu_torch.ops import collision as tcollision
from dm_control_tpu_torch.ops import constraint as tconstraint
from dm_control_tpu_torch.ops import cuda_kernels
from dm_control_tpu_torch.ops import forward as tforward
from dm_control_tpu_torch.ops import sensor as tsensor
from dm_control_tpu_torch.ops import smooth as tsmooth
from dm_control_tpu_torch.parallel import BatchedEnvironment
from dm_control_tpu_torch.suite import base as tbase
from dm_control_tpu_torch.suite import common as tcommon
from dm_control_tpu_torch.suite import finger as tfinger

from test_torch_slice import (TOL_SMOOTH, TOL_SOLVE, assert_close,
                              jax_model_to_numpy, np_)

# One intra-op thread: the batches here are tiny, and pytest-xdist workers
# share the host's cores, where a thread pool per worker only contends.
torch.set_num_threads(1)

ROW_FIELDS = ('J', 'pos', 'margin', 'solref', 'solimp', 'invweight',
              'slot_active')
SOLVE_FIELDS = ('qacc', 'qfrc_constraint', 'efc_force', 'solver_niter')

# A small elliptic model: condim 1, 3, 4 and 6 contact groups of two free
# bodies against the floor (contype/conaffinity keep to the floor pairs),
# and a two-link arm without contacts, its first hinge with frictionloss
# beside its limit, its second with frictionloss and held by a JOINT
# equality to the first.
_CONE_XML = """
<mujoco>
  <option timestep="0.005" cone="elliptic"/>
  <default>
    <geom contype="2" conaffinity="1"/>
  </default>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 .1" condim="1" contype="1"
          conaffinity="2"/>
    <body name="a" pos="0 0 .095">
      <freejoint/>
      <geom type="sphere" size=".1" condim="3" friction="1 .02 .001"/>
      <geom type="sphere" size=".05" pos=".15 0 -.05" condim="6"
            friction=".8 .03 .002"/>
    </body>
    <body name="b" pos=".6 0 .048">
      <freejoint/>
      <geom type="capsule" size=".05 .1" euler="0 90 0" condim="4"
            friction=".7 .05 .003"/>
      <geom type="sphere" size=".06" pos="0 .12 0" condim="1"/>
    </body>
    <body name="arm" pos="-.6 0 .48">
      <joint name="h1" type="hinge" axis="0 1 0" frictionloss=".3"
             limited="true" range="-30 30"/>
      <geom type="capsule" size=".03" fromto="0 0 0 0 0 -.45" contype="0"
            conaffinity="0"/>
      <body pos="0 0 -.45">
        <joint name="h2" type="hinge" axis="0 1 0" frictionloss=".2"/>
        <geom type="sphere" size=".04" contype="0" conaffinity="0"/>
      </body>
    </body>
  </worldbody>
  <equality>
    <joint joint1="h2" joint2="h1" polycoef="0 .5 0 0 0"/>
  </equality>
</mujoco>
"""
B_CONE = 4
B_SOLVE = 8      # finger states for the solver: contacts in three zones
B_ENV = 4        # envs of each task's control steps
N_STEPS = 3      # control steps a task


def _jax_build(xml, **kw):
  with jax.enable_x64(True):
    return jmodels.from_xml_string(xml, dtype=jnp.float64, **kw)


def _check_build(m, tm):
  """The port's build of an MJCF is the JAX package's: static fields
  exactly, arrays to 1e-12."""
  arrays, meta = jax_model_to_numpy(m)
  t_arrays, t_meta = tmodels.model_to_numpy(tm)
  for k, v in t_meta.items():
    if k not in ('names', 'opt'):
      assert v == meta[k], k
  for k, v in t_arrays.items():
    if k != 'opt':
      assert_close(v, arrays[k], 1e-12, k)


def _aref_jax(m, rows, D):
  """The JAX batched solver's aref of each row (its own helpers)."""
  pmm = rows.pos - rows.margin
  imp = jconstraint._impedance(rows.solimp, pmm)
  vel = jnp.einsum('bv,bve->be', D.qvel, rows.J)
  spring = jnp.asarray(jconstraint._elliptic_spring_scale(
      m, rows.J.shape[-1]), D.qpos.dtype)
  return jconstraint._kbip(m, rows.solref, rows.solimp, imp, pmm * spring,
                           vel)


def _aref_torch(m, rows, d):
  """The port's aref of each row, as fwd_constraint_batched computes it."""
  pmm = rows.pos - rows.margin
  imp = tconstraint._impedance(rows.solimp, pmm)
  vel = torch.einsum('bv,bve->be', d.qvel, rows.J)
  spring = torch.ones(rows.J.shape[-1], dtype=d.qpos.dtype)
  for s0, k, c in tconstraint._elliptic_groups(m):
    spring[s0:s0 + k * c] = torch.tensor([1.0] + [0.0] * (c - 1)).repeat(k)
  return tconstraint._kbip(m, rows.solref, rows.solimp, imp, pmm * spring,
                           vel)


def _jax_solve_fn(m, maps=False):
  """Batched: the position stage, the rows (make_rows per env) and their
  aref; then the velocity stage with its sensors, the smooth acceleration
  and the JAX batched solver, or with `maps` the solver's four cone-aware
  row maps at given qacc x and direction p (force, cost,
  H = M + Jh' diag(w) Jh, and the line search's per-row terms at
  jar + 0.7 J p)."""
  vm = lambda f: jax.vmap(lambda d: f(m, d))

  def fn(state, x=None, p=None):
    D = jax.vmap(lambda s: jforward.inflate(m, s))(state)
    D = vm(lambda mm, d: jforward.fwd_position(mm, d, factor=False))(D)
    if not maps:
      D = vm(jforward.fwd_velocity)(D)
      D = vm(lambda mm, d: jsensor.sensors(mm, d, stages='pv'))(D)
      D = vm(jforward.fwd_actuation)(D)
      D = jforward.fwd_acceleration_batched(m, D)
    rows = vm(jconstraint.make_rows)(D)
    out = {'rows.' + k: getattr(rows, k) for k in ROW_FIELDS + (
        'eq_mask', 'frictionloss', 'mu')}
    out['aref'] = aref = _aref_jax(m, rows, D)
    out['contact.active'] = D.contact.active
    if maps:
      imp = jconstraint._impedance(rows.solimp, rows.pos - rows.margin)
      r = jnp.maximum((1.0 - imp) / imp * rows.invweight, 1e-12)
      dweight = jnp.where(rows.slot_active > 0, 1.0 / r, 0.0)

      def one(J, dw, eq_mask, floss, mu, a, xb, pb, M):
        args = (dw, eq_mask == 1.0, eq_mask == 2.0, floss, mu,
                jconstraint._elliptic_groups(m))
        jar, jp = xb @ J - a, pb @ J
        w, Jh = jconstraint._hess_cone(jar, J, *args)
        drows, ddrows = jconstraint._ls_rows_cone(jar + 0.7 * jp, jp, *args)
        return {'force': jconstraint._row_force_cone(jar, *args),
                'cost': jconstraint._cost_rows_cone(jar, *args),
                'H': M + jnp.einsum('ve,e,we->vw', Jh, w, Jh),
                'ls_d': drows, 'ls_dd': ddrows}

      out.update(jax.vmap(one)(rows.J, dweight, rows.eq_mask,
                               rows.frictionloss, rows.mu, aref, x, p, D.qM))
      out['contact_force'] = jax.vmap(
          lambda d, f: jconstraint._contact_forces(m, d, f, f.dtype))(
              D, out['force'])
      return out
    out['sensordata'] = D.sensordata
    D = jconstraint.fwd_constraint_batched(m, D)
    out.update({'solve.' + k: getattr(D, k) for k in SOLVE_FIELDS})
    out['solve.contact_force'] = D.contact.force
    return out

  return jax.jit(fn)


def _torch_solve(tm, state, x=None, p=None):
  """The port's counterpart of _jax_solve_fn (maps when x and p are
  given)."""
  d = tforward.inflate(tm, {k: torch.as_tensor(v) for k, v in state.items()})
  d = tforward.fwd_position(tm, d)
  if x is None:
    d = tsensor.sensors(tm, tforward.fwd_velocity(tm, d), stages='pv')
    d = tforward.fwd_acceleration_batched(tm, tforward.fwd_actuation(tm, d))
  rows = tconstraint.make_rows(tm, d)
  out = {'rows.' + k: getattr(rows, k) for k in ROW_FIELDS}
  aref = _aref_torch(tm, rows, d)
  out.update({'rows.fric': rows.fric, 'rows.floss': rows.floss,
              'rows.mu': rows.mu, 'rows.eq': rows.eq, 'aref': aref,
              'contact.active': d.contact.active})
  if x is not None:
    imp = tconstraint._impedance(rows.solimp, rows.pos - rows.margin)
    r = torch.clamp((1.0 - imp) / imp * rows.invweight, min=1e-12)
    dweight = torch.where(rows.slot_active > 0, 1.0 / r, torch.zeros_like(r))
    cone = tconstraint._Cone(rows, dweight, tconstraint._elliptic_groups(tm))
    jar = torch.einsum('bv,bve->be', torch.as_tensor(x), rows.J) - aref
    jp = torch.einsum('bv,bve->be', torch.as_tensor(p), rows.J)
    w, Jh = cone.hess(jar, rows.J)
    out['ls_d'], out['ls_dd'] = cone.ls_rows(jar + 0.7 * jp, jp)
    force = cone.force(jar)
    out.update(force=force, cost=cone.cost(jar),
               H=d.qM + torch.einsum('bve,be,bwe->bvw', Jh, w, Jh),
               contact_force=tconstraint._contact_forces(tm, d, force))
  else:
    out['sensordata'] = d.sensordata
    d = tconstraint.fwd_constraint_batched(tm, d)
    out.update({'solve.' + k: getattr(d, k) for k in SOLVE_FIELDS})
    out['solve.contact_force'] = d.contact.force
  return {k: np_(v) for k, v in out.items()}


def _state(tm, qpos, qvel, ctrl=None):
  n = qpos.shape[0]
  return {'time': np.zeros(n), 'qpos': qpos, 'qvel': qvel,
          'act': np.zeros((n, tm.na)),
          'ctrl': np.zeros((n, tm.nu)) if ctrl is None else ctrl,
          'qacc': np.zeros((n, tm.nv)),
          'qacc_warmstart': np.zeros((n, tm.nv)),
          'sensordata': np.zeros((n, tm.nsensordata))}


def _compare_rows(want, got, tm):
  """The rows where they act, activity everywhere, and their kinds."""
  live = want['rows.slot_active'] > 0
  assert_close(got['rows.slot_active'], want['rows.slot_active'], 0,
               'slot_active')
  for k in ROW_FIELDS[:-1]:
    w, g = want['rows.' + k], got['rows.' + k]
    if k == 'J':
      w, g = w.swapaxes(1, 2), g.swapaxes(1, 2)
    assert_close(g[live], w[live], TOL_SMOOTH, 'rows.' + k)
  assert_close(got['aref'][live], want['aref'][live], TOL_SMOOTH, 'aref')
  eq_mask = want['rows.eq_mask'][0]
  assert (got['rows.eq'] == (eq_mask == 1.0)).all()
  assert (got['rows.fric'] == (eq_mask == 2.0)).all()
  assert_close(got['rows.floss'], want['rows.frictionloss'][0], 0, 'floss')
  assert_close(got['rows.mu'][live], want['rows.mu'][live], TOL_SMOOTH,
               'mu')
  assert tconstraint._num_noncontact_rows(tm) == \
      jconstraint._num_noncontact_rows(tm)


# ---------------------------------------------------------------------------
# rows and solve of a small elliptic model


def _cone_case():
  m = _jax_build(_CONE_XML)
  tm = tmodels.from_xml_string(_CONE_XML, device='cpu', dtype=torch.float64)
  rng = np.random.default_rng(21)
  qpos = np.tile(np_(tm.qpos0), (B_CONE, 1))
  for adr in (0, 7):        # the free bodies: small shifts and tilts
    qpos[:, adr:adr + 2] += rng.uniform(-.05, .05, (B_CONE, 2))
    qpos[:, adr + 2] += rng.uniform(-.004, .002, B_CONE)
    quat = np.array([1, 0, 0, 0]) + rng.normal(0, .02, (B_CONE, 4))
    qpos[:, adr + 3:adr + 7] = quat / np.linalg.norm(quat, axis=1,
                                                     keepdims=True)
  qpos[:, 14] = rng.uniform(-.4, .4, B_CONE)
  qpos[0, 14] = 0.55        # past h1's limit (30 degrees)
  qpos[:, 15] = rng.uniform(-.3, .3, B_CONE)
  qvel = np.zeros((B_CONE, tm.nv))
  qvel[3] = rng.normal(0, .1, tm.nv)
  state = _state(tm, qpos, qvel)
  # accelerations of the free bodies that put their floor contacts in each
  # zone of the cone: away from the floor (top), into it (bottom), along
  # it (middle), and random
  x = np.zeros((B_CONE, tm.nv))
  for adr in (0, 6):
    x[0, adr + 2] = 50.0
    x[1, adr + 2] = -50.0
    x[2, adr:adr + 3] = [50.0, 20.0, -20.0]
  x[3] = rng.uniform(-20, 20, tm.nv)
  p = rng.normal(0, 5, (B_CONE, tm.nv))
  with jax.enable_x64(True):
    want = jax.tree.map(np.asarray, _jax_solve_fn(m, maps=True)(state, x, p))
  return m, tm, want, _torch_solve(tm, state, x, p)


@pytest.fixture(scope='module')
def cone_case():
  return _cone_case()


def test_cone_model_rows_and_maps_match_jax(cone_case):
  """A model with condim 1, 3, 4 and 6 elliptic groups, two frictionloss
  dofs, a joint limit and a JOINT equality: the build; the row order
  (equality, frictionloss, limit, then contacts by condim, c raw rows a
  slot of condim c > 1); J, pos, margin, solref, solimp, invweight, aref
  and mu of every live row, the row kinds and frictionloss at TOL_SMOOTH;
  and the solver's cone-aware maps (force, per-row cost, the Newton
  Hessian, the line search's per-row terms) and the contact-frame forces
  of that force at TOL_SMOOTH, with the live
  contacts of every elliptic group in more than one zone of the cone and
  all three zones seen. (The whole solve on this model is held on finger
  below: here most batches stop at the iteration cap on both sides,
  where two iterates need not agree.)"""
  m, tm, want, got = cone_case
  _check_build(m, tm)
  assert sorted(set(tm.sel_condim)) == [1, 3, 4, 6]
  assert int(tm.opt.cone) == int(constants.ConeType.ELLIPTIC)
  groups = tconstraint._elliptic_groups(tm)
  assert [c for _, _, c in groups] == [3, 4, 6]
  n_eq, n_fl, n_lim = 1, 2, 1
  assert tconstraint._num_noncontact_rows(tm) == n_eq + n_fl + n_lim
  nefc = got['rows.J'].shape[-1]
  assert nefc == tm.nefc_max
  assert list(np.nonzero(got['rows.fric'])[0]) == [1, 2]
  active = want['contact.active']
  for c in (1, 3, 4, 6):
    slots = [s for s in range(tm.ncon_sel) if tm.sel_condim[s] == c]
    assert active[:, slots].any(), f'no live condim-{c} contact'
  assert (want['rows.slot_active'][:, n_eq + n_fl] > 0).any(), 'limit row'
  _compare_rows(want, got, tm)
  for k in ('force', 'cost', 'H', 'ls_d', 'ls_dd', 'contact_force'):
    assert_close(got[k], want[k], TOL_SMOOTH, k)
  seen = set()
  for group in groups:
    live = got['rows.slot_active'][:, group[0]:group[0] + group[1] * group[
        2]:group[2]] > 0
    zones = set(_zones(got['rows.mu'], want['force'], group)[live])
    assert len(zones) > 1, (group, zones)
    seen |= zones
  assert seen == {'top', 'middle', 'bottom'}


# ---------------------------------------------------------------------------
# finger: the build, the solver in the cone's three zones, the sensors


@functools.lru_cache(maxsize=None)
def _torch_env(task):
  return suite.load('finger', task, device='cpu', dtype=torch.float64)


def _finger_jax_model():
  return _jax_build(jfinger.make_model(), assets=jcommon.ASSETS)


def _contact_qpos(tm, rng, n, depth=(-.008, -.0005)):
  """n random finger poses whose fingertip touches the spinner, the
  deepest penetration in `depth`, from rejection sampling on the port."""
  out = []
  while len(out) < n:
    d = ttypes.make_data(tm, 2048)
    q = np.tile(np_(tm.qpos0), (2048, 1))
    q[:, 0] = rng.uniform(-1.9, 1.9, 2048)
    q[:, 1] = rng.uniform(-1.9, 1.9, 2048)
    q[:, 2] = rng.uniform(-np.pi, np.pi, 2048)
    d = tsmooth.kinematics(tm, d.replace(qpos=torch.as_tensor(q)))
    con = tcollision.collision(tm, d).contact
    dist = torch.where(con.active, con.dist, torch.zeros_like(con.dist))
    deepest = np_(dist.min(dim=-1).values)
    ok = (deepest > depth[0]) & (deepest < depth[1])
    out.extend(q[ok])
  return np.array(out[:n])


def _finger_solve_case():
  """B_SOLVE finger states: six in contact with velocities from still to
  fast (the cone's bottom, middle and top zones) and pushing controls, two
  free with the hinge still (the frictionloss row inside its kink) and
  fast (outside it)."""
  m = _finger_jax_model()
  tm = _torch_env('turn_hard').model
  rng = np.random.default_rng(3)
  qpos = np.concatenate([_contact_qpos(tm, rng, 6),
                         np.tile(np_(tm.qpos0), (2, 1))])
  qvel = np.zeros((B_SOLVE, 3))
  qvel[:6] = rng.normal(0, 1, (6, 3)) * np.array([0, .3, 1, 3, 8, 15])[
      :, None]
  qvel[7, 2] = 6.0
  ctrl = rng.uniform(-1, 1, (B_SOLVE, 2))
  state = _state(tm, qpos, qvel, ctrl)
  with jax.enable_x64(True):
    m = m.replace(site_pos=jnp.asarray(np_(tm.site_pos)),
                  site_size=jnp.asarray(np_(tm.site_size)))
    want = jax.tree.map(np.asarray, _jax_solve_fn(m)(state))
  return m, tm, state, want, _torch_solve(tm, state)


@pytest.fixture(scope='module')
def finger_solve_case():
  return _finger_solve_case()


def _zones(rows_mu, force, group):
  """(B, k) cone zone of each slot of an elliptic group (first row, slots,
  condim) from its forces: 'top' no force, 'middle' on the cone
  (|fT| = mu fN), 'bottom' inside it."""
  s0, k, c = group
  f = force[:, s0:s0 + k * c].reshape(-1, k, c)
  mu = rows_mu[:, s0:s0 + k * c:c]
  ft = np.linalg.norm(f[..., 1:], axis=-1)
  return np.where(np.abs(f).max(-1) == 0, 'top', np.where(
      np.abs(ft - mu * f[..., 0]) <= 1e-9 * np.maximum(1, f[..., 0]),
      'middle', 'bottom'))


def test_finger_solve_matches_jax(finger_solve_case):
  """finger's build is the JAX package's; its rows (the hinge's
  frictionloss row, two limits, 33 condim-3 elliptic slots) and aref at
  TOL_SMOOTH; the batched Newton solve, qacc, efc_force and contact forces
  at TOL_SOLVE, on states whose live contacts fall in all three cone zones
  and whose frictionloss row lies on both sides of its kink."""
  m, tm, state, want, got = finger_solve_case
  _check_build(m, tm)
  assert tfinger.make_model() == jfinger.make_model()
  assert tm.nv == 3 and tm.opt.solver_iterations == 32
  assert list(tm.dof_hasfrictionloss) == [0, 0, 1]
  _compare_rows(want, got, tm)
  for k in SOLVE_FIELDS + ('contact_force',):
    assert_close(got['solve.' + k], want['solve.' + k], TOL_SOLVE, k)
  live = want['contact.active']
  assert live[:6].any(axis=1).all() and not live[6:].any()
  group, = tconstraint._elliptic_groups(tm)
  zone = _zones(got['rows.mu'], want['solve.efc_force'], group)
  assert list(tm.sel_condim) == [3] * tm.ncon_sel
  seen = set(zone[live])
  assert seen == {'top', 'middle', 'bottom'}, seen
  fl = int(np.nonzero(got['rows.fric'])[0][0])
  floss = float(got['rows.floss'][fl])
  f_fl = np.abs(want['solve.efc_force'][:, fl])
  assert f_fl[6] < 0.5 * floss and abs(f_fl[7] - floss) < 1e-12


def test_joint_sensors_match_jax(finger_solve_case):
  """JOINTPOS (proximal, distal) and JOINTVEL (proximal, distal, hinge)
  and the rest of finger's position/velocity-stage sensors against the JAX
  sensor function, at TOL_SMOOTH."""
  m, tm, state, want, got = finger_solve_case
  types = set(tm.sensor_type)
  assert {constants.SensorType.JOINTPOS,
          constants.SensorType.JOINTVEL} <= types
  pv = [i for i in range(tm.nsensor)
        if tm.sensor_type[i] != constants.SensorType.TOUCH]
  idx = np.concatenate([np.arange(tm.sensor_adr[i],
                                  tm.sensor_adr[i] + tm.sensor_dim[i])
                        for i in pv])
  assert_close(got['sensordata'][:, idx], want['sensordata'][:, idx],
               TOL_SMOOTH, 'sensordata')
  assert_close(got['sensordata'][:, :2], state['qpos'][:, :2], 0,
               'jointpos')
  assert_close(got['sensordata'][:, 2:5], state['qvel'], 0, 'jointvel')


# ---------------------------------------------------------------------------
# the slice: each task's control steps, env by env, against the unbatched
# JAX pipeline on env b's own model


def _jax_env_fn(m):
  """env b's pipeline on its own model (site_pos, dof_damping, site_size
  rows), vmapped over them and the state: the position/velocity stage, its
  sensors and the observations and rewards of both tasks (Turn's
  observation holds Spin's), then the acceleration stage with its sensors
  (touch), and the state after one Euler substep."""
  spin, turn = jfinger.Spin(m), jfinger.Turn(m, jfinger._HARD_TARGET_SIZE)

  def one(site_pos, damping, site_size, s):
    mb = m.replace(site_pos=site_pos, dof_damping=damping,
                   site_size=site_size)
    d = jforward.fwd_pv(mb, jforward.inflate(mb, s))
    out = {'obs': turn.get_observation(mb, d),
           'spin_reward': spin.get_reward(mb, d),
           'turn_reward': turn.get_reward(mb, d)}
    d = jforward.fwd_aa(mb, d)
    out['sensordata'] = d.sensordata
    out['next'] = jforward.slim_state(jforward._integrate(mb, d))
    return out

  return jax.jit(jax.vmap(one))


@pytest.fixture(scope='module')
def jax_env_fn():
  with jax.enable_x64(True):
    return _jax_env_fn(_finger_jax_model())


TASKS = ('spin', 'turn_easy', 'turn_hard')


@pytest.mark.parametrize('task', TASKS)
def test_control_steps_match_jax(task, jax_env_fn):
  """N_STEPS control steps of BatchedEnvironment.step (2 Euler substeps
  each) from B_ENV states, two of them in contact: each env's new state at
  TOL_SOLVE against two substeps of the JAX pipeline on its own model;
  its observation (but touch) and reward of that state at TOL_SMOOTH, and
  touch, the last substep's contact forces, at TOL_SOLVE. turn_hard's
  episodes last two control steps, staggered: the envs that finish draw a
  new target on the hinge's circle, the others keep theirs, and a reset
  env's first observation is that of its fresh state on its new model."""
  env = _torch_env(task)
  tm = env.model
  assert env.n_sub_steps == 2
  resets = task == 'turn_hard'
  benv = BatchedEnvironment(
      tm, env.task, batch_size=B_ENV, n_sub_steps=2, seed=5,
      time_limit=2 * 2 * float(tm.opt.timestep) if resets else float('inf'))
  benv.reset()
  rng = np.random.default_rng(8)
  qpos = np.concatenate([_contact_qpos(tm, rng, 2),
                         np_(benv.state['qpos'][2:])])
  state = _state(tm, qpos, rng.normal(0, 2, (B_ENV, 3)),
                 rng.uniform(-1, 1, (B_ENV, 2)))
  s = {k: torch.as_tensor(v) for k, v in state.items()}
  benv.set_state(s, steps=torch.tensor([0, 1, 0, 1]) if resets else None)
  leaves = benv.leaves
  if task == 'spin':
    assert leaves == {}
    assert float(tm.dof_damping[2]) == .03
  else:
    assert list(leaves) == ['site_pos']

  def jax_rows():
    site_pos = np_(leaves['site_pos']) if leaves else np.tile(
        np_(tm.site_pos), (B_ENV, 1, 1))
    return (site_pos, np.tile(np_(tm.dof_damping), (B_ENV, 1)),
            np.tile(np_(tm.site_size), (B_ENV, 1, 1)))

  touch = slice(tm.sensor_adr[8], tm.sensor_adr[9] + 1)
  n_reset = 0
  with jax.enable_x64(True):
    rows = jax_rows()
    here = jax.tree.map(np.asarray, jax_env_fn(*rows, state))
    for _ in range(N_STEPS):
      before = {k: v.clone() for k, v in leaves.items()}
      actions = rng.uniform(-1, 1, (B_ENV, 2))
      state['ctrl'] = actions
      mid = jax.tree.map(np.asarray, jax_env_fn(*rows, state))
      last = jax.tree.map(np.asarray, jax_env_fn(*rows, mid['next']))
      obs, reward, done = benv.step(torch.as_tensor(actions))
      leaves = benv.leaves
      done = np_(done)
      new = {k: np_(v) for k, v in benv.state.items()}
      after = jax.tree.map(np.asarray, jax_env_fn(*jax_rows(), new))
      live = ~done
      for k in ('qpos', 'qvel'):
        assert_close(new[k][live], last['next'][k][live], TOL_SOLVE, k)
      reward_key = 'spin_reward' if task == 'spin' else 'turn_reward'
      want_reward = np.where(done, np.nan, after[reward_key])
      assert_close(np_(reward)[live], want_reward[live], TOL_SMOOTH,
                   'reward')
      for k, v in obs.items():
        if k != 'touch':
          assert_close(np_(v), after['obs'][k], TOL_SMOOTH, 'obs.' + k)
      want_touch = np.where(done[:, None], after['sensordata'][:, touch],
                            last['sensordata'][:, touch])
      assert_close(np_(obs['touch']), np.log1p(want_touch), TOL_SOLVE,
                   'obs.touch')
      if resets:
        moved = (np_(leaves['site_pos']) != np_(before['site_pos'])).any(
            axis=(1, 2))
        assert (moved == done).all()
        n_reset += int(done.sum())
      else:
        assert not done.any()
      state, rows = new, jax_rows()
  assert n_reset == (6 if resets else 0)


def test_turn_draws_targets_on_the_hinge_circle():
  """suite.load serves the three tasks (their factories default to the
  card); 2000 draws of turn_easy's target lie on the circle of radius
  .13 about the hinge (x .2, z .4) at angles spread over [-pi, pi), and
  every other site keeps its compiled position."""
  for task in TASKS:
    assert inspect.signature(getattr(tfinger, task)).parameters[
        'device'].default == 'cuda'
  env = _torch_env('turn_easy')
  tm = env.model
  leaves = env.task.randomize_model(tm, 2000, torch.Generator().manual_seed(2))
  v = np_(leaves['site_pos'])
  target = tm.names.name2id('site', 'target')
  assert (np.delete(v, target, axis=1) ==
          np.delete(np_(tm.site_pos), target, axis=0)).all()
  x, y, z = v[:, target].T
  assert (y == 0).all()
  assert np.allclose(np.hypot(x - .2, z - .4), .13, atol=1e-12)
  angle = np.arctan2(x - .2, z - .4)
  assert angle.min() < -3.0 and angle.max() > 3.0
  assert float(tm.site_size[target, 0]) == tfinger._EASY_TARGET_SIZE


# ---------------------------------------------------------------------------
# against the oracle


def test_trajectory_matches_mujoco():
  """100 physics steps (Euler, elliptic cones, the hinge's frictionloss)
  of two envs through step_batched against MuJoCo 3.10's mj_step: one from
  the JAX package's own trajectory-parity start (qpos0 plus noise, the
  sinusoidal controls), one from a pose whose fingertip presses into the
  spinner under constant controls. qpos within 1e-6 and qvel within 1e-4
  at every step (the JAX package's band for finger,
  tests/test_trajectory_parity.py)."""
  import mujoco  # the oracle; a lane without it fails here, not skips
  tm = tmodels.from_xml_string(tfinger.make_model(),
                               assets=tcommon.read_assets(), device='cpu',
                               dtype=torch.float64)
  assets = {k: v for k, v in tcommon.read_assets().items()
            if k.startswith('./')}
  mm = mujoco.MjModel.from_xml_string(tfinger.make_model(), assets)
  rng = np.random.RandomState(0)
  q0 = mm.qpos0 + 0.01 * rng.randn(mm.nq)
  v0 = 0.05 * rng.randn(mm.nv)
  phase = rng.uniform(0, 2 * np.pi, mm.nu)
  q1 = _contact_qpos(tm, np.random.default_rng(4), 1)[0]
  mds = []
  for q, v in ((q0, v0), (q1, np.zeros(3))):
    md = mujoco.MjData(mm)
    md.qpos[:], md.qvel[:] = q, v
    mujoco.mj_forward(mm, md)
    mds.append(md)
  state = {k: torch.as_tensor(v) for k, v in _state(
      tm, np.stack([q0, q1]), np.stack([v0, np.zeros(3)])).items()}
  in_contact = 0
  for t in range(100):
    ctrl = np.stack([0.4 * np.sin(0.01 * t + phase), [-0.8, -0.3]])
    for md, u in zip(mds, ctrl):
      md.ctrl[:] = u
      mujoco.mj_step(mm, md)
    in_contact += mds[1].ncon > 0
    state['ctrl'] = torch.as_tensor(ctrl)
    state = tforward.slim_state(tforward.step_batched(
        tm, tforward.inflate(tm, state), compute_sensors=False))
    for b, md in enumerate(mds):
      qerr = np.abs(np_(state['qpos'][b]) - md.qpos).max()
      verr = np.abs(np_(state['qvel'][b]) - md.qvel).max()
      assert qerr < 1e-6, f'env {b}: qpos drift {qerr:.3e} at step {t}'
      assert verr < 1e-4, f'env {b}: qvel drift {verr:.3e} at step {t}'
  assert in_contact >= 50, in_contact


# ---------------------------------------------------------------------------
# the pyramidal paths run the parent's solver code


def _parent_fwd_constraint_batched(m, D, compute_forces=True):
  """fwd_constraint_batched as it was before frictionloss rows and
  elliptic cones, kept verbatim (but for the module prefixes)."""
  tc = tconstraint
  if m.opt.disableflags & constants.DisableBit.CONSTRAINT:
    return tc._unconstrained(m, D)
  rows = tc.make_rows(m, D)
  nefc = rows.J.shape[-1]
  if nefc == 0:
    return tc._unconstrained(m, D)
  dtype = D.qpos.dtype
  B = D.qpos.shape[0]
  J = rows.J

  pmm = rows.pos - rows.margin
  imp = tc._impedance(rows.solimp, pmm)
  vel = torch.einsum('bv,bve->be', D.qvel, J)
  aref = tc._kbip(m, rows.solref, rows.solimp, imp, pmm, vel)
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
      force=tc._contact_forces(m, D, force)))


def test_pyramidal_solve_is_the_parents_bit_for_bit():
  """humanoid.run (pyramidal condim-3 contacts, joint limits, no
  frictionloss): make_rows carries no cone fields, and
  fwd_constraint_batched's qacc, qfrc_constraint, efc_force, contact
  forces and iteration count are torch.equal to the parent's solver's on
  states with live contacts and limits."""
  tm = suite.load('humanoid', 'run', device='cpu', dtype=torch.float64).model
  assert not tconstraint._is_cone_model(tm)
  gen = torch.Generator().manual_seed(9)
  n = 6
  qpos = tbase.random_limited_qpos(tm, n, gen)
  qpos[:, 2] = torch.linspace(0.15, 0.4, n, dtype=torch.float64)
  qvel = torch.randn((n, tm.nv), generator=gen, dtype=torch.float64)
  d = tforward.inflate(tm, {'qpos': qpos, 'qvel': qvel})
  d = tforward.fwd_velocity(tm, tforward.fwd_position(tm, d))
  d = tforward.fwd_acceleration_batched(tm, tforward.fwd_actuation(tm, d))
  rows = tconstraint.make_rows(tm, d)
  assert rows.fric is None and rows.floss is None and rows.mu is None
  assert int((rows.slot_active > 0).sum()) > 2 * n
  got = tconstraint.fwd_constraint_batched(tm, d)
  want = _parent_fwd_constraint_batched(tm, d)
  for k in ('qacc', 'qfrc_constraint', 'efc_force', 'qacc_warmstart',
            'solver_niter'):
    assert torch.equal(getattr(got, k), getattr(want, k)), k
  assert torch.equal(got.contact.force, want.contact.force)
  assert int(got.solver_niter[0]) > 1
