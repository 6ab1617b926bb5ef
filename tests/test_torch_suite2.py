"""The port's sixth slice: humanoid_CMU, ball_in_cup, point_mass (easy),
fish (upright) and lqr against the JAX package, the acceleration-stage
sensors of a control step against the C MuJoCo oracle, and models
without degrees of freedom.

Both sides run in float64 on the CPU from the same numpy inputs; the JAX
side enables x64 only inside a scoped context. The random draws of the
initializers differ (JAX keys against torch generators), so the parity
checks inject one state into both, and the port's initializers are
checked for range only.

The lane budget: the JAX side compiles one function a domain (a batched
Euler substep that also returns the observation and rewards of its
input state), used by one test item a domain; lqr's is lqr_6_2's, and
lqr_2_1 (the same task class on a shorter chain) is held in its build
and its XML. The oracle and dof-less tests compile nothing on the JAX
side.

The JAX batched path keeps the acceleration-stage sensors (touch,
accelerometer, force, torque) of an episode's first forward in its
observations; the port takes them from the last substep's solve, as
MuJoCo's `Physics.step` does. So the observations that read them,
hopper's `touch` and quadruped's `imu` and `force_torque`, are held
against MuJoCo (`test_acc_stage_observations_match_mujoco`).
"""

import functools
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dm_control_tpu import models as jmodels
from dm_control_tpu.ops import constraint as jconstraint
from dm_control_tpu.ops import forward as jforward
from dm_control_tpu.ops import sensor as jsensor
from dm_control_tpu.suite import ball_in_cup as jball_in_cup
from dm_control_tpu.suite import common as jcommon
from dm_control_tpu.suite import fish as jfish
from dm_control_tpu.suite import humanoid_CMU as jhumanoid_CMU
from dm_control_tpu.suite import lqr as jlqr
from dm_control_tpu.suite import point_mass as jpoint_mass

from dm_control_tpu_torch import models as tmodels
from dm_control_tpu_torch import suite
from dm_control_tpu_torch.models import constants
from dm_control_tpu_torch.models import types as ttypes
from dm_control_tpu_torch.ops import constraint as tconstraint
from dm_control_tpu_torch.ops import forward as tforward
from dm_control_tpu_torch.ops import sensor as tsensor
from dm_control_tpu_torch.parallel import BatchedEnvironment
from dm_control_tpu_torch.suite import ball_in_cup as tball_in_cup
from dm_control_tpu_torch.suite import common as tcommon
from dm_control_tpu_torch.suite import fish as tfish
from dm_control_tpu_torch.suite import humanoid_CMU as thumanoid_CMU
from dm_control_tpu_torch.suite import hopper as thopper
from dm_control_tpu_torch.suite import lqr as tlqr
from dm_control_tpu_torch.suite import point_mass as tpoint_mass
from dm_control_tpu_torch.suite import quadruped as tquadruped

from test_torch_slice import (CONTACT_FIELDS, POS_FIELDS, ROW_FIELDS,
                              SOLVE_FIELDS, TOL_SMOOTH, TOL_SOLVE,
                              assert_close, jax_model_to_numpy, np_)

# One intra-op thread: the batches here are tiny, and pytest-xdist workers
# share the host's cores, where a thread pool per worker only contends.
torch.set_num_threads(1)

B = 4
LQR_SEED = 3
# the JAX batched solver keeps at most this many live rows an env when a
# model has more than 160 rows; the parity states stay within it
JAX_ROW_BUDGET = 64


def _lqr(n_bodies, n_actuators):
  return dict(
      xml=lambda mod: mod.make_model(n_bodies, n_actuators,
                                     np.random.RandomState(LQR_SEED)),
      load=dict(domain='lqr', task=f'lqr_{n_bodies}_{n_actuators}',
                random=LQR_SEED),
      tasks=[(f'lqr_{n_bodies}_{n_actuators}',
              lambda mod, m: mod.LQRLevel(m, 0.1))])


# model -> the model's XML from a suite module (JAX or port), its
# suite.load arguments, and its tasks (name, task from a suite module and
# a model)
MODELS = {
    'lqr_2_1': _lqr(2, 1),
    'lqr_6_2': _lqr(6, 2),
    'point_mass': dict(
        xml=lambda mod: mod.make_model(),
        load=dict(domain='point_mass', task='easy'),
        tasks=[('easy', lambda mod, m: (
            mod.PointMass(m, randomize_gains=False) if mod is jpoint_mass
            else mod.PointMass(m)))]),
    'ball_in_cup': dict(
        xml=lambda mod: mod.make_model(),
        load=dict(domain='ball_in_cup', task='catch'),
        tasks=[('catch', lambda mod, m: mod.BallInCup(m))]),
    'fish': dict(
        xml=lambda mod: mod.make_model(),
        load=dict(domain='fish', task='upright'),
        tasks=[('upright', lambda mod, m: mod.Upright(m))]),
    'humanoid_CMU': dict(
        xml=lambda mod: mod.make_model(),
        load=dict(domain='humanoid_CMU', task='run'),
        tasks=[(name, lambda mod, m, s=speed: mod.HumanoidCMU(m, move_speed=s))
               for name, speed in (('stand', 0), ('walk', 1), ('run', 10))]),
}
JAX_MODULES = {'lqr_2_1': jlqr, 'lqr_6_2': jlqr, 'point_mass': jpoint_mass,
               'ball_in_cup': jball_in_cup, 'fish': jfish,
               'humanoid_CMU': jhumanoid_CMU}
PORT_MODULES = {'lqr_2_1': tlqr, 'lqr_6_2': tlqr, 'point_mass': tpoint_mass,
                'ball_in_cup': tball_in_cup, 'fish': tfish,
                'humanoid_CMU': thumanoid_CMU}
# (nv, contact slots, constraint rows) of each model
SIZES = {'lqr_2_1': (2, 4, 16), 'lqr_6_2': (6, 22, 88),
         'point_mass': (2, 0, 2), 'ball_in_cup': (4, 16, 65),
         'fish': (13, 36, 144), 'humanoid_CMU': (62, 16, 120)}


@functools.lru_cache(maxsize=None)
def _jax_model(name):
  with jax.enable_x64(True):
    return jmodels.from_xml_string(MODELS[name]['xml'](JAX_MODULES[name]),
                                   assets=jcommon.ASSETS, dtype=jnp.float64)


@functools.lru_cache(maxsize=None)
def _torch_env(name):
  load = dict(MODELS[name]['load'])
  return suite.load(load.pop('domain'), load.pop('task'), device='cpu',
                    dtype=torch.float64, **load)


# ---------------------------------------------------------------------------
# the model builds


@pytest.mark.parametrize('name', list(MODELS))
def test_model_matches_jax_build(name):
  """The port's XML (lqr's procedural chain from the same seed among
  them) is the reference's string, and its build matches the JAX build:
  static fields exactly, parameters to 1e-12."""
  assert MODELS[name]['xml'](PORT_MODULES[name]) == MODELS[name]['xml'](
      JAX_MODULES[name])
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
  assert (tm.nv, tm.ncon_sel, tm.nefc_max) == SIZES[name]


def test_lqr_model_string_follows_its_seed():
  """One seed gives one string on both sides; another seed another."""
  for n, k in ((2, 1), (6, 2)):
    for seed in (0, 1):
      want = jlqr.make_model(n, k, np.random.RandomState(seed))
      assert tlqr.make_model(n, k, np.random.RandomState(seed)) == want
    assert tlqr.make_model(n, k, np.random.RandomState(0)) != \
        tlqr.make_model(n, k, np.random.RandomState(1))


# ---------------------------------------------------------------------------
# start states


def _live_rows(tm, qpos):
  d = tforward.fwd_position(tm, ttypes.make_data(tm, qpos.shape[0]).replace(
      qpos=torch.as_tensor(qpos)))
  rows = tconstraint.make_rows(tm, d)
  return np_(rows.slot_active > 0), np_(d.contact.active)


def _pick(ok, what):
  pick = np.nonzero(ok)[0][:B]
  assert len(pick) == B, f'fewer than {B} candidates with {what}'
  return pick


def _start_qpos(name, m, tm, rng):
  """B poses of one model. lqr: normal draws (no constraints); fish:
  random orientations and fin angles (its constraints are disabled);
  point_mass: envs 2 and 3 past a slider limit; ball_in_cup: two envs
  with the ball touching the cup, two with the string at its length
  limit; humanoid_CMU: random orientations, hinges in range but three
  past a limit, the root at a height where the body touches the floor,
  keeping at most JAX_ROW_BUDGET live rows."""
  n = 256
  qpos = np.tile(np.asarray(m.qpos0), (n, 1))
  if name.startswith('lqr'):
    return rng.normal(0.0, 1.0, (B, m.nq))
  if name == 'point_mass':
    qpos = rng.uniform(-0.28, 0.28, (B, m.nq))
    qpos[2, 0], qpos[3, 1] = 0.31, -0.32
    return qpos
  if name == 'fish':
    quat = rng.normal(size=(B, 4))
    qpos = np.tile(np.asarray(m.qpos0), (B, 1))
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, 7:] = rng.uniform(-0.2, 0.2, (B, m.nq - 7))
    return qpos
  if name == 'ball_in_cup':
    qpos[:, :2] = rng.uniform(-0.2, 0.2, (n, 2))
    qpos[:, 2] = qpos[:, 0] + rng.uniform(-0.4, 0.4, n)
    qpos[:, 3] = qpos[:, 1] + rng.uniform(-0.6, 0.4, n)
    live, contact = _live_rows(tm, qpos)
    touch = _pick(contact.any(axis=1), 'a contact')[:2]
    string = _pick(live[:, 0], 'the string at its limit')[:2]
    return qpos[np.concatenate([touch, string])]
  # humanoid_CMU
  quat = rng.normal(size=(n, 4))
  qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
  qpos[:, 2] = rng.uniform(0.1, 1.0, n)
  rng_ = np.asarray(m.jnt_range)
  hinges = [j for j in range(m.njnt) if m.jnt_limited[j]]
  for j in hinges:
    qpos[:, m.jnt_qposadr[j]] = rng.uniform(*rng_[j], n)
  for i in range(n):
    for j in rng.choice(hinges, 3, replace=False):
      qpos[i, m.jnt_qposadr[j]] = rng_[j, 1] + rng.uniform(0.005, 0.03)
  live, contact = _live_rows(tm, qpos)
  nlive = live.sum(axis=1)
  return qpos[_pick((contact.sum(axis=1) >= 2) & (nlive <= JAX_ROW_BUDGET),
                    'floor contacts and few live rows')]


def _start_state(name, m, tm):
  rng = np.random.default_rng(list(MODELS).index(name))
  qpos = _start_qpos(name, m, tm, rng)
  # the fish's fluid forces grow with the square of its velocities and act
  # on links of a few grams: explicit steps diverge from 0.5 rad/s
  speed = 0.05 if name == 'fish' else 0.5
  return {'time': np.zeros(B), 'qpos': qpos,
          'qvel': rng.normal(0.0, speed, (B, m.nv)),
          'act': np.zeros((B, m.na)),
          'ctrl': rng.uniform(-1.0, 1.0, (B, m.nu)),
          'qacc': np.zeros((B, m.nv)),
          'qacc_warmstart': rng.normal(0.0, 1.0, (B, m.nv)),
          'sensordata': np.zeros((B, m.nsensordata))}


# ---------------------------------------------------------------------------
# a substep and a control step of each model


def _jax_substep(m, jtasks, termination):
  """The one jitted JAX function of a model: a batched substep on a slim
  state with every stage's fields, the first task's observation and
  every task's reward (and its termination, where the task has one) on
  its position/velocity state, and the next slim state."""
  vm = lambda f: jax.vmap(lambda d: f(m, d))

  def substep(state):
    D = jax.vmap(lambda s: jforward.inflate(m, s))(state)
    D = vm(lambda mm, d: jforward.fwd_position(mm, d, factor=False))(D)
    out = {'pos.' + k: getattr(D, k) for k in POS_FIELDS}
    out.update({'contact.' + k: getattr(D.contact, k)
                for k in CONTACT_FIELDS})
    D = vm(jforward.fwd_velocity)(D)
    D = vm(lambda mm, d: jsensor.sensors(mm, d, stages='pv'))(D)
    out['obs'] = jax.vmap(lambda d: jtasks[0].get_observation(m, d))(D)
    out['reward'] = [jax.vmap(lambda d, t=t: t.get_reward(m, d))(D)
                     for t in jtasks]
    if termination:
      out['termination'] = jax.vmap(
          lambda d: jtasks[0].get_termination(m, d))(D)
    D = vm(jforward.fwd_actuation)(D)
    D = jforward.fwd_acceleration_batched(m, D)
    out.update({'vel.' + k: getattr(D, k)
                for k in ('qfrc_bias', 'qfrc_passive', 'actuator_velocity',
                          'actuator_force', 'qfrc_actuator', 'qacc_smooth',
                          'ten_length', 'ten_velocity')})
    rows = vm(jconstraint.make_rows)(D)
    out.update({'rows.' + k: getattr(rows, k) for k in ROW_FIELDS})
    D = jconstraint.fwd_constraint_batched(m, D)
    out.update({'solve.' + k: getattr(D, k) for k in SOLVE_FIELDS})
    out['solve.contact_force'] = D.contact.force
    D = vm(lambda mm, d: jsensor.sensors(mm, d, stages='acc'))(D)
    out['sensordata'] = D.sensordata
    out['next'] = jforward.slim_state(jforward._euler_batched(m, D))
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
                        'actuator_force', 'qfrc_actuator', 'qacc_smooth',
                        'ten_length', 'ten_velocity')})
  rows = tconstraint.make_rows(tm, d)
  out.update({'rows.' + k: getattr(rows, k) for k in ROW_FIELDS})
  d = tconstraint.fwd_constraint_batched(tm, d)
  out.update({'solve.' + k: getattr(d, k) for k in SOLVE_FIELDS})
  out['solve.contact_force'] = d.contact.force
  d = tsensor.sensors(tm, d, stages='acc')
  out['sensordata'] = d.sensordata
  d = tforward._euler_batched(tm, d)
  out.update({'next.' + k: getattr(d, k) for k in ('qpos', 'qvel')})
  return {k: np_(v) for k, v in out.items()}


# the models held through a jitted JAX substep: one a domain
STEPPED = [name for name in MODELS if name != 'lqr_2_1']


@pytest.fixture(scope='module', params=STEPPED)
def model_case(request):
  """(name, JAX model, port env, start state, the JAX first substep, the
  JAX state after a control step, the JAX outputs on that state)."""
  name = request.param
  m = _jax_model(name)
  env = _torch_env(name)
  assert int(m.opt.integrator) == constants.IntegratorType.EULER
  start = _start_state(name, m, env.model)
  jtasks = [make(JAX_MODULES[name], m) for _, make in MODELS[name]['tasks']]
  with jax.enable_x64(True):
    substep = jax.jit(_jax_substep(m, jtasks, name.startswith('lqr')))
    first = jax.tree.map(np.asarray, substep(start))
    state = first['next']
    for _ in range(env.n_sub_steps - 1):
      state = jax.tree.map(np.asarray, substep(state)['next'])
    last = jax.tree.map(np.asarray, substep(state))
  return name, m, env, start, first, state, last


def _compare(want, got, prefix, tol):
  keys = [k for k in want if k.startswith(prefix)]
  assert keys
  for k in keys:
    assert_close(got[k], want[k], tol, k)


def test_substep_and_control_step_match_jax(model_case):
  """One test item a domain, so that one worker compiles its JAX substep:

  - the first substep's stages: kinematics, collision, smooth dynamics
    and tendons at TOL_SMOOTH; the rows (limits, tendon limits, contacts)
    at TOL_SMOOTH; the solve, the contact forces, every sensor and the
    Euler update at TOL_SOLVE where a row is live (TOL_SMOOTH for lqr and
    fish, which disable their constraints);
  - one control step of BatchedEnvironment.step_core, then its
    observations and its task's reward and termination, and every task's
    observation and reward on the full forward of its end state.
  """
  name, m, env, start, first, state, last = model_case
  tm = env.model
  got = _port_substep(tm, start)
  live_row = first['rows.slot_active'] > 0
  assert (live_row.sum(axis=1) <= JAX_ROW_BUDGET).all()
  smooth = bool(m.opt.disableflags & constants.DisableBit.CONSTRAINT)
  tol = TOL_SMOOTH if smooth else TOL_SOLVE
  if not smooth:
    # every env has a live row; point_mass's first two sit inside range
    assert live_row.any(axis=1)[2:].all(), 'no live row in the inputs'
    assert (np_(tconstraint.fwd_constraint_batched(
        tm, tforward.fwd_aa_batched(tm, tforward.fwd_pv(tm, tforward.inflate(
            tm, {k: torch.as_tensor(v) for k, v in start.items()}))))
                .solver_niter) < tm.opt.solver_iterations).all(), \
        'the solver did not converge in every env'
  if name == 'humanoid_CMU':
    # the row layout: limits, then contacts
    assert first['contact.active'].sum(axis=1).min() >= 2
    limits = live_row[:, :tconstraint._num_noncontact_rows(tm)]
    assert limits.any(axis=1).all(), 'no violated limit'

  _compare(first, got, 'pos.', TOL_SMOOTH)
  _compare(first, got, 'vel.', TOL_SMOOTH)
  # slots and rows that do not act are held in what they mean, depth and
  # activity
  live_slot = first['contact.active']
  for k in CONTACT_FIELDS:
    want, have = first['contact.' + k], got['contact.' + k]
    if k not in ('dist', 'active'):
      want, have = want[live_slot], have[live_slot]
    assert_close(have, want, TOL_SMOOTH, 'contact.' + k)
  for k in ROW_FIELDS:
    want, have = first['rows.' + k], got['rows.' + k]
    if k == 'J':
      want, have = want.swapaxes(1, 2), have.swapaxes(1, 2)
    if k != 'slot_active':
      want, have = want[live_row], have[live_row]
    assert_close(have, want, TOL_SMOOTH, 'rows.' + k)
  _compare(first, got, 'solve.', tol)
  assert_close(got['sensordata'], first['sensordata'], tol, 'sensordata')
  for k in ('qpos', 'qvel'):
    assert_close(got['next.' + k], first['next'][k], tol, 'next.' + k)

  tasks = [make(PORT_MODULES[name], tm) for _, make in MODELS[name]['tasks']]
  benv = BatchedEnvironment(tm, tasks[0], batch_size=B,
                            n_sub_steps=env.n_sub_steps)
  s0 = {k: torch.as_tensor(np.array(v)) for k, v in start.items()}
  new_state, obs, reward, term, diverged = benv.step_core(s0, s0['ctrl'])
  assert not bool(diverged.any())
  for k in ('qpos', 'qvel'):
    assert_close(np_(new_state[k]), state[k], tol, k)
  assert list(obs) == list(last['obs'])
  for k, v in obs.items():
    assert_close(np_(v), last['obs'][k], tol, f'step_core obs.{k}')
  assert_close(np_(reward), last['reward'][0], tol, 'step_core reward')
  if 'termination' in last:
    assert (np_(term) == last['termination']).all()
  d = tforward.forward(tm, tforward.inflate(tm, new_state))
  for (task_name, _), task, want in zip(MODELS[name]['tasks'], tasks,
                                        last['reward']):
    for k, v in task.get_observation(tm, d).items():
      assert_close(np_(v), last['obs'][k], tol, f'{task_name} obs.{k}')
    assert_close(np_(task.get_reward(tm, d)), want, tol,
                 f'{task_name} reward')


# ---------------------------------------------------------------------------
# the task factories and initializers

TASKS = [('humanoid_CMU', 'stand'), ('humanoid_CMU', 'walk'),
         ('humanoid_CMU', 'run'), ('ball_in_cup', 'catch'),
         ('point_mass', 'easy'), ('fish', 'upright'), ('lqr', 'lqr_2_1'),
         ('lqr', 'lqr_6_2')]


@pytest.mark.parametrize('domain,task', TASKS,
                         ids=[f'{d}-{t}' for d, t in TASKS])
def test_task_loads_initializes_and_steps(domain, task):
  """suite.load builds the task on the CPU (its factory defaults to the
  card), its initializer draws in range (ball_in_cup and humanoid_CMU:
  contact-free, but for envs still touching after 64 rounds), and one
  control step from the initial state gives finite outputs and rewards
  in range. humanoid_CMU's three tasks share one initializer, held on
  run; stand and walk step from qpos0."""
  module = {'humanoid_CMU': thumanoid_CMU, 'ball_in_cup': tball_in_cup,
            'point_mass': tpoint_mass, 'fish': tfish, 'lqr': tlqr}[domain]
  factory = getattr(module, task)
  assert inspect.signature(factory).parameters['device'].default == 'cuda'
  kwargs = dict(random=LQR_SEED) if domain == 'lqr' else {}
  env = suite.load(domain, task, device='cpu', dtype=torch.float64, **kwargs)
  tm, n = env.model, 8
  data = ttypes.make_data(tm, n)
  if domain != 'humanoid_CMU' or task == 'run':
    data = env.task.initialize_episode(tm, data,
                                       torch.Generator().manual_seed(0))
  q, q0 = np_(data.qpos), np_(tm.qpos0)
  d = tforward.forward(tm, data)
  touching = np_(d.contact.active.any(dim=-1))
  if domain == 'lqr':
    assert np.allclose(np.linalg.norm(q, axis=1), math.sqrt(2.0))
  elif domain == 'point_mass':
    assert (np.abs(q) <= 0.3).all() and q.std() > 0.05
  elif domain == 'ball_in_cup':
    assert not touching.any()
    assert (np.abs(q[:, 2]) <= 0.2).all() and (q[:, 3] >= 0.2).all()
    assert (q[:, 3] <= 0.5).all() and (q[:, :2] == 0).all()
  elif domain == 'fish':
    assert np.allclose(np.linalg.norm(q[:, 3:7], axis=1), 1.0)
    assert (np.abs(q[:, 7:]) <= 0.2).all() and (q[:, :3] == q0[:3]).all()
  elif task == 'run':
    rng = np_(tm.jnt_range)
    for j in range(tm.njnt):
      if tm.jnt_limited[j]:
        col = q[:, tm.jnt_qposadr[j]]
        assert ((col >= rng[j, 0]) & (col <= rng[j, 1])).all(), j
    assert np.allclose(np.linalg.norm(q[:, 3:7], axis=1), 1.0)
    assert touching.sum() <= n // 2
  benv = BatchedEnvironment(tm, env.task, batch_size=n,
                            n_sub_steps=env.n_sub_steps)
  _, obs, reward, _, diverged = benv.step_core(
      tforward.slim_state(d), torch.zeros(n, tm.nu, dtype=torch.float64))
  assert not bool(diverged.any())
  assert reward.shape == (n,) and torch.isfinite(reward).all()
  # lqr's reward is 1 less a quadratic cost, the others lie in [0, 1]
  assert (reward <= 1).all() and (domain == 'lqr' or (reward >= 0).all())
  for k, v in obs.items():
    assert v.shape[0] == n and torch.isfinite(v).all(), k


@pytest.mark.parametrize('domain,task', [('point_mass', 'hard'),
                                         ('fish', 'swim')])
def test_model_randomizing_tasks_are_not_registered(domain, task):
  """point_mass.hard and fish.swim change the model each episode:
  suite.load serves them, and two envs of one batch draw different
  leaves (`tests/test_torch_randomize.py` holds them against the JAX
  package)."""
  env = suite.load(domain, task, device='cpu')
  benv = BatchedEnvironment(env.model, env.task, batch_size=2,
                            n_sub_steps=env.n_sub_steps)
  benv.reset()
  (leaf,) = benv.leaves.values()
  assert leaf.shape[0] == 2 and not torch.equal(leaf[0], leaf[1])


# ---------------------------------------------------------------------------
# acceleration-stage sensors against MuJoCo


def _oracle_start(domain, tm, rng):
  """B states with contacts: hopper standing with its foot 0.002-0.01
  into the floor; quadruped fetch at qpos0 (legs straight down) with its
  toes 0.002-0.01 into the floor and the ball in the air beside it."""
  qpos = np.tile(np_(tm.qpos0), (B, 1))
  d = tforward.fwd_position(tm, ttypes.make_data(tm, 1))
  if domain == 'hopper':
    foot = tm.names.name2id('geom', 'foot')
    low = float(d.geom_xpos[0, foot, 2] - tm.geom_size[foot, 0])
    rootz = tm.jnt_qposadr[tm.names.name2id('joint', 'rootz')]
    qpos[:, rootz] -= low + rng.uniform(0.002, 0.01, B)
  else:
    toes = [tm.names.name2id('geom', f'toe_{a}_{b}')
            for a in ('front', 'back') for b in ('left', 'right')]
    low = float((d.geom_xpos[0, toes, 2] - tm.geom_size[toes, 0]).min())
    qpos[:, 2] -= low + rng.uniform(0.002, 0.01, B)
    ball = tm.jnt_qposadr[tm.names.name2id('joint', 'ball_root')]
    qpos[:, ball:ball + 3] = [1.5, 1.5, 1.0]
  return {'time': np.zeros(B), 'qpos': qpos,
          'qvel': rng.normal(0.0, 0.1, (B, tm.nv)),
          'act': rng.uniform(-1.0, 1.0, (B, tm.na)),
          'ctrl': rng.uniform(-1.0, 1.0, (B, tm.nu)),
          'qacc': np.zeros((B, tm.nv)),
          'qacc_warmstart': np.zeros((B, tm.nv)),
          'sensordata': np.zeros((B, tm.nsensordata))}


# the observations that read acceleration-stage sensors, (key, columns)
ORACLE_CASES = {
    'hopper': ('hop', thopper.make_model, [('touch', slice(None))]),
    'quadruped_fetch': ('fetch',
                        lambda: tquadruped.make_model(walls_and_ball=True),
                        [('imu', slice(0, 3)), ('force_torque',
                                                slice(None))]),
}
# MuJoCo's Newton solver and the port's stop at the same tolerance on
# different iterates: the observations agree to about the solve's
# precision, far inside rtol; atol covers zero touch values (no contact
# in the site's zone)
ORACLE_RTOL = 1e-4
ORACLE_ATOL = 1e-8


@pytest.mark.parametrize('case', list(ORACLE_CASES))
def test_acc_stage_observations_match_mujoco(case):
  """One control step of BatchedEnvironment.step_core from states with
  contacts, against MuJoCo 3.10 (`mj_forward`, then n_sub_steps of
  `mj_step2` and `mj_step1`, as dm_control's `Physics.step` runs them):
  hopper's `touch`, and quadruped fetch's accelerometer half of `imu` and
  its `force_torque`, which come from the last substep's constraint
  solve; qpos and qvel too. The expected observations are the port
  task's own, applied to MuJoCo's sensordata."""
  import mujoco  # the oracle; a lane without it fails here, not skips
  task_name, make_xml, keys = ORACLE_CASES[case]
  domain = case.split('_')[0]
  env = suite.load(domain, task_name, device='cpu', dtype=torch.float64)
  tm = env.model
  start = _oracle_start(domain, tm, np.random.default_rng(2))
  benv = BatchedEnvironment(tm, env.task, batch_size=B,
                            n_sub_steps=env.n_sub_steps)
  s0 = {k: torch.as_tensor(v) for k, v in start.items()}
  contacts = tforward.fwd_position(tm, tforward.inflate(tm, s0)).contact
  assert (contacts.active.sum(dim=-1) >= 1).all()
  new_state, obs, _, _, _ = benv.step_core(s0, s0['ctrl'])

  assets = {k: v for k, v in tcommon.read_assets().items()
            if k.startswith('./')}
  mm = mujoco.MjModel.from_xml_string(make_xml(), assets)
  sensordata, qpos, qvel = [], [], []
  for b in range(B):
    md = mujoco.MjData(mm)
    md.qpos[:], md.qvel[:] = start['qpos'][b], start['qvel'][b]
    md.act[:], md.ctrl[:] = start['act'][b], start['ctrl'][b]
    mujoco.mj_forward(mm, md)
    for _ in range(env.n_sub_steps):
      mujoco.mj_step2(mm, md)
      mujoco.mj_step1(mm, md)
    sensordata.append(md.sensordata.copy())
    qpos.append(md.qpos.copy())
    qvel.append(md.qvel.copy())
  d = tforward.fwd_pv(tm, tforward.inflate(tm, new_state))
  want = env.task.get_observation(tm, d.replace(
      sensordata=torch.as_tensor(np.array(sensordata))))
  np.testing.assert_allclose(np_(new_state['qpos']), np.array(qpos),
                             rtol=ORACLE_RTOL, atol=ORACLE_ATOL)
  np.testing.assert_allclose(np_(new_state['qvel']), np.array(qvel),
                             rtol=ORACLE_RTOL, atol=ORACLE_ATOL)
  for k, cols in keys:
    w = np_(want[k])[:, cols]
    assert (np.abs(w) > 0.1).any(axis=1).all(), f'{k}: no signal to hold'
    np.testing.assert_allclose(np_(obs[k])[:, cols], w, rtol=ORACLE_RTOL,
                               atol=ORACLE_ATOL, err_msg=k)


@pytest.mark.parametrize('case', list(ORACLE_CASES))
def test_acc_stage_observations_are_fresh(case):
  """No oracle: from the contact states above, whose sensordata is a full
  forward's (as a reset leaves it), one control step gives the
  acceleration-stage observations a value in every env that differs from
  the start state's. Stale sensors would keep the start's."""
  task_name, _, keys = ORACLE_CASES[case]
  domain = case.split('_')[0]
  env = suite.load(domain, task_name, device='cpu', dtype=torch.float64)
  tm = env.model
  start = _oracle_start(domain, tm, np.random.default_rng(2))
  d0 = tforward.forward(tm, tforward.inflate(
      tm, {k: torch.as_tensor(v) for k, v in start.items()}))
  s0 = tforward.slim_state(d0)
  obs0 = env.task.get_observation(tm, d0)
  benv = BatchedEnvironment(tm, env.task, batch_size=B,
                            n_sub_steps=env.n_sub_steps)
  _, obs, _, _, _ = benv.step_core(s0, s0['ctrl'])
  for k, cols in keys:
    new, old = np_(obs[k])[:, cols], np_(obs0[k])[:, cols]
    assert np.isfinite(new).all(), k
    assert (np.abs(new) > 0.1).any(axis=1).all(), f'{k}: no signal'
    assert (np.abs(new - old) > 1e-6).any(axis=1).all(), f'{k}: stale'


# ---------------------------------------------------------------------------
# models without degrees of freedom

_DOFLESS_XML = """
<mujoco>
  <worldbody>
    <geom type="plane" size="1 1 .1"/>
    <body pos="0 0 .5">
      <geom type="sphere" size=".1"/>
    </body>
  </worldbody>
</mujoco>
"""


@pytest.mark.parametrize('source', ['sphere', 'lqr.xml'])
def test_dofless_model_builds_and_steps(source):
  """A plane and a jointless sphere body, and the raw lqr.xml (before its
  chain is added), build with nv = 0 on the CPU; forward and one batched
  step run finite. Their empty index fields (dof_bodyid among them) stay
  integer tensors."""
  xml = (_DOFLESS_XML if source == 'sphere'
         else tcommon.read_model('lqr.xml'))
  tm = tmodels.from_xml_string(xml, assets=tcommon.read_assets(),
                               device='cpu', dtype=torch.float64)
  assert tm.nv == 0 and tm.index('dof_bodyid').dtype == torch.int64
  d = tforward.forward(tm, ttypes.make_data(tm, 2))
  d = tforward.step_batched(tm, d)
  for k in ('xpos', 'xmat', 'geom_xpos', 'subtree_com'):
    assert torch.isfinite(getattr(d, k)).all(), k
  assert d.qpos.shape == (2, 0) and not bool(d.divergence.any())
  assert torch.allclose(d.time, torch.full((2,), float(tm.opt.timestep),
                                           dtype=torch.float64))
