"""Parity of the port's RK4, energy and six suite domains (cartpole,
acrobot, pendulum, cheetah, walker, hopper) against the JAX package.

Both sides run in float64 on the CPU from the same numpy state; the JAX
side enables x64 only inside a scoped context. The random draws of the
two initializers differ (JAX keys against torch generators), so the
parity checks inject one state into both, and the port's initializers
are checked for range and distribution only. To keep the lane cheap the
JAX side compiles one function a domain (one physics substep that also
returns the observation, rewards and energy of its input state) and one
more for cheetah's settle.
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
from dm_control_tpu.models import types as jtypes
from dm_control_tpu.ops import forward as jforward
from dm_control_tpu.suite import acrobot as jacrobot
from dm_control_tpu.suite import cartpole as jcartpole
from dm_control_tpu.suite import cheetah as jcheetah
from dm_control_tpu.suite import common as jcommon
from dm_control_tpu.suite import hopper as jhopper
from dm_control_tpu.suite import pendulum as jpendulum
from dm_control_tpu.suite import walker as jwalker

from dm_control_tpu_torch import suite
from dm_control_tpu_torch.models import constants
from dm_control_tpu_torch.models import types as ttypes
from dm_control_tpu_torch.ops import forward as tforward
from dm_control_tpu_torch.parallel import BatchedEnvironment
from dm_control_tpu_torch.suite import acrobot as tacrobot
from dm_control_tpu_torch.suite import base as tbase
from dm_control_tpu_torch.suite import cartpole as tcartpole
from dm_control_tpu_torch.suite import cheetah as tcheetah
from dm_control_tpu_torch.suite import hopper as thopper
from dm_control_tpu_torch.suite import pendulum as tpendulum
from dm_control_tpu_torch.suite import walker as twalker

from test_torch_slice import TOL_SMOOTH, TOL_SOLVE, assert_close, np_

# One intra-op thread: the batches here are tiny, and pytest-xdist workers
# share the host's cores, where a thread pool per worker only contends.
torch.set_num_threads(1)

B = 4
# observations that read acceleration-stage sensors, held against the
# MuJoCo oracle in test_torch_suite2.py
ACC_STAGE_OBS = {'hopper': ('touch',)}

# domain -> (JAX module, port module, the tasks of one model (name, JAX
# task, port task), substeps per control step)
DOMAINS = {
    'cartpole': (jcartpole, tcartpole, [
        ('swingup', lambda mod, m: mod.Balance(m, swing_up=True,
                                               sparse=False)),
        ('swingup_sparse', lambda mod, m: mod.Balance(m, swing_up=True,
                                                      sparse=True)),
    ], 1),
    'acrobot': (jacrobot, tacrobot, [
        ('swingup', lambda mod, m: mod.Balance(m, sparse=False)),
        ('swingup_sparse', lambda mod, m: mod.Balance(m, sparse=True)),
    ], 1),
    'pendulum': (jpendulum, tpendulum, [
        ('swingup', lambda mod, m: mod.SwingUp(m)),
    ], 1),
    'cheetah': (jcheetah, tcheetah, [
        ('run', lambda mod, m: mod.Cheetah(m)),
    ], 1),
    'walker': (jwalker, twalker, [
        ('stand', lambda mod, m: mod.PlanarWalker(m, move_speed=0)),
        ('walk', lambda mod, m: mod.PlanarWalker(m, move_speed=1)),
        ('run', lambda mod, m: mod.PlanarWalker(m, move_speed=8)),
    ], 10),
    'hopper': (jhopper, thopper, [
        ('stand', lambda mod, m: mod.Hopper(m, hopping=False)),
        ('hop', lambda mod, m: mod.Hopper(m, hopping=True)),
    ], 4),
}

ALL_TASKS = [(d, t) for d, ts in (
    ('cartpole', ('balance', 'balance_sparse', 'swingup', 'swingup_sparse',
                  'two_poles', 'three_poles')),
    ('acrobot', ('swingup', 'swingup_sparse')),
    ('pendulum', ('swingup',)),
    ('cheetah', ('run',)),
    ('walker', ('stand', 'walk', 'run')),
    ('hopper', ('stand', 'hop'))) for t in ts]

@functools.lru_cache(maxsize=None)
def _jax_model(domain):
  with jax.enable_x64(True):
    return jmodels.from_xml_string(DOMAINS[domain][0].make_model(),
                                   assets=jcommon.ASSETS, dtype=jnp.float64)


def _torch_env(domain):
  return suite.load(domain, DOMAINS[domain][2][0][0], device='cpu',
                    dtype=torch.float64)


def _start_state(domain, m, rng):
  """B envs of one domain: poses with live constraint rows (cartpole's
  slider past either end of its range in envs 2 and 3, cheetah's,
  walker's and hopper's bodies pushed into the floor), random velocities
  and actions."""
  nv = m.nv
  qpos = np.tile(np.asarray(m.qpos0), (B, 1))
  rng_ = np.asarray(m.jnt_range)
  for j in range(m.njnt):
    adr = m.jnt_qposadr[j]
    if m.jnt_limited[j]:
      lo, hi = rng_[j]
      qpos[:, adr] = rng.uniform(lo, hi, B)
    elif m.jnt_type[j] == constants.JointType.HINGE:
      qpos[:, adr] = rng.uniform(-math.pi, math.pi, B)
  if domain == 'cartpole':
    qpos[2:, 0] = [1.83, -1.81]
  if domain in ('cheetah', 'walker', 'hopper'):
    z = [m.jnt_qposadr[m.names.name2id('joint', 'rootz')]]
    qpos[:, z] = rng.uniform(-0.25, 0.0, (B, 1))
    y = m.jnt_qposadr[m.names.name2id('joint', 'rooty')]
    qpos[:, y] = rng.uniform(-0.3, 0.3, B)
  return {'time': np.zeros(B), 'qpos': qpos,
          'qvel': rng.normal(0.0, 1.0, (B, nv)),
          'act': np.zeros((B, m.na)),
          'ctrl': rng.uniform(-1.0, 1.0, (B, m.nu)),
          'qacc': np.zeros((B, nv)),
          'qacc_warmstart': rng.normal(0.0, 1.0, (B, nv)),
          'sensordata': np.zeros((B, m.nsensordata))}


def _jax_control_step(domain, m, start):
  """The JAX pipeline's control step from `start` (ctrl = the actions):
  n substeps of `step_batched`, then the position/velocity refresh with
  every task's observation and reward; plus the first substep's result
  and the energy of the start state."""
  jmod, _, tasks, n_sub = DOMAINS[domain]
  jtasks = [make(jmod, m) for _, make in tasks]

  def substep(state):
    D = jax.vmap(lambda s: jforward.inflate(m, s))(state)
    P = jax.vmap(lambda d: jforward.fwd_pv(m, d, factor=False))(D)
    out = {'obs': jax.vmap(lambda d: jtasks[0].get_observation(m, d))(P),
           'reward': [jax.vmap(lambda d, t=t: t.get_reward(m, d))(P)
                      for t in jtasks],
           'energy': jax.vmap(lambda d: jforward.energy(m, d).energy)(P)}
    # the rest of JAX step_batched (its forward pass is P's, whose
    # sensors do not feed the dynamics)
    D = jforward.fwd_aa_batched(m, P, compute_sensors=False)
    D = (jforward._rk4_batched
         if int(m.opt.integrator) == constants.IntegratorType.RK4
         else jforward._euler_batched)(m, D)
    out['next'] = jforward.slim_state(D)
    return out

  with jax.enable_x64(True):
    substep = jax.jit(substep)
    state = start
    first = None
    for _ in range(n_sub):
      out = jax.tree.map(np.asarray, substep(state))
      first = out if first is None else first
      state = out['next']
    last = jax.tree.map(np.asarray, substep(state))
  return dict(first=first, state=state, obs=last['obs'],
              reward=last['reward'], energy=last['energy'])


@pytest.fixture(scope='module', params=list(DOMAINS))
def domain_case(request):
  """(domain, JAX model, port env, start state, JAX control step)."""
  domain = request.param
  m = _jax_model(domain)
  start = _start_state(domain, m, np.random.default_rng(
      list(DOMAINS).index(domain)))
  return domain, m, _torch_env(domain), start, _jax_control_step(domain, m,
                                                                 start)


def test_control_step_matches_jax(domain_case):
  """One control step of BatchedEnvironment.step_core against the JAX
  pipeline from the same injected state: qpos, qvel, every observation
  and every task's reward; the first substep's step_batched result
  (qpos, qvel, and the forward qacc it keeps) and the energy of the
  start and end states.

  hopper's `touch` is not held here: the port reads it from the last
  substep's solve, as MuJoCo does, and the JAX batched path keeps the
  start state's; test_torch_suite2.py holds it against MuJoCo.

  Tolerances: TOL_SOLVE (1e-6, the Newton solver's stopping tolerance)
  where a constraint row is live; where none is (acrobot has no
  constraints, pendulum none that can be live, cartpole's slider away
  from its ends), the step is closed-form arithmetic on both sides and
  held at TOL_SMOOTH (1e-10). Energy is closed form: TOL_SMOOTH.
  """
  domain, m, env, start, ref = domain_case
  tm = env.model
  tasks = [make(DOMAINS[domain][1], tm) for _, make in DOMAINS[domain][2]]
  n_sub = DOMAINS[domain][3]
  assert env.n_sub_steps == n_sub
  benv = BatchedEnvironment(tm, tasks[0], batch_size=B, n_sub_steps=n_sub)
  state = {k: torch.as_tensor(np.array(v)) for k, v in start.items()}

  # the first substep alone: per env, the tolerance its live rows allow
  first = tforward.step_batched(tm, tforward.inflate(tm, state),
                                compute_sensors=False)
  if domain in ('acrobot', 'pendulum'):
    tol = np.full(B, TOL_SMOOTH)
  elif domain == 'cartpole':
    live = np.abs(start['qpos'][:, 0]) > 1.8
    assert live.tolist() == [False, False, True, True]
    tol = np.where(live, TOL_SOLVE, TOL_SMOOTH)
  else:
    tol = np.full(B, TOL_SOLVE)
    contacts = tforward.fwd_position(tm, tforward.inflate(tm, state))
    assert bool(contacts.contact.active.any()), 'no contact in the inputs'
  for k in ('qpos', 'qvel', 'qacc'):
    for b in range(B):
      assert_close(np_(getattr(first, k))[b], ref['first']['next'][k][b],
                   tol[b], f'first substep {k}[{b}]')

  # energy of the start state (gravity, and the joint springs of
  # cheetah), computed by the port on the same state; fwd_pv computes it
  # where the model enables it (cartpole, acrobot, pendulum)
  d = tforward.fwd_pv(tm, tforward.inflate(tm, state))
  assert_close(np_(tforward.energy(tm, d).energy), ref['first']['energy'],
               TOL_SMOOTH, 'energy (start)')
  if tm.opt.enableflags & constants.EnableBit.ENERGY:
    assert_close(np_(d.energy), ref['first']['energy'], TOL_SMOOTH,
                 'fwd_pv energy (start)')

  new_state, obs, reward, _, diverged = benv.step_core(
      state, state['ctrl'])
  assert not bool(diverged.any())
  step_tol = TOL_SMOOTH if domain in ('acrobot', 'pendulum') else TOL_SOLVE
  for k in ('qpos', 'qvel'):
    assert_close(np_(new_state[k]), ref['state'][k], step_tol, k)
  for k, v in ref['obs'].items():
    if k not in ACC_STAGE_OBS.get(domain, ()):
      assert_close(np_(obs[k]), v, step_tol, f'obs.{k}')
  assert_close(np_(reward), ref['reward'][0], step_tol, 'reward')
  d = tforward.fwd_pv(tm, tforward.inflate(tm, new_state))
  for (name, _), task, want in zip(DOMAINS[domain][2], tasks, ref['reward']):
    assert_close(np_(task.get_reward(tm, d)), want, step_tol,
                 f'reward {name}')
  assert_close(np_(tforward.energy(tm, d).energy), ref['energy'], step_tol,
               'energy (end)')


SETTLE_B = 2
# steps of the settle held one by one at TOL_SOLVE
SETTLE_STEPS_HELD = 3


def test_cheetah_settle_matches_jax():
  """Cheetah's initializer: the port's draw (limited joints in range,
  the rest at qpos0), then its 200 batched settling steps against the
  JAX initializer's 200 unbatched `forward.step` calls from the same
  drawn pose. The first steps agree at TOL_SOLVE, step by step."""
  m = _jax_model('cheetah')
  env = _torch_env('cheetah')
  tm = env.model
  qpos = tbase.random_limited_qpos_only_limited(
      tm, SETTLE_B, torch.Generator().manual_seed(11))
  # the draw: limited hinges uniform in range, the root at qpos0
  rng = tm.jnt_range.numpy()
  for j in range(tm.njnt):
    q = np_(qpos[:, tm.jnt_qposadr[j]])
    if tm.jnt_limited[j]:
      assert ((q >= rng[j, 0]) & (q <= rng[j, 1])).all()
    else:
      assert (q == np_(tm.qpos0)[tm.jnt_qposadr[j]]).all()

  def settle(q):
    d = jtypes.make_data(m, dtype=jnp.float64).replace(qpos=q)
    def body(d, _):
      d = jforward.step(m, d)
      return d, (d.qpos, d.qvel)
    d, traj = jax.lax.scan(body, d, None, length=tcheetah._SETTLE_STEPS)
    return d.time, traj

  with jax.enable_x64(True):
    settle = jax.jit(settle)   # one env a call: cheaper to trace than vmap
    ref_qpos, ref_qvel = (np.stack(r, axis=0) for r in zip(*(
        jax.tree.map(np.asarray, settle(q)[1]) for q in np_(qpos))))

  d = ttypes.make_data(tm, SETTLE_B).replace(qpos=qpos)
  for i in range(SETTLE_STEPS_HELD):
    d = tforward.step_batched(tm, d, compute_sensors=False)
    assert_close(np_(d.qpos), ref_qpos[:, i], TOL_SOLVE, f'qpos step {i}')
    assert_close(np_(d.qvel), ref_qvel[:, i], TOL_SOLVE, f'qvel step {i}')

  settled = env.task.initialize_episode(
      tm, ttypes.make_data(tm, SETTLE_B), torch.Generator().manual_seed(11))
  assert (np_(settled.time) == 0).all()
  assert_close(np_(settled.qpos), ref_qpos[:, -1], TOL_SOLVE, 'qpos')
  assert_close(np_(settled.qvel), ref_qvel[:, -1], TOL_SOLVE, 'qvel')


@pytest.mark.parametrize('domain,task', ALL_TASKS,
                         ids=[f'{d}-{t}' for d, t in ALL_TASKS])
def test_task_loads_initializes_and_steps(domain, task):
  """suite.load builds every task of the six domains on the CPU, its
  factory defaults to the card, its initializer draws in range, and one
  control step from the initial state gives finite outputs.

  Cheetah's initializer (200 settling steps) is held in
  test_cheetah_settle_matches_jax; here cheetah steps from qpos0."""
  factory = getattr(DOMAINS[domain][1], task)
  assert inspect.signature(factory).parameters['device'].default == 'cuda'
  env = suite.load(domain, task, device='cpu', dtype=torch.float64)
  tm, n = env.model, 8
  data = ttypes.make_data(tm, n)
  if domain != 'cheetah':
    data = env.task.initialize_episode(tm, data,
                                       torch.Generator().manual_seed(0))
  q = np_(data.qpos)
  rng = np_(tm.jnt_range)
  for j in range(tm.njnt):
    if tm.jnt_limited[j]:
      col = q[:, tm.jnt_qposadr[j]]
      assert ((col >= rng[j, 0]) & (col <= rng[j, 1])).all(), j
  if domain == 'cartpole':
    if 'swingup' in task or 'poles' in task:
      # the pole hangs down: pi, with a spread of 0.01
      assert np.abs(q[:, 1] - math.pi).max() < 0.06
    else:
      assert np.abs(q[:, 1:]).max() <= 0.034
  if domain in ('acrobot', 'pendulum'):
    assert (np.abs(q) <= math.pi).all() and q.std() > 0.3
  d = tforward.forward(tm, data)
  benv = BatchedEnvironment(tm, env.task, batch_size=n,
                            n_sub_steps=env.n_sub_steps)
  state, obs, reward, _, diverged = benv.step_core(
      tforward.slim_state(d), torch.zeros(n, tm.nu, dtype=torch.float64))
  assert not bool(diverged.any())
  assert reward.shape == (n,) and ((reward >= 0) & (reward <= 1)).all()
  for k, v in obs.items():
    assert v.shape[0] == n and torch.isfinite(v).all(), k
