"""Parity of the PyTorch port's humanoid slice against the JAX package.

Both sides run in float64 on the CPU from the same numpy inputs. The JAX
side enables x64 only inside a scoped context and reaches its SPD solve
through `linalg.solve_psd` (its CPU path). To keep the lane cheap, the
JAX side compiles two functions only: the task's initializer and one
batched substep, which the control step then calls repeatedly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dm_control_tpu import models as jmodels
from dm_control_tpu.models import types as jtypes
from dm_control_tpu.ops import constraint as jconstraint
from dm_control_tpu.ops import forward as jforward
from dm_control_tpu.ops import sensor as jsensor
from dm_control_tpu.suite import common as jcommon
from dm_control_tpu.suite import humanoid as jhumanoid

from dm_control_tpu_torch import models as tmodels
from dm_control_tpu_torch.ops import constraint as tconstraint
from dm_control_tpu_torch.ops import forward as tforward
from dm_control_tpu_torch.ops import sensor as tsensor
from dm_control_tpu_torch.parallel import BatchedEnvironment
from dm_control_tpu_torch.suite import humanoid as thumanoid

# One intra-op thread: the batches here are tiny, and pytest-xdist workers
# share the host's cores, where a thread pool per worker only contends.
torch.set_num_threads(1)

# smooth stages and collision are the same closed-form arithmetic on both
# sides: agreement to rounding, well inside 1e-10
TOL_SMOOTH = 1e-10
# the Newton solver stops at the model tolerance (1e-8 of the mean mass
# diagonal), so its solution agrees to about the solver tolerance
TOL_SOLVE = 1e-6

POS_FIELDS = ('xpos', 'xquat', 'xmat', 'xipos', 'ximat', 'xanchor', 'xaxis',
              'geom_xpos', 'geom_xmat', 'site_xpos', 'site_xmat',
              'subtree_com', 'cinert', 'cdof', 'qM', 'actuator_length',
              'actuator_moment')
VEL_FIELDS = ('cvel', 'cdof_dot', 'qfrc_bias', 'qfrc_passive',
              'actuator_velocity', 'actuator_force', 'qfrc_actuator',
              'qfrc_smooth', 'qacc_smooth')
CONTACT_FIELDS = ('dist', 'pos', 'frame', 'includemargin', 'friction',
                  'solref', 'solimp', 'active', 'geom1', 'geom2', 'gap')
ROW_FIELDS = ('J', 'pos', 'margin', 'solref', 'solimp', 'invweight',
              'slot_active')
SOLVE_FIELDS = ('qacc', 'qfrc_constraint', 'efc_force')


def jax_model_to_numpy(mj):
  """(arrays, meta) of a JAX Model, as model_from_numpy takes them."""
  arrays, meta = {}, {}
  for f in dataclasses.fields(mj):
    v = getattr(mj, f.name)
    if f.name == 'opt':
      arrays['opt'] = {g.name: np.asarray(getattr(v, g.name))
                       for g in dataclasses.fields(v)
                       if g.metadata.get('pytree_node', True)}
      meta['opt'] = {g.name: getattr(v, g.name)
                     for g in dataclasses.fields(v)
                     if not g.metadata.get('pytree_node', True)}
    elif f.metadata.get('pytree_node', True):
      arrays[f.name] = np.asarray(v)
    else:
      meta[f.name] = v
  return arrays, meta


def assert_close(actual, expected, tol, name):
  actual = np.asarray(actual, dtype=np.float64)
  expected = np.asarray(expected, dtype=np.float64)
  assert actual.shape == expected.shape, (name, actual.shape, expected.shape)
  err = np.abs(actual - expected)
  bound = tol * np.maximum(1.0, np.abs(expected))
  worst = np.unravel_index(np.argmax(err - bound), err.shape) if err.size \
      else None
  assert np.all(err <= bound), (
      f'{name}: max |err| {err.max():.3e} at {worst} '
      f'(got {actual[worst]}, want {expected[worst]}), tol {tol}')


def np_(t):
  return t.detach().cpu().numpy()


@pytest.fixture(scope='module')
def jax_model():
  with jax.enable_x64(True):
    return jmodels.from_xml_string(jhumanoid.make_model(),
                                   assets=jcommon.ASSETS, dtype=jnp.float64)


@pytest.fixture(scope='module')
def torch_model(jax_model):
  """The port's model, handed the JAX model's leaves through the bridge."""
  arrays, meta = jax_model_to_numpy(jax_model)
  return tmodels.model_from_numpy(arrays, meta, dtype=torch.float64)


N_CONTACT = 3   # contact-rich envs
N_RESET = 2     # envs started from the JAX reset state
N_SUB = 5       # humanoid.run substeps per control step


@pytest.fixture(scope='module')
def inputs(jax_model):
  """Random poses near the floor with random velocities and controls
  (floor contacts, self contacts and violated joint limits), seeds for
  the reset envs, and the actions of the control step."""
  m = jax_model
  rng = np.random.default_rng(7)
  B = N_CONTACT
  qpos = np.tile(np.asarray(m.qpos0), (B, 1))
  qpos[:, 2] = rng.uniform(0.0, 0.12, B)
  quat = rng.normal(size=(B, 4))
  qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
  rng_lo = np.asarray(m.jnt_range)[1:, 0]
  rng_hi = np.asarray(m.jnt_range)[1:, 1]
  span = rng_hi - rng_lo
  qpos[:, 7:] = rng.uniform(rng_lo - 0.1 * span, rng_hi + 0.1 * span,
                            (B, m.nq - 7))
  return dict(qpos=qpos, qvel=rng.normal(0.0, 1.0, (B, m.nv)),
              ctrl=rng.uniform(-1.2, 1.2, (B, m.nu)),
              qacc_warmstart=rng.normal(0.0, 1.0, (B, m.nv)),
              seeds=rng.integers(0, 2**31, N_RESET, dtype=np.uint32),
              actions=rng.uniform(-1.0, 1.0, (B + N_RESET, m.nu)))


def _slim(m, n, **fields):
  """A float64 slim state of n envs: zeros, then `fields`."""
  s = dict(time=np.zeros(n), qpos=np.zeros((n, m.nq)),
           qvel=np.zeros((n, m.nv)), act=np.zeros((n, m.na)),
           ctrl=np.zeros((n, m.nu)), qacc=np.zeros((n, m.nv)),
           qacc_warmstart=np.zeros((n, m.nv)),
           sensordata=np.zeros((n, m.nsensordata)))
  s.update(fields)
  return s


@pytest.fixture(scope='module')
def jax_dump(jax_model, inputs):
  """The JAX side, from two jitted functions over N_CONTACT + N_RESET envs.

  `init` is the task's rejection-sampling initializer. `substep` is one
  Euler substep of JAX's batched pipeline on a slim state, returning
  every stage's fields, the forward result before integration, the next
  slim state, and the observation and reward of its input state (its pv
  stage is the pv refresh of BatchedEnvironment's control step).

  - stage dump: `substep` on the contact-rich envs and on the reset envs
    (initializer poses, zero velocity, control and warmstart); for the
    reset envs its forward result is JAX BatchedEnvironment's reset
    state (initialize_episode, then forward with all sensors);
  - control step: from the contact-rich inputs and the reset states, the
    actions go into ctrl, then N_SUB calls of `substep`, then one more
    for the observation and reward. This is `_step_core`'s arithmetic;
    its substeps skip sensors, which changes only the acceleration-stage
    sensordata carried in the state, and that is not compared.
  """
  m = jax_model
  task = jhumanoid.Humanoid(m, move_speed=10, pure_state=False)
  vm = lambda f: jax.vmap(lambda d: f(m, d))

  def init(seeds):
    def one(seed):
      d = jtypes.make_data(m, dtype=jnp.float64)
      return task.initialize_episode(m, d, jax.random.PRNGKey(seed)).qpos
    return jax.vmap(one)(seeds)

  def substep(state):
    D = jax.vmap(lambda s: jforward.inflate(m, s))(state)
    D = vm(lambda mm, d: jforward.fwd_position(mm, d, factor=False))(D)
    out = {'pos.' + k: getattr(D, k) for k in POS_FIELDS}
    out.update({'contact.' + k: getattr(D.contact, k)
                for k in CONTACT_FIELDS})
    D = vm(jforward.fwd_velocity)(D)
    D = vm(lambda mm, d: jsensor.sensors(mm, d, stages='pv'))(D)
    out['obs'] = jax.vmap(lambda d: task.get_observation(m, d))(D)
    out['reward'] = jax.vmap(lambda d: task.get_reward(m, d))(D)
    D = vm(jforward.fwd_actuation)(D)
    D = jforward.fwd_acceleration_batched(m, D)
    out.update({'vel.' + k: getattr(D, k) for k in VEL_FIELDS})
    rows = vm(jconstraint.make_rows)(D)
    out.update({'rows.' + k: getattr(rows, k) for k in ROW_FIELDS})
    D = jconstraint.fwd_constraint_batched(m, D)
    out.update({'solve.' + k: getattr(D, k) for k in SOLVE_FIELDS})
    out['solve.contact_force'] = D.contact.force
    D = vm(lambda mm, d: jsensor.sensors(mm, d, stages='acc'))(D)
    out['sensordata'] = D.sensordata
    out['forward'] = jforward.slim_state(D)
    D = jforward._euler_batched(m, D)
    out.update({'euler.' + k: getattr(D, k) for k in ('qpos', 'qvel')})
    out['next'] = jforward.slim_state(D)
    return out

  n_c, n_r = N_CONTACT, N_RESET
  with jax.enable_x64(True):
    qpos_r = np.asarray(jax.jit(init)(inputs['seeds']))
    substep = jax.jit(substep)
    start = _slim(
        m, n_c + n_r, qpos=np.concatenate([inputs['qpos'], qpos_r]),
        qvel=np.concatenate([inputs['qvel'], np.zeros((n_r, m.nv))]),
        ctrl=np.concatenate([inputs['ctrl'], np.zeros((n_r, m.nu))]),
        qacc_warmstart=np.concatenate([inputs['qacc_warmstart'],
                                       np.zeros((n_r, m.nv))]))
    out = jax.tree.map(np.asarray, substep(start))
    # control step: contact-rich envs from their inputs, reset envs from
    # the reset state
    reset = {k: v[n_c:] for k, v in out['forward'].items()}
    state = {k: np.concatenate([start[k][:n_c], reset[k]]) for k in start}
    state['ctrl'] = inputs['actions']
    step_start = state
    for _ in range(N_SUB):
      state = jax.tree.map(np.asarray, substep(state)['next'])
    last = jax.tree.map(np.asarray, substep(state))
  out.update(start=start, reset=reset, step_start=step_start,
             step=dict(state=state, obs=last['obs'], reward=last['reward']))
  return out


@pytest.fixture(scope='module')
def torch_stages(torch_model, jax_dump):
  """The port's stages on the same envs as the JAX stage dump."""
  m = torch_model
  d = tforward.inflate(m, {k: torch.as_tensor(v)
                           for k, v in jax_dump['start'].items()})
  out = {}
  d = tforward.fwd_position(m, d)
  out.update({'pos.' + k: getattr(d, k) for k in POS_FIELDS})
  out.update({'contact.' + k: getattr(d.contact, k) for k in CONTACT_FIELDS})
  d = tforward.fwd_velocity(m, d)
  d = tsensor.sensors(m, d, stages='pv')
  d = tforward.fwd_actuation(m, d)
  d = tforward.fwd_acceleration_batched(m, d)
  out.update({'vel.' + k: getattr(d, k) for k in VEL_FIELDS})
  rows = tconstraint.make_rows(m, d)
  out.update({'rows.' + k: getattr(rows, k) for k in ROW_FIELDS})
  d = tconstraint.fwd_constraint_batched(m, d)
  out.update({'solve.' + k: getattr(d, k) for k in SOLVE_FIELDS})
  out['solve.contact_force'] = d.contact.force
  d = tsensor.sensors(m, d, stages='acc')
  out['sensordata'] = d.sensordata
  d = tforward._euler_batched(m, d)
  out.update({'euler.' + k: getattr(d, k) for k in ('qpos', 'qvel')})
  return {k: np_(v) for k, v in out.items()}


def _compare(jax_out, torch_out, prefix, tol):
  keys = [k for k in jax_out if k.startswith(prefix)]
  assert keys
  for k in keys:
    assert_close(torch_out[k], jax_out[k], tol, k)


def test_model_matches_jax_build(jax_model):
  """The port's own compiler, builder and calibrate against the JAX
  model: static fields exactly, parameters to 1e-12."""
  tm = tmodels.from_xml_string(thumanoid.make_model(),
                               assets=jcommon.ASSETS, dtype=torch.float64)
  arrays, meta = jax_model_to_numpy(jax_model)
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
  assert tm.nv == 27 and tm.ncon_max == 277 and tm.ncon_sel == 32


def check_smooth_stages(jax_model, torch_model, inputs, jax_dump,
                        torch_stages):
  """kinematics .. RNE, passive, actuation, smooth acceleration."""
  _compare(jax_dump, torch_stages, 'pos.', TOL_SMOOTH)
  _compare(jax_dump, torch_stages, 'vel.', TOL_SMOOTH)


def check_collision(jax_model, torch_model, inputs, jax_dump, torch_stages):
  """Slot activity, depth, position, frame and parameters."""
  active = jax_dump['contact.active']
  sel = np.asarray(jax_model.sel_condim)   # condim 1: self, 3: floor
  assert active[:, sel == 1].any() and active[:, sel == 3].any(), (
      'inputs should hold both self and floor contacts')
  _compare(jax_dump, torch_stages, 'contact.', TOL_SMOOTH)


def check_constraint(jax_model, torch_model, inputs, jax_dump,
                     torch_stages):
  """make_rows, then the Newton solve (qacc, forces)."""
  _compare(jax_dump, torch_stages, 'rows.', TOL_SMOOTH)
  assert jax_dump['rows.slot_active'].sum() > 0
  _compare(jax_dump, torch_stages, 'solve.', TOL_SOLVE)


def check_sensors_and_euler(jax_model, torch_model, inputs, jax_dump,
                            torch_stages):
  """All sensors after the solve, then the Euler update."""
  _compare(jax_dump, torch_stages, 'sensordata', TOL_SOLVE)
  _compare(jax_dump, torch_stages, 'euler.', TOL_SOLVE)


def check_reset_forward(jax_model, torch_model, inputs, jax_dump,
                        torch_stages):
  """The port's full forward (all sensors) on the JAX initializer's poses
  gives the JAX reset state."""
  ref = jax_dump['reset']
  d = tmodels.data_from_numpy(torch_model, {'qpos': ref['qpos']})
  d = tforward.forward(torch_model, d)
  assert not bool(d.contact.active.any())
  assert_close(np_(d.qacc), ref['qacc'], TOL_SOLVE, 'qacc')
  assert_close(np_(d.sensordata), ref['sensordata'], TOL_SOLVE, 'sensordata')


def check_control_step(jax_model, torch_model, inputs, jax_dump,
                       torch_stages):
  """One control step (N_SUB substeps, pv refresh, observation, reward)
  of BatchedEnvironment.step_core from the contact-rich inputs and the
  JAX reset states, through the bridge."""
  ref = jax_dump['step']
  task = thumanoid.Humanoid(torch_model, move_speed=10, pure_state=False)
  env = BatchedEnvironment(torch_model, task,
                           batch_size=N_CONTACT + N_RESET, n_sub_steps=N_SUB)
  state = {k: torch.as_tensor(np.array(v))
           for k, v in jax_dump['step_start'].items()}
  new_state, obs, reward, _, diverged = env.step_core(
      state, torch.as_tensor(inputs['actions']))
  assert not bool(diverged.any())
  for k in ('qpos', 'qvel'):
    assert_close(np_(new_state[k]), ref['state'][k], TOL_SOLVE, k)
  for k, v in ref['obs'].items():
    assert_close(np_(obs[k]), v, TOL_SOLVE, f'obs.{k}')
  assert_close(np_(reward), ref['reward'], TOL_SOLVE, 'reward')


CHECKS = (check_smooth_stages, check_collision, check_constraint,
          check_sensors_and_euler, check_reset_forward, check_control_step)


def test_slice_matches_jax(jax_model, torch_model, inputs, jax_dump,
                           torch_stages):
  """Every stage of a substep, the reset forward and one control step.

  One test item on purpose: under pytest-xdist every worker that runs a
  test of this dump compiles it, the costliest part of these tests, so
  the checks share one item. Each check reports on its own.
  """
  failures = []
  for check in CHECKS:
    try:
      check(jax_model, torch_model, inputs, jax_dump, torch_stages)
    except AssertionError as e:
      failures.append(f'{check.__name__}: {e}')
  assert not failures, '\n'.join(failures)
