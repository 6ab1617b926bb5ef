"""The port's twelfth slice: per-env body poses (`body_pos`, `body_quat`),
resets that collide against each env's drawn model, and the manipulator
(bring_ball, bring_peg, insert_ball, insert_peg) and stacker (stack_2,
stack_4) domains.

Both sides run in float64 on the CPU from the same numpy inputs; the JAX
side enables x64 only inside a scoped context. The JAX batched path never
draws a model, so each of the port's envs is held against the unbatched
JAX pipeline on `model.replace(body_pos=row b, body_quat=row b)`. Both
sides build with the default contact budget (16 slots a condim group;
every slot of these models is condim 3), and no model here has more than
160 constraint rows (56 at most), so the JAX solver keeps every row, as
the port does.

The lane budget: this file compiles three whole-model JAX programs, one a
task for bring_ball, bring_peg and insert_ball (`jax_env_fn`: one env's
position/velocity stage, observation, reward, acceleration stage and
Euler substep on its own body poses, run env by env);
tests/test_torch_boxes.py compiles insert_peg's and stack_2's, and holds
those two tasks with `check_control_steps` from here. stack_4 shares
stack_2's task code and box pairs and is held through its draws, its
reset and its steps on the port alone. The body-pose test reads the
kinematics of insert_ball's program.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dm_control_tpu import models as jmodels
from dm_control_tpu.ops import forward as jforward
from dm_control_tpu.suite import common as jcommon
from dm_control_tpu.suite import manipulator as jmanipulator
from dm_control_tpu.suite import stacker as jstacker

from dm_control_tpu_torch import suite
from dm_control_tpu_torch.models import constants
from dm_control_tpu_torch.models import types as ttypes
from dm_control_tpu_torch.ops import collision as tcollision
from dm_control_tpu_torch.ops import forward as tforward
from dm_control_tpu_torch.ops import smooth as tsmooth
from dm_control_tpu_torch.parallel import BatchedEnvironment
from dm_control_tpu_torch.suite import base as tbase
from dm_control_tpu_torch.suite import common as tcommon
from dm_control_tpu_torch.suite import manipulator as tmanipulator
from dm_control_tpu_torch.suite import stacker as tstacker

from test_torch_slice import TOL_SMOOTH, TOL_SOLVE, assert_close, np_

torch.set_num_threads(1)

_G = constants.GeomType
B_ENV = 4        # envs of each task's control steps
N_STEPS = 2      # control steps a task
# task: (domain, the JAX model's MJCF, the JAX task on a JAX model)
TASKS = {
    'bring_ball': ('manipulator', lambda: jmanipulator.make_model(False, False),
                   lambda m: jmanipulator.Bring(m, False, False, True)),
    'bring_peg': ('manipulator', lambda: jmanipulator.make_model(True, False),
                  lambda m: jmanipulator.Bring(m, True, False, True)),
    'insert_ball': ('manipulator', lambda: jmanipulator.make_model(False, True),
                    lambda m: jmanipulator.Bring(m, False, True, True)),
    'insert_peg': ('manipulator', lambda: jmanipulator.make_model(True, True),
                   lambda m: jmanipulator.Bring(m, True, True, True)),
    'stack_2': ('stacker', lambda: jstacker.make_model(2),
                lambda m: jstacker.Stack(m, 2, True)),
    'stack_4': ('stacker', lambda: jstacker.make_model(4),
                lambda m: jstacker.Stack(m, 4, True)),
}
POS_KEYS = ('xpos', 'xquat', 'xmat', 'xanchor', 'xaxis', 'geom_xpos',
            'geom_xmat', 'site_xpos', 'site_xmat')


@functools.lru_cache(maxsize=None)
def torch_env(task):
  return suite.load(TASKS[task][0], task, device='cpu', dtype=torch.float64)


@functools.lru_cache(maxsize=None)
def jax_model(task):
  with jax.enable_x64(True):
    return jmodels.from_xml_string(TASKS[task][1](), assets=jcommon.ASSETS,
                                   dtype=jnp.float64)


def jax_env_fn(task):
  """One env's pipeline on its own model (its body_pos and body_quat
  rows): the frames of the position stage's kinematics, the observation
  and reward of the input state after the position/velocity stage, then
  the acceleration stage with its sensors (touch), and the state after
  one Euler substep. Jitted for one env (tracing the vmapped pipeline
  takes twice as long); `jax_envs` runs it env by env. Not cached: the
  test that builds it drops it when it ends, and with it the XLA:CPU
  executables, whose memory mappings would otherwise stay in the test
  process and bring it nearer the operating system's limit on mappings,
  where XLA:CPU crashes (ROADMAP C.e)."""
  m = jax_model(task)
  jtask = TASKS[task][2](m)

  def one(body_pos, body_quat, s):
    mb = m.replace(body_pos=body_pos, body_quat=body_quat)
    d = jforward.fwd_pv(mb, jforward.inflate(mb, s))
    out = {k: getattr(d, k) for k in POS_KEYS}
    out.update(obs=jtask.get_observation(mb, d),
               reward=jtask.get_reward(mb, d))
    d = jforward.fwd_aa(mb, d)
    out['sensordata'] = d.sensordata
    out['next'] = jforward.slim_state(jforward._integrate(mb, d))
    return out

  with jax.enable_x64(True):
    return jax.jit(one)


def jax_envs(fn, body_pos, body_quat, state):
  """fn, a jax_env_fn, on each env b of numpy rows (B, ...), stacked."""
  outs = [fn(body_pos[b], body_quat[b], {k: v[b] for k, v in state.items()})
          for b in range(len(body_pos))]
  return jax.tree.map(lambda *v: np.stack([np.asarray(x) for x in v]),
                      *outs)


def state_of(tm, qpos, qvel, ctrl):
  b = qpos.shape[0]
  return {'time': np.zeros(b), 'qpos': qpos, 'qvel': qvel,
          'act': np.zeros((b, tm.na)), 'ctrl': ctrl,
          'qacc': np.zeros((b, tm.nv)), 'qacc_warmstart': np.zeros((b, tm.nv)),
          'sensordata': np.zeros((b, tm.nsensordata))}


def _rot_y(angle, x, z):
  """(x, z) of a vector turned by `angle` about y."""
  c, s = np.cos(angle), np.sin(angle)
  return c * x + s * z, -s * x + c * z


def _angle_y(quat):
  return 2 * np.arctan2(quat[..., 2], quat[..., 0])


def contact_qpos(task, tm, qpos, leaves, envs):
  """qpos with the prop (or the boxes) of `envs` placed in contact, a hair
  deep: the ball or the upright peg on the floor (bring), the ball in
  its env's drawn cup and the peg's blade on its env's drawn slot
  (insert), box0 flat on the floor and box1 turned on it (stacker)."""
  qpos = qpos.copy()
  adr = lambda name: tm.jnt_qposadr[tm.names.name2id('joint', name)]
  deep = .0005
  for b in envs:
    if task.startswith('stack'):
      qpos[b, [adr('box0_x'), adr('box0_z'), adr('box0_y')]] = (
          .15, .022 - deep, 0.0)
      tilt = .2
      reach = .022 * (np.cos(tilt) + np.sin(tilt))
      qpos[b, [adr('box1_x'), adr('box1_z'), adr('box1_y')]] = (
          .154, .044 - 2 * deep + reach, tilt)
      continue
    obj = 'peg' if task.endswith('peg') else 'ball'
    if task == 'bring_ball':
      pose = (-.2, .022 - deep, 0.3)
    elif task == 'bring_peg':
      pose = (-.2, .113 + .005 - deep, 0.0)
    else:
      body = tm.names.name2id('body', 'cup' if obj == 'ball' else 'slot')
      pos = np_(leaves['body_pos'])[b, body]
      angle = _angle_y(np_(leaves['body_quat'])[b, body])
      if obj == 'ball':
        # in the cup's V, on its two bottom capsules (slopes of
        # atan(.025 / .03) from the vertex at z -.04)
        lx, lz = 0.0, -.04 + (.022 + .008 - deep) / np.cos(
            np.arctan2(.025, .03))
      else:
        # the blade's end sphere on slot_0's top face
        lx, lz = -.0252, -.083 + .035 + .005 - deep + .113
      dx, dz = _rot_y(angle, lx, lz)
      pose = (pos[0] + dx, pos[2] + dz, angle)
    qpos[b, [adr(f'{obj}_x'), adr(f'{obj}_z'), adr(f'{obj}_y')]] = pose
  return qpos


def hand_qpos(task, benv, qpos, b):
  """qpos with env b's prop (stacker: box1) in the hand: turned as the
  hand (the reset's in-hand placement), at the offset from the grasp
  site, on a 9 x 9 grid of +-3 cm in the hand's plane, where the touch
  sensors read the most force after a control step at rest, among those
  with no contact deeper than 4 mm. One batch of the port holds the
  grid."""
  tm, m = benv.model, benv.batch_model
  adr = lambda name: tm.jnt_qposadr[tm.names.name2id('joint', name)]
  obj = ('box1' if task.startswith('stack') else
         'peg' if task.endswith('peg') else 'ball')
  joints = [adr(f'{obj}_{dim}') for dim in 'xzy']
  grasp = tm.names.name2id('site', 'grasp')
  mb = m.env_rows(torch.tensor([b]))
  d = tsmooth.kinematics(mb, ttypes.make_data(mb, 1).replace(
      qpos=torch.as_tensor(qpos[b:b + 1])))
  pos, mat = np_(d.site_xpos)[0, grasp], np_(d.site_xmat)[0, grasp]
  angle = np.pi - np.arctan2(mat[2, 0], mat[0, 0])
  grid = np.linspace(-.03, .03, 9)
  cands = np.tile(qpos[b], (len(grid) ** 2, 1))
  for i, (sx, sz) in enumerate((sx, sz) for sx in grid for sz in grid):
    cands[i, joints] = (pos[0] + sx * mat[0, 0] + sz * mat[0, 2],
                        pos[2] + sx * mat[2, 0] + sz * mat[2, 2], angle)
  n = len(cands)
  rows = torch.full((n,), b)
  mc = m.env_rows(rows)
  d = tforward.forward(mc, ttypes.make_data(mc, n).replace(
      qpos=torch.as_tensor(cands)))
  deepest = np_(torch.where(d.contact.active, d.contact.dist, 0.).amin(-1))
  probe = BatchedEnvironment(tm, benv.task, batch_size=n, n_sub_steps=10)
  probe.set_state(tforward.slim_state(d),
                  leaves={k: v[rows] for k, v in benv.leaves.items()})
  obs, _, _ = probe.step(torch.zeros(n, tm.nu, dtype=torch.float64))
  touch = np.where(deepest > -.004, np_(obs['touch']).sum(-1), 0.)
  assert touch.max() > 0, f'{task}: no touching placement in the hand'
  out = qpos.copy()
  out[b] = cands[int(np.argmax(touch))]
  return out


def check_control_steps(task):
  """N_STEPS control steps of BatchedEnvironment.step (10 Euler substeps
  each) from B_ENV states, env 0 with the prop in contact with the floor
  or its receptacle, env 1 with it in the hand, touching. Each substep the
  batch's step runs (recorded at `forward.step_batched`) is held, env by
  env, against one substep of the JAX pipeline on the same input state
  and the env's own drawn body poses: the new qpos and qvel at
  TOL_SOLVE, and the last substep's sensors (touch, its contact forces)
  at TOL_SOLVE; the step's observation (but touch) and reward are the
  JAX task's on the new state at TOL_SMOOTH. Held substep by substep, not
  over a chain of ten of each side: the solvers stop where a Newton step
  no longer lowers the cost, so states 1e-14 apart can stop on different
  iterates (ROADMAP C.3; on bring_peg's in-hand state the JAX solver's
  own chain stopped after one iteration at its warmstart, 44 off in
  qacc). Episodes last two control steps, staggered: the envs that finish
  draw new body poses, the others keep theirs, and a reset env's first
  observation is that of its fresh state on its new model."""
  env = torch_env(task)
  tm = env.model
  assert env.n_sub_steps == 10
  benv = BatchedEnvironment(tm, env.task, batch_size=B_ENV, n_sub_steps=10,
                            seed=5, time_limit=2 * 10 * float(tm.opt.timestep))
  benv.reset()
  leaves = benv.leaves
  assert list(leaves) == (['body_pos'] if task.startswith('stack') else
                          ['body_pos', 'body_quat'])
  rng = np.random.default_rng(8)
  qpos = contact_qpos(task, tm, np_(benv.state['qpos']), leaves, (0,))
  qpos = hand_qpos(task, benv, qpos, 1)
  state = state_of(tm, qpos, rng.normal(0, .05, (B_ENV, tm.nv)),
                   rng.uniform(-1, 1, (B_ENV, tm.nu)))
  benv.set_state({k: torch.as_tensor(v) for k, v in state.items()},
                 steps=torch.tensor([0, 0, 1, 1]))
  active = np_(benv.data.contact.active)
  assert active[:2].any(axis=1).all(), 'envs 0 and 1 not in contact'

  def rows():
    return (np_(benv.leaves['body_pos']),
            np_(benv.leaves['body_quat']) if 'body_quat' in benv.leaves
            else np.tile(np_(tm.body_quat), (B_ENV, 1, 1)))

  substeps = []
  step_batched = tforward.step_batched

  def recorded(m, d, **kw):
    out = step_batched(m, d, **kw)
    substeps.append(({k: np_(v) for k, v in tforward.slim_state(d).items()},
                     out))
    return out

  fn = jax_env_fn(task)
  n_reset, touched = 0, 0
  with jax.enable_x64(True):
    for _ in range(N_STEPS):
      before = {k: v.clone() for k, v in benv.leaves.items()}
      jrows = rows()
      actions = torch.as_tensor(rng.uniform(-1, 1, (B_ENV, tm.nu)))
      substeps.clear()
      tforward.step_batched = recorded
      try:
        obs, reward, done = benv.step(actions)
      finally:
        tforward.step_batched = step_batched
      assert len(substeps) == 10
      for i, (inp, out) in enumerate(substeps):
        want = jax_envs(fn, *jrows, inp)
        for k in ('qpos', 'qvel'):
          assert_close(np_(getattr(out, k)), want['next'][k], TOL_SOLVE,
                       f'substep {i} {k}')
      assert_close(np_(out.sensordata), want['sensordata'], TOL_SOLVE,
                   'last substep sensordata')
      live = ~np_(done)
      for k in ('qpos', 'qvel'):
        assert torch.equal(benv.state[k][live], getattr(out, k)[live]), k
      after = jax_envs(fn, *rows(),
                       {k: np_(v) for k, v in benv.state.items()})
      assert_close(np_(reward)[live], after['reward'][live], TOL_SMOOTH,
                   'reward')
      assert list(obs) == list(after['obs'])
      for k, v in obs.items():
        if k != 'touch':
          assert_close(np_(v), after['obs'][k], TOL_SMOOTH, 'obs.' + k)
      touch = np.log1p(np.where(live[:, None], np_(out.sensordata),
                                after['sensordata']))
      touched += int((touch[live] > 0).any(axis=1).sum())
      assert_close(np_(obs['touch']), touch, TOL_SOLVE, 'obs.touch')
      moved = np.zeros(B_ENV, dtype=bool)
      for k, v in benv.leaves.items():
        moved |= np_((v != before[k]).flatten(1).any(-1))
      assert (moved == ~live).all()
      n_reset += int((~live).sum())
  assert n_reset == 4
  assert touched >= 1, 'no touch sensor read a force'


@pytest.mark.parametrize('task', ['bring_ball', 'bring_peg', 'insert_ball'])
def test_control_steps_match_jax(task):
  check_control_steps(task)


# ---------------------------------------------------------------------------
# per-env body poses


def test_per_env_body_poses_match_jax_kinematics():
  """insert_ball's drawn target and cup poses (body_pos and body_quat,
  one row an env): the port's kinematics on the batch model against the
  JAX package's (the kinematics of its position stage, in `jax_env_fn`)
  on model.replace(body_pos=row b, body_quat=row b), env by env, at
  TOL_SMOOTH; the drawn cup sits at another place in every env."""
  env = torch_env('insert_ball')
  tm = env.model
  leaves = env.task.randomize_model(tm, B_ENV,
                                    torch.Generator().manual_seed(4))
  rng = np.random.default_rng(2)
  qpos = np.tile(np_(tm.qpos0), (B_ENV, 1)) + rng.uniform(
      -.3, .3, (B_ENV, tm.nq))
  d = ttypes.make_data(tm, B_ENV).replace(qpos=torch.as_tensor(qpos))
  got = tsmooth.kinematics(tm.with_leaves(**leaves), d)
  with jax.enable_x64(True):
    want = jax_envs(jax_env_fn('insert_ball'), np_(leaves['body_pos']),
                    np_(leaves['body_quat']),
                    state_of(tm, qpos, np.zeros((B_ENV, tm.nv)),
                             np.zeros((B_ENV, tm.nu))))
  for k in POS_KEYS:
    assert_close(np_(getattr(got, k)), want[k], TOL_SMOOTH, k)
  cup = tm.names.name2id('body', 'cup')
  xpos = np_(got.xpos)[:, cup]
  assert len({tuple(r) for r in xpos.round(12)}) == B_ENV


@pytest.mark.parametrize('task', ['insert_peg', 'stack_4'])
def test_compiled_body_poses_expanded_are_bit_equal(task):
  """The compiled body_pos and body_quat expanded to one row an env give
  kinematics torch.equal to the compiled leaves' (the path every other
  model runs), and so does a step of the batch."""
  env = torch_env(task)
  tm = env.model
  rng = np.random.default_rng(3)
  qpos = np.tile(np_(tm.qpos0), (3, 1)) + rng.uniform(-.2, .2, (3, tm.nq))
  d = ttypes.make_data(tm, 3).replace(qpos=torch.as_tensor(qpos))
  rows = tm.with_leaves(body_pos=tm.body_pos.expand(3, -1, -1).clone(),
                        body_quat=tm.body_quat.expand(3, -1, -1).clone())
  want = tsmooth.kinematics(tm, d)
  got = tsmooth.kinematics(rows, d)
  for k in POS_KEYS:
    assert torch.equal(getattr(got, k), getattr(want, k)), k
  assert rows.consts is tm.consts
  with pytest.raises(ValueError):
    tm.with_leaves(body_pos=tm.body_pos)


# ---------------------------------------------------------------------------
# the resets


def _parent_contact_free_qpos(model, batch, draw, max_rounds):
  """The rejection sampler before per-env rows (`draw(n)`, the compiled
  model's contacts), kept to hold today's callers' draws to it."""

  def n_contacts(qpos):
    d = ttypes.make_data(model, qpos.shape[0], dtype=qpos.dtype)
    d = tsmooth.kinematics(model, d.replace(qpos=qpos))
    return tcollision.collision(model, d).contact.active.sum(dim=-1)

  qpos = draw(batch)
  n = n_contacts(qpos)
  for _ in range(max_rounds):
    redo = torch.nonzero(n > 0)[:, 0]
    if not len(redo):
      break
    qpos[redo] = draw(len(redo))
    n[redo] = n_contacts(qpos[redo])
  return qpos


def test_finger_reset_draws_are_the_parents():
  """finger's rejection-sampling reset (on the compiled model) draws
  torch.equal to the sampler before per-env rows, from one seed."""
  env = suite.load('finger', 'turn_hard', device='cpu', dtype=torch.float64)
  tm = env.model
  n = 64
  d = ttypes.make_data(tm, n)
  got = env.task.initialize_episode(tm, d, torch.Generator().manual_seed(9))
  gen = torch.Generator().manual_seed(9)
  want = _parent_contact_free_qpos(
      tm, n, lambda k: tbase.random_limited_qpos(tm, k, gen), 64)
  assert torch.equal(got.qpos, want)
  # the sampler redrew some envs: the draws above went past the first
  first = tbase.random_limited_qpos(tm, n, torch.Generator().manual_seed(9))
  assert not torch.equal(first, want)


def test_insert_peg_reset_collides_each_env_with_its_own_slot():
  """Three envs with their slots drawn apart. Env 1's peg rests on env
  1's slot (not on row 0's): it is redrawn. Env 2's peg rests where row
  0's slot is, and not on its own: it is kept. Env 0's peg touches
  nothing: it is kept. The second round draws env 1 alone, and draws it
  where row 0's slot is: free of its own slot, it is kept."""
  env = torch_env('insert_peg')
  tm = env.model
  leaves = env.task.randomize_model(tm, 3, torch.Generator().manual_seed(1))
  slot = tm.names.name2id('body', 'slot')
  target = tm.names.name2id('body', 'target_peg')
  for b, x in enumerate((-.3, .25, .05)):
    for body in (slot, target):
      leaves['body_pos'][b, body, 0] = x
  m = tm.with_leaves(**leaves)
  qpos = np.tile(np_(tm.qpos0), (3, 1))
  # the peg on env 1's slot in env 1, on env 0's slot in env 2
  placed = contact_qpos('insert_peg', tm, qpos, leaves, (0, 1))
  qpos[1], qpos[2] = placed[1], placed[0]
  qpos[0] = contact_qpos('bring_peg', tm, qpos, leaves, (0,))[0]
  adr = tm.jnt_qposadr[tm.names.name2id('joint', 'peg_z')]
  qpos[0, adr] += .1                       # well above the floor
  at_row0 = torch.as_tensor(np.tile(placed[0], (3, 1)))
  calls = []

  def draw(idx):
    calls.append(idx.tolist())
    return (torch.as_tensor(qpos[idx.numpy()]) if len(calls) == 1
            else at_row0[idx])

  got = tbase.contact_free_qpos(m, 3, draw, 200)
  assert calls == [[0, 1, 2], [1]]
  assert torch.equal(got[[0, 2]], torch.as_tensor(qpos[[0, 2]]))
  assert torch.equal(got[1], at_row0[1])
  # on the compiled model (row 0's slot for every env) env 2 would touch
  d = ttypes.make_data(tm, 3).replace(qpos=torch.as_tensor(qpos))
  for model, want in ((m, [False, True, False]), (m.env_rows(
      torch.tensor([0, 0, 0])), [False, False, True])):
    con = tcollision.collision(model, tsmooth.kinematics(model, d)).contact
    touching = con.active.any(dim=-1).tolist()
    assert touching == want
    live = np_(con.active)
    types = {(tm.geom_type[g1], tm.geom_type[g2]) for g1, g2 in zip(
        np_(con.geom1)[live], np_(con.geom2)[live])}
    assert types == {(_G.CAPSULE, _G.BOX)}


# ---------------------------------------------------------------------------
# the draws, the assets and the domains' batches


def test_task_loads_draws_and_resets():
  """Each of the six tasks, one after another (one test, not six cases:
  ROADMAP C.e, the lane's item count)."""
  for task in sorted(TASKS):
    check_task_loads_draws_and_resets(task)


def check_task_loads_draws_and_resets(task):
  """suite.load serves the task (its factory defaults to the card) from
  its verbatim asset, with the JAX build's sizes; 2000 draws of its body
  poses lie in the reference's ranges and move only the target (and the
  receptacle, to the same pose); a reset of 8 envs leaves none in
  contact, and a control step gives finite observations and rewards and
  ends every episode at its time limit."""
  domain = TASKS[task][0]
  module = tmanipulator if domain == 'manipulator' else tstacker
  assert inspect.signature(getattr(module, task)).parameters[
      'device'].default == 'cuda'
  assert tcommon.read_model(f'{domain}.xml') == jcommon.read_model(
      f'{domain}.xml')
  assert TASKS[task][1]() == (tmanipulator.make_model(
      task.endswith('peg'), task.startswith('insert'))
                              if domain == 'manipulator' else
                              tstacker.make_model(int(task[-1])))
  env = torch_env(task)
  tm = env.model
  assert env.n_sub_steps == 10
  assert set(tm.pair_condim) == {3} and tm.ncon_sel == 16
  assert tm.nefc_max <= 160
  leaves = env.task.randomize_model(tm, 2000, torch.Generator().manual_seed(2))
  pos = np_(leaves['body_pos'])
  moved = np.nonzero((pos != np_(tm.body_pos)).any(axis=(0, 2)))[0]
  names = {tm.names.names('body')[b] for b in moved}
  if domain == 'stacker':
    assert list(leaves) == ['body_pos'] and names == {'target'}
    t = tm.names.name2id('body', 'target')
    x, z = pos[:, t, 0], pos[:, t, 2]
    levels = np.round(z / .022).astype(int)
    assert set(levels) == set(range(1, 2 * int(task[-1]), 2))
    assert np.allclose(z, .022 * levels, atol=1e-15)
    assert (np.abs(x) <= .37).all() and np.abs(x).max() > .35
  else:
    peg = task.endswith('peg')
    want = {'target_peg' if peg else 'target_ball'}
    if task.startswith('insert'):
      want.add('slot' if peg else 'cup')
    assert names == want
    quat = np_(leaves['body_quat'])
    ids = [tm.names.name2id('body', n) for n in sorted(want)]
    for b in ids[1:]:
      assert (pos[:, b][:, [0, 2]] == pos[:, ids[0]][:, [0, 2]]).all()
      assert (quat[:, b] == quat[:, ids[0]]).all()
    x, z = pos[:, ids[0], 0], pos[:, ids[0], 2]
    angle = _angle_y(quat[:, ids[0]])
    lim = np.pi / 3 if task.startswith('insert') else np.pi
    assert (np.abs(x) <= .4).all() and ((z >= .1) & (z <= .4)).all()
    assert (np.abs(angle) <= lim + 1e-12).all() and np.abs(angle).max() > (
        .95 * lim)
    assert np.allclose(np.linalg.norm(quat[:, ids[0]], axis=1), 1.0)
  benv = BatchedEnvironment(tm, env.task, batch_size=8, n_sub_steps=10,
                            seed=3, time_limit=.01)
  benv.reset()
  assert not bool(benv.data.contact.active.any())
  obs, reward, done = benv.step(torch.zeros(8, tm.nu, dtype=torch.float64))
  assert torch.isfinite(reward).all()
  assert all(bool(torch.isfinite(v).all()) for v in obs.values())
  assert bool(done.all())


def test_manipulator_reset_places_the_prop():
  """bring_ball's reset over 128 envs: the ball sits in the hand (at the
  grasp site), in the env's own drawn target, or uniformly, about 10 %,
  10 % and 80 % of the envs; only the uniform ones move in x; the finger
  mirrors the thumb."""
  env = torch_env('bring_ball')
  tm = env.model
  n = 128
  gen = torch.Generator().manual_seed(6)
  leaves = env.task.randomize_model(tm, n, gen)
  m = tm.with_leaves(**leaves)
  d = env.task.initialize_episode(m, ttypes.make_data(m, n), gen)
  qpos, qvel = np_(d.qpos), np_(d.qvel)
  jadr = lambda name: tm.jnt_qposadr[tm.names.name2id('joint', name)]
  vadr = lambda name: tm.jnt_dofadr[tm.names.name2id('joint', name)]
  assert (qpos[:, jadr('finger')] == qpos[:, jadr('thumb')]).all()
  ball = qpos[:, [jadr('ball_x'), jadr('ball_z')]]
  t = tm.names.name2id('body', 'target_ball')
  in_target = (np.abs(ball - np_(leaves['body_pos'])[:, t][:, [0, 2]])
               < 1e-12).all(axis=1)
  fk = tsmooth.kinematics(m, d)
  grasp = np_(fk.site_xpos)[:, tm.names.name2id('site', 'grasp')][:, [0, 2]]
  in_hand = (np.abs(ball - grasp) < 1e-12).all(axis=1)
  uniform = ~in_target & ~in_hand
  assert 4 <= in_target.sum() <= 30 and 4 <= in_hand.sum() <= 30
  vx = qvel[:, vadr('ball_x')]
  assert (vx[~uniform] == 0).all() and (np.abs(vx[uniform]) <= 5).all()
  assert (vx[uniform] != 0).mean() > .9
