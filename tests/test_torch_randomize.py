"""The port's ninth slice: per-env model leaves in the batched env, the
frame sensors, and reacher, point_mass.hard, fish.swim and swimmer.

Both sides run in float64 on the CPU; the JAX side enables x64 only inside
a scoped context. The JAX batched path never draws a model
(`Task.randomize_model` runs only in its unbatched environment), so each
of the port's envs is held against the unbatched JAX pipeline on a model
that carries that env's drawn leaves: the port draws B envs' leaves, and
the JAX side builds env b's model with `model.replace(<leaf>=row b)`.

The lane budget: the JAX side compiles one function a domain (`jax.vmap`
over the drawn leaf and the state of an unbatched forward, observation,
reward and Euler step) and one for the frame-sensor model; the oracle,
draw and reset tests compile nothing on the JAX side.
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
from dm_control_tpu.ops import sensor as jsensor
from dm_control_tpu.suite import common as jcommon
from dm_control_tpu.suite import fish as jfish
from dm_control_tpu.suite import point_mass as jpoint_mass
from dm_control_tpu.suite import reacher as jreacher
from dm_control_tpu.suite import swimmer as jswimmer

from dm_control_tpu_torch import models as tmodels
from dm_control_tpu_torch import suite
from dm_control_tpu_torch.models import constants
from dm_control_tpu_torch.models import types as ttypes
from dm_control_tpu_torch.ops import constraint as tconstraint
from dm_control_tpu_torch.ops import forward as tforward
from dm_control_tpu_torch.ops import sensor as tsensor
from dm_control_tpu_torch.ops import smooth as tsmooth
from dm_control_tpu_torch.parallel import BatchedEnvironment
from dm_control_tpu_torch.suite import common as tcommon
from dm_control_tpu_torch.suite import fish as tfish
from dm_control_tpu_torch.suite import point_mass as tpoint_mass
from dm_control_tpu_torch.suite import reacher as treacher
from dm_control_tpu_torch.suite import swimmer as tswimmer

from test_torch_slice import (TOL_SMOOTH, TOL_SOLVE, assert_close,
                              jax_model_to_numpy, np_)

# One intra-op thread: the batches here are tiny, and pytest-xdist workers
# share the host's cores, where a thread pool per worker only contends.
torch.set_num_threads(1)

B = 4
# a domain's case: its task, the leaf its task draws, the JAX task on a
# JAX model, and the MJCF of both sides
CASES = {
    'reacher': dict(
        task='hard', leaf='geom_pos',
        jax_task=lambda m: jreacher.Reacher(m, jreacher._SMALL_TARGET),
        xml=(jreacher.make_model, treacher.make_model)),
    'point_mass': dict(
        task='hard', leaf='wrap_prm',
        jax_task=lambda m: jpoint_mass.PointMass(m, randomize_gains=True),
        xml=(jpoint_mass.make_model, tpoint_mass.make_model)),
    'fish': dict(
        task='swim', leaf='geom_pos', jax_task=jfish.Swim,
        xml=(jfish.make_model, tfish.make_model)),
    'swimmer': dict(
        task='swimmer6', leaf='geom_pos', jax_task=jswimmer.Swimmer,
        xml=(lambda: jswimmer.make_model(6), lambda: tswimmer.make_model(6))),
}
# the tasks this slice serves
NEW_TASKS = [('reacher', 'easy'), ('reacher', 'hard'), ('point_mass', 'hard'),
             ('fish', 'swim'), ('swimmer', 'swimmer6'),
             ('swimmer', 'swimmer15')]


@functools.lru_cache(maxsize=None)
def _torch_env(domain, task):
  return suite.load(domain, task, device='cpu', dtype=torch.float64)


def _jax_model(domain):
  with jax.enable_x64(True):
    m = jmodels.from_xml_string(CASES[domain]['xml'][0](),
                                assets=jcommon.ASSETS, dtype=jnp.float64)
    if domain == 'reacher':
      # as the reference's factory bakes the target size into the model
      gid = m.names.name2id('geom', 'target')
      size = np.array(m.geom_size)
      size[gid, 0] = jreacher._SMALL_TARGET
      m = m.replace(geom_size=jnp.asarray(size))
  return m


def _draw(task, model, n, seed=0):
  return task.randomize_model(model, n, torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------------------
# each env against the JAX pipeline on its own model


def _start_state(domain, tm, rng):
  """B states with a live limit row in some envs (reacher's wrist,
  point_mass's sliders, a swimmer joint); fish disables its constraints.
  Small velocities where the fluid forces grow with their squares."""
  qpos = np.tile(np_(tm.qpos0), (B, 1))
  if domain == 'reacher':
    qpos[:, 0] = rng.uniform(-np.pi, np.pi, B)
    qpos[:, 1] = rng.uniform(-2.7, 2.7, B)
    qpos[3, 1] = 2.82                      # the wrist's limit is 2.793
  elif domain == 'point_mass':
    qpos = rng.uniform(-0.28, 0.28, (B, tm.nq))
    qpos[2, 0], qpos[3, 1] = 0.31, -0.32   # the sliders' limits are .29
  elif domain == 'fish':
    quat = rng.normal(size=(B, 4))
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, 7:] = rng.uniform(-0.2, 0.2, (B, tm.nq - 7))
  else:
    qpos[:, :2] = rng.uniform(-0.5, 0.5, (B, 2))
    qpos[:, 2] = rng.uniform(-np.pi, np.pi, B)
    qpos[:, 3:] = rng.uniform(-1.0, 1.0, (B, tm.nq - 3))
    qpos[3, 4] = 1.07                      # the joints' limits are 1.047
  speed = 0.05 if domain in ('fish', 'swimmer') else 0.5
  return {'time': np.zeros(B), 'qpos': qpos,
          'qvel': rng.normal(0.0, speed, (B, tm.nv)),
          'act': np.zeros((B, tm.na)),
          'ctrl': rng.uniform(-1.0, 1.0, (B, tm.nu)),
          'qacc': np.zeros((B, tm.nv)),
          'qacc_warmstart': np.zeros((B, tm.nv)),
          'sensordata': np.zeros((B, tm.nsensordata))}


POS_KEYS = ('xpos', 'xmat', 'geom_xpos', 'geom_xmat', 'site_xpos',
            'ten_length', 'ten_J', 'actuator_moment', 'sensordata')


def _jax_substep(m, task, leaf):
  """env b's forward on its own model, vmapped over (leaf, state):
  position/velocity fields and sensors, observation and reward of the
  input state, qacc, and the state after one Euler substep."""

  def one(row, s):
    mb = m.replace(**{leaf: row})
    d = jforward.fwd_pv(mb, jforward.inflate(mb, s))
    out = {k: getattr(d, k) for k in POS_KEYS}
    out['obs'] = task.get_observation(mb, d)
    out['reward'] = task.get_reward(mb, d)
    d = jforward.fwd_aa(mb, d)
    out['qacc'] = d.qacc
    out['next'] = jforward.slim_state(jforward._integrate(mb, d))
    return out

  return jax.vmap(one)


@pytest.fixture(scope='module', params=list(CASES))
def case(request):
  """(domain, port env, the drawn leaves, start state, the JAX outputs of
  the first substep, the JAX state after a control step, the JAX
  outputs on it)."""
  domain = request.param
  c = CASES[domain]
  env = _torch_env(domain, c['task'])
  leaves = _draw(env.task, env.model, B)
  assert list(leaves) == [c['leaf']]
  row = np_(leaves[c['leaf']])
  m = _jax_model(domain)
  start = _start_state(domain, env.model, np.random.default_rng(5))
  with jax.enable_x64(True):
    f = jax.jit(_jax_substep(m, c['jax_task'](m), c['leaf']))
    first = jax.tree.map(np.asarray, f(row, start))
    state = first['next']
    for _ in range(env.n_sub_steps - 1):
      state = jax.tree.map(np.asarray, f(row, state)['next'])
    last = jax.tree.map(np.asarray, f(row, state))
  return domain, m, env, leaves, start, first, state, last


def test_each_env_matches_jax_on_its_own_model(case):
  """One test item a domain, so that one worker compiles its function:

  - the port's MJCF is the reference's string and its build the JAX
    build (static fields exactly, parameters to 1e-12);
  - the drawn leaves differ env by env, and only in the target's row or
    the tendon coefficients;
  - on the batch model (the drawn leaves, one row an env) the
    position/velocity stage (frames, tendons, moment arms, every sensor)
    at TOL_SMOOTH, and the observation and reward of the input state;
  - qacc and the state after one Euler substep, and after a control step
    of BatchedEnvironment.step_core with its observation and reward, at
    TOL_SOLVE where limits are live (TOL_SMOOTH for fish, which disables
    its constraints)."""
  domain, m, env, leaves, start, first, state, last = case
  tm = env.model
  assert CASES[domain]['xml'][1]() == CASES[domain]['xml'][0]()
  arrays, meta = jax_model_to_numpy(m)
  t_arrays, t_meta = tmodels.model_to_numpy(tm)
  for k, v in t_meta.items():
    if k not in ('names', 'opt'):
      assert v == meta[k], k
  for k, v in t_arrays.items():
    if k != 'opt':
      assert_close(v, arrays[k], 1e-12, k)

  leaf = CASES[domain]['leaf']
  row = np_(leaves[leaf])
  compiled = np_(getattr(tm, leaf))
  changed = (row != compiled).reshape(B, -1).any(axis=0)
  if leaf == 'geom_pos':
    target = tm.names.name2id('geom', 'target')
    assert set(np.nonzero(changed)[0] // 3) == {target}
  else:
    assert changed[:4].all() and not changed[4:].any()
  assert len({r.tobytes() for r in row}) == B

  smooth = bool(tm.opt.disableflags & constants.DisableBit.CONSTRAINT)
  tol = TOL_SMOOTH if smooth else TOL_SOLVE
  tb = tm.with_leaves(**leaves)
  s0 = {k: torch.as_tensor(v) for k, v in start.items()}
  d = tforward.fwd_pv(tb, tforward.inflate(tb, s0))
  for k in POS_KEYS:
    assert_close(np_(getattr(d, k)), first[k], TOL_SMOOTH, k)
  obs = env.task.get_observation(tb, d)
  assert list(obs) == list(first['obs'])
  for k, v in obs.items():
    assert_close(np_(v), first['obs'][k], TOL_SMOOTH, f'obs.{k}')
  assert_close(np_(env.task.get_reward(tb, d)), first['reward'], TOL_SMOOTH,
               'reward')
  d = tforward.step_batched(tb, tforward.inflate(tb, s0))
  assert_close(np_(d.qacc), first['qacc'], tol, 'qacc')
  for k in ('qpos', 'qvel'):
    assert_close(np_(getattr(d, k)), first['next'][k], tol, 'next.' + k)
  if not smooth:
    rows = tconstraint.make_rows(tb, tforward.fwd_pv(
        tb, tforward.inflate(tb, s0)))
    assert bool((rows.slot_active > 0).any()), 'no live limit row'

  benv = BatchedEnvironment(tm, env.task, batch_size=B,
                            n_sub_steps=env.n_sub_steps)
  benv.set_state(s0, leaves=leaves)
  new_state, obs, reward, _, diverged = benv.step_core(s0, s0['ctrl'])
  assert not bool(diverged.any())
  for k in ('qpos', 'qvel'):
    assert_close(np_(new_state[k]), state[k], tol, k)
  for k, v in obs.items():
    assert_close(np_(v), last['obs'][k], tol, f'step_core obs.{k}')
  assert_close(np_(reward), last['reward'], tol, 'step_core reward')


# ---------------------------------------------------------------------------
# the frame sensors

_FRAME_XML = """
<mujoco>
  <worldbody>
    <body name="b" pos=".1 .2 .3" quat=".9 .1 .3 .2">
      <freejoint/>
      <geom name="g" type="box" size=".1 .05 .02" pos=".05 -.02 .01"
            quat=".7 .2 .5 .1"/>
      <site name="s" pos="-.03 .04 .02" quat=".8 -.3 .2 .4"/>
      <body name="c" pos=".2 0 0">
        <joint name="h" type="hinge" axis="0 1 1"/>
        <geom type="capsule" size=".02 .1" pos=".1 0 0"/>
      </body>
    </body>
  </worldbody>
  <sensor>
{sensors}
  </sensor>
</mujoco>
"""
_FRAME_TAGS = ('framepos', 'framequat', 'framexaxis', 'frameyaxis',
               'framezaxis', 'framelinvel', 'frameangvel')
_FRAME_OBJS = (('site', 's'), ('geom', 'g'), ('body', 'b'), ('xbody', 'c'))


def _frame_xml():
  return _FRAME_XML.format(sensors='\n'.join(
      f'    <{tag} objtype="{ot}" objname="{on}"/>'
      for tag in _FRAME_TAGS for ot, on in _FRAME_OBJS))


def test_frame_sensors_match_jax():
  """The seven frame types on a site, a geom, a body and an xbody, at
  random poses and velocities, against the JAX sensor function at
  TOL_SMOOTH."""
  xml = _frame_xml()
  tm = tmodels.from_xml_string(xml, device='cpu', dtype=torch.float64)
  assert sorted(set(tm.sensor_type)) == list(range(
      constants.SensorType.FRAMEPOS, constants.SensorType.FRAMEANGVEL + 1))
  rng = np.random.default_rng(3)
  qpos = rng.normal(size=(B, tm.nq))
  qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
  # one env's free-joint quaternion near each of Shepperd's four branches
  qpos[:, 3:7] = [[1, 0, 0, 0], [.1, .99, 0, 0], [.1, 0, .99, .05],
                  [0, .1, 0, .99]]
  qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
  state = {'qpos': qpos, 'qvel': rng.normal(size=(B, tm.nv))}
  with jax.enable_x64(True):
    m = jmodels.from_xml_string(xml, dtype=jnp.float64)

    def one(s):
      d = jforward.inflate(m, dict(time=jnp.zeros(()), **s))
      d = jforward.fwd_velocity(m, jforward.fwd_position(m, d))
      return jsensor.sensors(m, d, stages='pv').sensordata

    want = np.asarray(jax.jit(jax.vmap(one))(state))
  d = tforward.inflate(tm, {k: torch.as_tensor(v) for k, v in state.items()})
  d = tforward.fwd_velocity(tm, tforward.fwd_position(tm, d))
  got = np_(tsensor.sensors(tm, d, stages='pv').sensordata)
  assert np.abs(want).max() > 0.1
  assert_close(got, want, TOL_SMOOTH, 'frame sensordata')


def test_swimmer_sensors_match_mujoco():
  """swimmer6's sensordata (the frame sensors nose_pos, target_pos,
  head_xaxis, head_yaxis, then velocimeters and gyros) after one control
  step of BatchedEnvironment.step, against MuJoCo 3.10 with each
  env's drawn target position (`mj_forward`, then n_sub_steps of
  `mj_step2` and `mj_step1`, as dm_control's `Physics.step` runs them)."""
  import mujoco  # the oracle; a lane without it fails here, not skips
  env = _torch_env('swimmer', 'swimmer6')
  tm = env.model
  leaves = _draw(env.task, tm, B, seed=1)
  start = _start_state('swimmer', tm, np.random.default_rng(6))
  benv = BatchedEnvironment(tm, env.task, batch_size=B,
                            n_sub_steps=env.n_sub_steps)
  s0 = {k: torch.as_tensor(v) for k, v in start.items()}
  benv.set_state(s0, leaves=leaves)
  benv.step(s0['ctrl'])
  got = np_(benv.data.sensordata)

  assets = {k: v for k, v in tcommon.read_assets().items()
            if k.startswith('./')}
  mm = mujoco.MjModel.from_xml_string(tswimmer.make_model(6), assets)
  target = mm.geom('target').id
  want = []
  for b in range(B):
    mm.geom_pos[target] = np_(leaves['geom_pos'])[b, target]
    md = mujoco.MjData(mm)
    md.qpos[:], md.qvel[:] = start['qpos'][b], start['qvel'][b]
    md.ctrl[:] = start['ctrl'][b]
    mujoco.mj_forward(mm, md)
    for _ in range(env.n_sub_steps):
      mujoco.mj_step2(mm, md)
      mujoco.mj_step1(mm, md)
    want.append(md.sensordata.copy())
  want = np.array(want)
  assert (np.abs(want[:, 3:5] - np_(leaves['geom_pos'])[:, target, :2])
          < 1e-12).all(), 'target_pos reads the drawn target'
  np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-8)


# ---------------------------------------------------------------------------
# the draws and the batch's leaves


@pytest.mark.parametrize('domain,task', NEW_TASKS,
                         ids=[f'{d}-{t}' for d, t in NEW_TASKS])
def test_draws_follow_the_reference(domain, task):
  """suite.load serves the task (its factory defaults to the card), and
  2000 draws of its leaves lie in the reference's ranges: reacher's
  target at a radius in [.05, .20] of the arm's base; point_mass.hard's
  two unit directions at most .9 apart in cosine; fish.swim's target in
  [-.4, .4]^2 x [.1, .3]; swimmer's in [-2, 2]^2, in [-.3, .3]^2 with
  probability 0.2 + 0.8 (.15^2). Every other entry of the leaf keeps
  its compiled value."""
  module = {'reacher': treacher, 'point_mass': tpoint_mass, 'fish': tfish,
            'swimmer': tswimmer}[domain]
  assert inspect.signature(getattr(module, task)).parameters[
      'device'].default == 'cuda'
  env = _torch_env(domain, task)
  tm, n = env.model, 2000
  leaves = _draw(env.task, tm, n, seed=2)
  leaf = 'wrap_prm' if domain == 'point_mass' else 'geom_pos'
  assert list(leaves) == [leaf]
  v, compiled = np_(leaves[leaf]), np_(getattr(tm, leaf))
  if leaf == 'wrap_prm':
    dir1, dir2 = v[:, 0:2], v[:, 2:4]
    assert np.allclose(np.linalg.norm(dir1, axis=1), 1.0)
    assert np.allclose(np.linalg.norm(dir2, axis=1), 1.0)
    cos = np.abs((dir1 * dir2).sum(axis=1))
    assert (cos <= 0.9 + 1e-12).all() and cos.max() > 0.85
    return
  target = tm.names.name2id('geom', 'target')
  others = np.delete(v, target, axis=1)
  assert (others == np.delete(compiled, target, axis=0)).all()
  x, y, z = v[:, target].T
  if domain == 'reacher':
    r = np.hypot(x, y)
    assert (r >= .05).all() and (r <= .20).all() and (z == compiled[
        target, 2]).all()
    assert r.min() < .06 and r.max() > .19
    assert ((x > 0) & (y > 0)).any() and ((x < 0) & (y < 0)).any()
  elif domain == 'fish':
    assert (np.abs(x) <= .4).all() and (np.abs(y) <= .4).all()
    assert (z >= .1).all() and (z <= .3).all() and z.std() > .05
  else:
    assert (np.abs(x) <= 2).all() and (np.abs(y) <= 2).all()
    assert (z == compiled[target, 2]).all()
    close = ((np.abs(x) <= .3) & (np.abs(y) <= .3)).mean()
    assert abs(close - (0.2 + 0.8 * .15 ** 2)) < 0.04
    assert np.abs(v[:, target, :2]).max() > 1.5


def test_auto_reset_redraws_only_the_done_envs():
  """reacher.easy with a time limit of 3 control steps and staggered
  episode step counts: at each step the envs that finish get new target
  positions and the others keep theirs bit for bit; every returned
  observation is the batch model's own (a reset env's reads its new
  target)."""
  env = _torch_env('reacher', 'easy')
  tm, n = env.model, 6
  benv = BatchedEnvironment(tm, env.task, batch_size=n,
                            time_limit=3 * float(tm.opt.timestep), seed=4)
  benv.reset()
  assert benv.leaves['geom_pos'].shape == (n,) + tuple(tm.geom_pos.shape)
  benv.set_state(benv.state, steps=torch.arange(n) % 3)
  zeros = torch.zeros(n, tm.nu, dtype=torch.float64)
  seen = torch.zeros(n, dtype=torch.bool)
  for _ in range(3):
    before = benv.leaves['geom_pos'].clone()
    obs, _, done = benv.step(zeros)
    after = benv.leaves['geom_pos']
    assert 0 < int(done.sum()) < n
    assert torch.equal(after[~done], before[~done])
    assert (after[done] != before[done]).any(dim=-1).any(dim=-1).all()
    want = env.task.get_observation(benv.batch_model, benv.data)
    for k, v in obs.items():
      assert_close(np_(v), np_(want[k]), TOL_SMOOTH, k)
    seen |= done
  assert seen.all()


def test_task_without_draws_runs_the_compiled_model():
  """point_mass.easy draws nothing: after reset and an auto-reset the
  batch steps with the compiled model itself, its leaves unbatched."""
  env = _torch_env('point_mass', 'easy')
  tm = env.model
  assert env.task.randomize_model(tm, 3, torch.Generator()) == {}
  benv = BatchedEnvironment(tm, env.task, batch_size=3,
                            time_limit=float(tm.opt.timestep))
  benv.reset()
  _, _, done = benv.step(torch.zeros(3, tm.nu, dtype=torch.float64))
  assert bool(done.all())
  assert benv.leaves == {} and benv.batch_model is tm
  for k in ttypes.RANDOMIZED:
    assert getattr(benv.batch_model, k).shape == getattr(tm, k).shape
  assert tm.geom_pos.dim() == 2 and tm.wrap_prm.dim() == 1


def test_model_memo_survives_an_auto_reset():
  """The batch model shares the compiled model's memo: after a first
  control step has built every schedule a step uses, an auto-reset that
  redraws every env's target rebuilds none of them (the same objects,
  the same keys), fk_schedule among them."""
  env = _torch_env('swimmer', 'swimmer6')
  tm = env.model
  benv = BatchedEnvironment(tm, env.task, batch_size=2,
                            time_limit=float(tm.opt.timestep) * 30,
                            n_sub_steps=15)
  benv.reset()
  zeros = torch.zeros(2, tm.nu, dtype=torch.float64)
  _, _, done = benv.step(zeros)
  assert not bool(done.any())
  memo = dict(tm.consts)
  fk = tsmooth._fk_schedule(benv.batch_model)
  before = benv.leaves['geom_pos'].clone()
  _, _, done = benv.step(zeros)
  assert bool(done.all()) and not torch.equal(benv.leaves['geom_pos'], before)
  assert benv.batch_model.consts is tm.consts
  assert tsmooth._fk_schedule(benv.batch_model) is fk
  assert set(tm.consts) == set(memo)
  assert all(tm.consts[k] is v for k, v in memo.items())
  with pytest.raises(ValueError):
    tm.with_leaves(body_pos=tm.body_pos)


def test_per_env_site_pos_moves_each_envs_sites():
  """site_pos (which finger.turn will draw) may be per env too: each env's
  site frames are those of the model with that env's row."""
  tm = _torch_env('swimmer', 'swimmer6').model
  rows = tm.site_pos + torch.linspace(0, .3, 3, dtype=torch.float64)[
      :, None, None]
  d = ttypes.make_data(tm, 3)
  d = d.replace(qpos=d.qpos + torch.linspace(-.2, .2, tm.nq,
                                             dtype=torch.float64))
  got = tsmooth.kinematics(tm.with_leaves(site_pos=rows), d).site_xpos
  for b in range(3):
    want = tsmooth.kinematics(tm.replace(site_pos=rows[b]), d).site_xpos[b]
    assert torch.equal(got[b], want)
  assert not torch.equal(got[0], got[2])


@pytest.mark.parametrize('n_links', [3, 6, 15])
def test_swimmer_model_string_and_assets(n_links):
  """make_model(n) is the reference's string, from verbatim assets."""
  assert tswimmer.make_model(n_links) == jswimmer.make_model(n_links)
  for name in ('swimmer.xml', 'reacher.xml'):
    assert tcommon.read_model(name) == jcommon.read_model(name)
