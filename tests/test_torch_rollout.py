"""The port's batched humanoid.run environment on the CPU, its entry
points' default device, and its independence from JAX."""

import inspect
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from dm_control_tpu_torch import models
from dm_control_tpu_torch import suite
from dm_control_tpu_torch.models import types
from dm_control_tpu_torch.parallel import BatchedEnvironment
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.suite import humanoid

# One intra-op thread: the batches here are tiny, and pytest-xdist workers
# share the host's cores, where a thread pool per worker only contends.
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORT = os.path.join(_REPO, 'dm_control_tpu_torch')
_JAX_ASSETS = os.path.join(_REPO, 'dm_control_tpu', 'suite', 'assets')


@pytest.fixture(scope='module')
def env():
  return suite.load('humanoid', 'run', device='cpu', dtype=torch.float32)


def test_rollout_random_cpu(env):
  benv = BatchedEnvironment(env.model, env.task, batch_size=4,
                            n_sub_steps=env.n_sub_steps, seed=0)
  assert env.n_sub_steps == 5
  obs = benv.reset()
  assert obs['velocity'].shape == (4, 27)
  data, total = benv.rollout_random(3)
  assert total.shape == (4,) and torch.isfinite(total).all()
  assert ((total >= 0) & (total <= 3)).all()
  assert data.qpos.shape == (4, 28) and torch.isfinite(data.qpos).all()
  assert not data.divergence.any()
  # the same seed gives the same rollout
  benv2 = BatchedEnvironment(env.model, env.task, batch_size=4,
                             n_sub_steps=env.n_sub_steps, seed=0)
  benv2.reset()
  _, total2 = benv2.rollout_random(3)
  torch.testing.assert_close(total, total2, rtol=0, atol=0)


def test_step_resets_diverged_envs(env):
  benv = BatchedEnvironment(env.model, env.task, batch_size=3,
                            n_sub_steps=env.n_sub_steps, seed=1)
  benv.reset()
  state = dict(benv.state)
  qvel = state['qvel'].clone()
  qvel[1] = float('nan')
  state['qvel'] = qvel
  benv.set_state(state)
  obs, reward, done = benv.step(torch.zeros(3, env.model.nu))
  assert done.tolist() == [False, True, False]
  for v in benv.state.values():
    assert torch.isfinite(v).all()
  assert torch.isfinite(obs['velocity']).all()
  assert torch.isfinite(reward[[0, 2]]).all()


def test_initial_poses_are_contact_free(env):
  benv = BatchedEnvironment(env.model, env.task, batch_size=8,
                            n_sub_steps=env.n_sub_steps, seed=2)
  benv.reset()
  assert not benv.data.contact.active.any()


def test_port_runs_without_jax():
  """Build humanoid, cartpole (RK4, energy) and cheetah with the port's
  own compiler and step them, with jax, dm_env and mujoco made
  unimportable. Cheetah starts from qpos0: its 200-step settling reset
  is the same step, held in test_torch_suite.py."""
  code = textwrap.dedent("""
      import sys
      sys.modules['jax'] = sys.modules['dm_env'] = None
      sys.modules['mujoco'] = None
      import torch
      torch.set_num_threads(1)
      from dm_control_tpu_torch import suite
      from dm_control_tpu_torch.models import types
      from dm_control_tpu_torch.ops import forward
      from dm_control_tpu_torch.parallel import BatchedEnvironment
      for domain, task in (('humanoid', 'run'), ('cartpole', 'swingup'),
                           ('cheetah', 'run')):
        env = suite.load(domain, task, device='cpu')
        benv = BatchedEnvironment(env.model, env.task, batch_size=2,
                                  n_sub_steps=env.n_sub_steps)
        if domain == 'cheetah':
          benv.set_state(forward.slim_state(forward.forward(
              env.model, types.make_data(env.model, 2))))
        else:
          benv.reset()
        obs, reward, done = benv.step(torch.zeros(2, env.model.nu))
        assert torch.isfinite(reward).all(), (domain, reward)
        assert torch.isfinite(benv.data.energy).all(), domain
      assert not any(m == 'dm_control_tpu' or m.startswith('dm_control_tpu.')
                     for m in sys.modules)
      print('ok')
  """)
  proc = subprocess.run([sys.executable, '-c', code], cwd=_REPO,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip().endswith('ok')


@pytest.mark.parametrize('entry_point', [
    humanoid.stand, humanoid.walk, humanoid.run, humanoid.run_pure_state,
    models.from_xml_string, models.from_xml_path, types.model_from_numpy,
], ids=lambda f: f.__name__)
def test_entry_points_default_to_cuda(entry_point):
  assert inspect.signature(entry_point).parameters['device'].default == \
      'cuda'


def test_default_device_without_a_card_raises():
  """No silent fall back to the CPU: torch's own error surfaces."""
  if torch.cuda.is_available():
    pytest.skip('a card is present; the default device works here')
  with pytest.raises((AssertionError, RuntimeError)):
    suite.load('humanoid', 'run')


@pytest.mark.parametrize('name', [
    'humanoid.xml', 'cartpole.xml', 'acrobot.xml', 'pendulum.xml',
    'cheetah.xml', 'walker.xml', 'hopper.xml', 'quadruped.xml',
    'humanoid_CMU.xml', 'ball_in_cup.xml', 'point_mass.xml', 'fish.xml',
    'lqr.xml',
    'common/materials.xml',
    'common/skybox.xml', 'common/visual.xml'])
def test_assets_are_verbatim_copies(name):
  with open(os.path.join(common.ASSETS_DIR, name), 'rb') as f:
    ours = f.read()
  with open(os.path.join(_JAX_ASSETS, name), 'rb') as f:
    assert ours == f.read()


def test_port_reads_no_file_of_the_jax_package():
  """The assets directory lies inside the port, and no module of the port
  names the JAX package's asset path."""
  assert os.path.commonpath([common.ASSETS_DIR, _PORT]) == _PORT
  assert sorted(common.read_assets()) == sorted(
      f'{p}common/{n}' for p in ('', './')
      for n in ('materials.xml', 'skybox.xml', 'visual.xml'))
  for root, _, files in os.walk(_PORT):
    for name in files:
      if name.endswith(('.py', '.cu')):
        with open(os.path.join(root, name)) as f:
          src = f.read()
        assert "'dm_control_tpu'" not in src, name
        assert 'dm_control_tpu/suite/assets' not in src, name
