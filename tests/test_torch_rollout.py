"""The port's batched humanoid.run environment on the CPU, and its
independence from JAX."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from dm_control_tpu_torch import suite
from dm_control_tpu_torch.parallel import BatchedEnvironment

# One intra-op thread: the batches here are tiny, and pytest-xdist workers
# share the host's cores, where a thread pool per worker only contends.
torch.set_num_threads(1)

_REPO =os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def env():
  return suite.load('humanoid', 'run', dtype=torch.float32)


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
  """Build humanoid with the port's own compiler and step it, with jax,
  dm_env and mujoco made unimportable."""
  code = textwrap.dedent("""
      import sys
      sys.modules['jax'] = sys.modules['dm_env'] = None
      sys.modules['mujoco'] = None
      import torch
      torch.set_num_threads(1)
      from dm_control_tpu_torch import suite
      from dm_control_tpu_torch.parallel import BatchedEnvironment
      env = suite.load('humanoid', 'run')
      benv = BatchedEnvironment(env.model, env.task, batch_size=2,
                                n_sub_steps=env.n_sub_steps)
      benv.reset()
      obs, reward, done = benv.step(torch.zeros(2, env.model.nu))
      assert torch.isfinite(reward).all(), reward
      assert not any(m == 'dm_control_tpu' or m.startswith('dm_control_tpu.')
                     for m in sys.modules)
      print('ok')
  """)
  proc = subprocess.run([sys.executable, '-c', code], cwd=_REPO,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip().endswith('ok')
