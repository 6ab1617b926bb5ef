"""Control suite of the port: the domains ported so far."""

from __future__ import annotations

import importlib

_DOMAINS = ('acrobot', 'ball_in_cup', 'cartpole', 'cheetah', 'finger', 'fish',
            'hopper', 'humanoid', 'humanoid_CMU', 'lqr', 'manipulator',
            'pendulum', 'point_mass', 'quadruped', 'reacher', 'stacker',
            'swimmer', 'walker')


def load(domain_name: str, task_name: str, **task_kwargs):
  """An Environment for `domain_name.task_name`, e.g. ('humanoid', 'run').

  task_kwargs go to the task factory (time_limit, device, dtype; lqr's
  also take `random`, the seed of the model's stiffnesses).
  """
  if domain_name not in _DOMAINS:
    raise NotImplementedError(f'domain {domain_name!r} is not ported; '
                              f'have {_DOMAINS}')
  module = importlib.import_module(f'dm_control_tpu_torch.suite.{domain_name}')
  return module.SUITE[task_name](**task_kwargs)
