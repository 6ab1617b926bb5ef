"""Times the port's constraint solver against another tree's, on one card.

Usage, from the root of a checkout, on a host with a CUDA card:

    python3 time_solver.py OTHER/dm_control_tpu_torch/ops/constraint.py \
        [--envs 4096] [--repeats 5]

Loads OTHER's ops/constraint.py as a second module beside this checkout's
(it runs on this checkout's other modules), drives humanoid.run and
quadruped.fetch (pyramidal contacts, joint limits; fetch's equality
rows) for a few control steps on the card in float32 to reach states with
live contacts, and solves one substep's constraints of that state with
both. Their outputs (qacc, qfrc_constraint, efc_force, the contact
forces, the iteration count) must be torch.equal. Then it times each
solver in turns (this, other, other, this, repeated) by CUDA events
around a call that ends synchronized (the solver syncs on every Newton
iteration: the times are the host's pace of the launches). Prints a line
per model, the card's name and power limit, and a JSON line last.
"""

import argparse
import importlib.util
import json

import torch

import chip_smoke
from dm_control_tpu_torch import suite
from dm_control_tpu_torch.ops import constraint
from dm_control_tpu_torch.ops import forward
from dm_control_tpu_torch.parallel import BatchedEnvironment

# (domain, task, control steps of random actions before the solve)
MODELS = (('humanoid', 'run', 5), ('quadruped', 'fetch', 3))


def load_other(path):
  spec = importlib.util.spec_from_file_location('other_constraint', path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def solver_input(domain, task, envs, steps):
  """The model and a Data ready for the constraint solve: the state after
  `steps` control steps of random actions, through the smooth
  acceleration."""
  env = suite.load(domain, task, dtype=torch.float32)
  m = env.model
  benv = BatchedEnvironment(m, env.task, batch_size=envs,
                            n_sub_steps=env.n_sub_steps, seed=0)
  benv.reset()
  data, _ = benv.rollout_random(steps)
  return m, forward.fwd_acceleration_batched(m, forward.fwd_actuation(m, data))


def timed(solve, m, d):
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda.synchronize()
  start.record()
  out = solve(m, d)
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end), out


def main():
  parser = argparse.ArgumentParser()
  parser.add_argument('other')
  parser.add_argument('--envs', type=int, default=4096)
  parser.add_argument('--repeats', type=int, default=5)
  args = parser.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit('time_solver: CUDA is not available')
  card = chip_smoke.card_line()
  other = load_other(args.other)
  solvers = {'this': constraint.fwd_constraint_batched,
             'other': other.fwd_constraint_batched}
  results = {}
  for domain, task, steps in MODELS:
    name = f'{domain}.{task}'
    m, d = solver_input(domain, task, args.envs, steps)
    outs = {k: timed(f, m, d)[1] for k, f in solvers.items()}
    for field in ('qacc', 'qfrc_constraint', 'efc_force', 'solver_niter'):
      if not torch.equal(getattr(outs['this'], field),
                         getattr(outs['other'], field)):
        raise RuntimeError(f'{name}: {field} differs between the solvers')
    if not torch.equal(outs['this'].contact.force, outs['other'].contact.force):
      raise RuntimeError(f'{name}: contact forces differ between the solvers')
    times = {k: [] for k in solvers}
    for _ in range(args.repeats):
      for k in ('this', 'other', 'other', 'this'):
        times[k].append(timed(solvers[k], m, d)[0])
    median = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    live = (constraint.make_rows(m, d).slot_active > 0).sum(-1).float()
    results[name] = dict(envs=args.envs, niter=int(outs['this'].solver_niter[0]),
                         live_rows_mean=live.mean().item(),
                         ms_this=times['this'], ms_other=times['other'],
                         median_this=median['this'],
                         median_other=median['other'])
    print(f'{name}, {args.envs} envs, {results[name]["niter"]} Newton '
          f'iterations, live rows a env {live.mean().item():.2f}: outputs '
          f'torch.equal; ms a solve, median of {2 * args.repeats}: this '
          f'{median["this"]:.3f}, other {median["other"]:.3f} (this '
          f'{", ".join(f"{t:.3f}" for t in times["this"])}; other '
          f'{", ".join(f"{t:.3f}" for t in times["other"])}; {card})',
          flush=True)
  print(card)
  print(json.dumps(results))


if __name__ == '__main__':
  main()
