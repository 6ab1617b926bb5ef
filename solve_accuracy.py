"""How far float32 fixes the main paths' own Newton solves, on one CUDA card.

Usage, from the root of a checkout, on a host with a CUDA card and nvcc:

    python3 solve_accuracy.py [domain.task ...]

For each main path of chip_smoke.PATHS (or each one named), builds the
task on the card in float32, resets its envs and runs
chip_smoke.ROLLOUT_STEPS control steps of random actions, then records the
systems one more physics step hands the kernel
(chip_smoke.recorded_systems). For the Newton systems it prints the
forward error of the kernel's and of the plain version's float32 solution
against the float64 solve (max over envs of |x - x64| / max |x64|), the
env-systems where either exceeds chip_smoke.TOL and those among them where
the kernel's is the larger, the largest Jacobi-scaled condition number,
and kernel against plain. A JSON line of these numbers per path comes
last. chip_smoke.py gates on the backward error; this script says how far
any float32 solve of these systems can be held by its forward error.
"""

import json
import sys

import torch

import chip_smoke


def newton_accuracy(m, data):
  from dm_control_tpu_torch.ops import cuda_kernels
  from dm_control_tpu_torch.ops import linalg
  tol = chip_smoke.TOL[torch.float32]
  fwd_k, fwd_p, rel, cond = [], [], [], []
  inexact = worse = n_newton = 0
  for H, g, mass in chip_smoke.recorded_systems(m, data):
    if mass:
      continue
    n_newton += 1
    got = cuda_kernels.chol_solve_cuda(H, g)
    want = linalg.chol_solve_plain(H, g)
    exact = linalg.chol_solve_plain(H.double(), g.double())
    err_k = chip_smoke.env_rel_err(got.double(), exact)
    err_p = chip_smoke.env_rel_err(want.double(), exact)
    loose = ~((err_k <= tol) & (err_p <= tol))
    inexact += int(loose.sum())
    worse += int((loose & ~(err_k <= err_p)).sum())
    fwd_k.append(err_k)
    fwd_p.append(err_p)
    rel.append(chip_smoke.env_rel_err(got, want))
    cond.append(chip_smoke.scaled_condition(H))
  return dict(newton_systems=n_newton,
              forward_err_kernel=chip_smoke.worst(fwd_k),
              forward_err_plain=chip_smoke.worst(fwd_p),
              env_systems_above_tol=inexact, kernel_larger_in=worse,
              condition_max=chip_smoke.worst(cond),
              kernel_vs_plain=chip_smoke.worst(rel))


def main():
  if not torch.cuda.is_available():
    raise SystemExit('solve_accuracy: CUDA is not available')
  from dm_control_tpu_torch import suite
  from dm_control_tpu_torch.parallel import BatchedEnvironment
  card = chip_smoke.card_line()
  names = sys.argv[1:]
  out = {}
  for domain, task, envs, _, _ in chip_smoke.PATHS:
    name = f'{domain}.{task}'
    if names and name not in names:
      continue
    env = suite.load(domain, task, dtype=torch.float32)
    benv = BatchedEnvironment(env.model, env.task, batch_size=envs,
                              n_sub_steps=env.n_sub_steps, seed=0)
    benv.reset()
    data, _ = benv.rollout_random(chip_smoke.ROLLOUT_STEPS)
    res = newton_accuracy(env.model, data)
    out[name] = res
    print(f'{name} ({envs} envs, after {chip_smoke.ROLLOUT_STEPS} control '
          f'steps): {res["newton_systems"]} Newton systems; forward error '
          f'against the float64 solve: kernel '
          f'{res["forward_err_kernel"]:.3e}, plain '
          f'{res["forward_err_plain"]:.3e}; above '
          f'{chip_smoke.TOL[torch.float32]:.0e} in '
          f'{res["env_systems_above_tol"]} env-systems, the kernel\'s the '
          f'larger in {res["kernel_larger_in"]}; Jacobi-scaled condition '
          f'number max {res["condition_max"]:.3e}; kernel vs plain '
          f'{res["kernel_vs_plain"]:.3e} ({card})', flush=True)
  print(json.dumps({'card': card, 'paths': out}))


if __name__ == '__main__':
  main()
