"""Smoke run of the PyTorch port on one NVIDIA GPU.

Usage, from the root of a checkout, on a host with one CUDA card and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  0. require CUDA; print the card's name and power limit (nvidia-smi);
  1. build the CUDA kernel (dm_control_tpu_torch/csrc/chol_solve.cu);
  2. compare the kernel with its plain PyTorch version on the card at
     B = 4096, n in {1, 8, 27, 32, 64}, float32 and float64, with
     diagonals spanning 1e-6..1; time both at humanoid's shape;
  3. drive humanoid.run at 4096 envs x 5 substeps on the card through
     BatchedEnvironment.reset/rollout_random, count the kernel's launches
     during the rollout and check the outputs;
  4. check one control step on the card against the same step on the CPU
     (where the solve is the plain version) at a small batch in float64.
The last two lines are a JSON line of per-kernel numbers and
{"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

ROLLOUT_ENVS = 4096
ROLLOUT_STEPS = 20
SWEEP_BATCH = 4096
# relative error bounds, kernel vs plain version (max over each system of
# |x_kernel - x_plain| / max |x_plain|): both factor the same Jacobi-scaled
# matrix, so they differ by rounding in another summation order
TOL = {torch.float32: 1e-3, torch.float64: 1e-10}
# a control step on the card vs the CPU, float64: the Newton solver stops
# at the model tolerance, so the two agree to about that
STEP_TOL = 1e-6


def card_line() -> str:
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, check=True,
      timeout=60)
  return out.stdout.strip().splitlines()[0]


def random_spd(rng, batch, n, diag_lo=1e-6, diag_hi=1.0):
  """SPD matrices whose diagonals span [diag_lo, diag_hi]."""
  A = rng.standard_normal((batch, n, n))
  C = A @ np.swapaxes(A, -1, -2) / n + np.eye(n)
  dc = np.sqrt(np.diagonal(C, axis1=-2, axis2=-1))
  C = C / dc[..., :, None] / dc[..., None, :]
  s = np.sqrt(np.exp(rng.uniform(np.log(diag_lo), np.log(diag_hi),
                                 (batch, n))))
  return C * s[..., :, None] * s[..., None, :]


def rel_err(got, want):
  return ((got - want).abs().amax(-1) /
          want.abs().amax(-1).clamp_min(1e-30)).max().item()


def time_ms(fn, iters):
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  fn()
  torch.cuda.synchronize()
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def main():
  # ---- phase 0 ----
  if not torch.cuda.is_available():
    raise SystemExit('chip_smoke: CUDA is not available (needs one NVIDIA '
                     'GPU); nothing was run')
  from dm_control_tpu_torch.ops import cuda_kernels
  from dm_control_tpu_torch.ops import forward as forward_ops
  from dm_control_tpu_torch.ops import linalg
  from dm_control_tpu_torch import suite
  from dm_control_tpu_torch.parallel import BatchedEnvironment

  dev = torch.device('cuda')
  card = card_line()
  kind = torch.cuda.get_device_name(0)
  print(f'[0] card: {card}; torch {torch.__version__}, CUDA '
        f'{torch.version.cuda}, python {sys.version.split()[0]}', flush=True)

  # ---- phase 1 ----
  path, seconds, log = cuda_kernels.build_chol_solve(verbose=True)
  print(f'[1] built {path} in {seconds:.2f} s', flush=True)
  for line in log.splitlines():
    if 'registers' in line or 'smem' in line or 'spill' in line:
      print(f'    ptxas: {line.strip()}')

  # ---- phase 2 ----
  rng = np.random.default_rng(0)
  for dtype in (torch.float32, torch.float64):
    for n in (1, 8, 27, 32, 64):
      H = torch.as_tensor(random_spd(rng, SWEEP_BATCH, n), dtype=dtype,
                          device=dev)
      g = torch.as_tensor(rng.standard_normal((SWEEP_BATCH, n)),
                          dtype=dtype, device=dev)
      got = cuda_kernels.chol_solve_cuda(H, g)
      want = linalg.chol_solve_plain(H, g)
      torch.cuda.synchronize()
      err = rel_err(got, want)
      ok = bool(torch.isfinite(got).all()) and err <= TOL[dtype]
      print(f'[2] B={SWEEP_BATCH} n={n:2d} {str(dtype)[6:]}: max rel err '
            f'{err:.3e} (tol {TOL[dtype]:.0e}) {"ok" if ok else "FAIL"}',
            flush=True)
      if not ok:
        raise RuntimeError(f'kernel disagrees with plain at n={n} {dtype}')
  H = torch.as_tensor(random_spd(rng, SWEEP_BATCH, 27), dtype=torch.float32,
                      device=dev)
  g = torch.as_tensor(rng.standard_normal((SWEEP_BATCH, 27)),
                      dtype=torch.float32, device=dev)
  kern = lambda: cuda_kernels.chol_solve_cuda(H, g)
  plain = lambda: linalg.chol_solve_plain(H, g)
  p1 = time_ms(plain, 20)
  k1 = time_ms(kern, 200)
  k2 = time_ms(kern, 200)
  p2 = time_ms(plain, 20)
  kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
  print(f'[2] time at B={SWEEP_BATCH} n=27 float32: kernel {kernel_ms:.4f} '
        f'ms, plain {plain_ms:.4f} ms (CUDA events; {card})', flush=True)

  # ---- phase 3 ----
  t0 = time.perf_counter()
  env = suite.load('humanoid', 'run', device=dev, dtype=torch.float32)
  benv = BatchedEnvironment(env.model, env.task, batch_size=ROLLOUT_ENVS,
                            n_sub_steps=env.n_sub_steps, seed=0)
  obs = benv.reset()
  torch.cuda.synchronize()
  print(f'[3] humanoid.run model + reset of {ROLLOUT_ENVS} envs on the card: '
        f'{time.perf_counter() - t0:.2f} s; n_sub_steps={env.n_sub_steps}',
        flush=True)
  if env.n_sub_steps != 5 or obs['velocity'].shape != (ROLLOUT_ENVS, 27):
    raise RuntimeError('unexpected humanoid.run configuration')
  cuda_kernels.chol_solve_cuda.launches = 0
  t0 = time.perf_counter()
  data, total = benv.rollout_random(ROLLOUT_STEPS)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = cuda_kernels.chol_solve_cuda.launches
  diverged = data.divergence
  print(f'[3] rollout_random({ROLLOUT_STEPS}) x {ROLLOUT_ENVS} envs: '
        f'{wall:.3f} s, {ROLLOUT_ENVS * ROLLOUT_STEPS / wall:.1f} env-steps/s '
        f'(smoke reading, first rollout, eager; {card}); chol_solve launches '
        f'{launches}; diverged envs {int(diverged.sum())}; peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB', flush=True)
  if launches == 0:
    raise RuntimeError('the rollout never launched the chol_solve kernel')
  if not torch.isfinite(total).all():
    raise RuntimeError('non-finite rewards')
  if not torch.isfinite(data.qpos[~diverged]).all():
    raise RuntimeError('non-finite qpos outside diverged envs')
  if total.shape != (ROLLOUT_ENVS,) or not ((total >= 0) &
                                            (total <= ROLLOUT_STEPS)).all():
    raise RuntimeError('rewards outside [0, steps]')
  print(f'[3] reward per env-step: mean {total.mean().item() / ROLLOUT_STEPS:.4f}',
        flush=True)
  # the kernel on the main path's own systems: M qacc = qfrc_smooth
  d = forward_ops.forward_batched(env.model, data, compute_sensors=False)
  qfrc = d.qfrc_smooth.contiguous()
  got = cuda_kernels.chol_solve_cuda(d.qM.contiguous(), qfrc)
  want = linalg.chol_solve_plain(d.qM, qfrc)
  torch.cuda.synchronize()
  main_abs = (got - want).abs().max().item()
  main_rel = rel_err(got, want)
  print(f'[3] kernel vs plain on the rollout\'s mass matrices '
        f'{tuple(d.qM.shape)}: max abs err {main_abs:.3e}, max rel err '
        f'{main_rel:.3e} (tol {TOL[torch.float32]:.0e})', flush=True)
  if not main_rel <= TOL[torch.float32]:
    raise RuntimeError('kernel disagrees with plain on the main path')

  # ---- phase 4 ----
  env64 = suite.load('humanoid', 'run', device=dev, dtype=torch.float64)
  envc = suite.load('humanoid', 'run', device='cpu', dtype=torch.float64)
  b_gpu = BatchedEnvironment(env64.model, env64.task, batch_size=4,
                             n_sub_steps=5, seed=3)
  b_cpu = BatchedEnvironment(envc.model, envc.task, batch_size=4,
                             n_sub_steps=5, seed=3)
  b_gpu.reset()
  state = {k: v.cpu() for k, v in b_gpu.state.items()}
  actions = torch.rand((4, envc.model.nu), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(5)) * 2 - 1
  s_gpu, o_gpu, r_gpu, _, _ = b_gpu.step_core(
      {k: v.to(dev) for k, v in state.items()}, actions.to(dev))
  s_cpu, o_cpu, r_cpu, _, _ = b_cpu.step_core(state, actions)
  worst = max(
      ((s_gpu[k].cpu() - s_cpu[k]).abs() /
       s_cpu[k].abs().clamp_min(1.0)).max().item()
      for k in ('qpos', 'qvel'))
  worst = max(worst, ((r_gpu.cpu() - r_cpu).abs().max().item()))
  print(f'[4] one control step, card vs CPU, float64, 4 envs: max err '
        f'{worst:.3e} (tol {STEP_TOL:.0e})', flush=True)
  if not worst <= STEP_TOL:
    raise RuntimeError('control step on the card disagrees with the CPU')

  print(json.dumps({'kernels': [{
      'name': 'chol_solve', 'route': 'cuda',
      'source': 'dm_control_tpu_torch/csrc/chol_solve.cu',
      'replaces': 'dm_control_tpu/ops/pallas_kernels.py:40',
      'launches': launches, 'max_abs_err': main_abs,
      'ms': kernel_ms, 'plain_ms': plain_ms}]}))
  print(card)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind,
      'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
  main()
