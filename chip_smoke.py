"""Smoke run of the PyTorch port on one NVIDIA GPU.

Usage, from the root of a checkout, on a host with one CUDA card and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  0. require CUDA; print the card's name and power limit (nvidia-smi);
  1. build the CUDA kernel (dm_control_tpu_torch/csrc/chol_solve.cu) and
     print ptxas's registers, stack frame and spills for each variant;
     the register variant must have neither stack nor spills;
  2. compare the kernel with its plain PyTorch version on the card at
     B = 4096, n in {1, 8, 16, 27, 28, 31, 32, 33, 64} (both variants and
     their edges), float32 and float64, with diagonals spanning 1e-6..1,
     and on a ragged batch at a misaligned address, a batch with singular
     (floored) pivots and a batch with NaN above the diagonals; time
     kernel, plain version and the library's Cholesky solve in turns at
     humanoid's shape, float32 and float64: the kernel with the card held
     by a sleep kernel while the host queues the calls (the card's time)
     and back to back, the other two back to back;
  3. drive humanoid.run at 4096 envs x 5 substeps on the card through
     BatchedEnvironment.reset/rollout_random, count the kernel's launches
     during the rollout and check the outputs;
  4. check one control step on the card against the same step on the CPU
     (where the solve is the plain version) at a small batch in float64.
The last two lines are a JSON line of per-kernel numbers and
{"ok": true, "device": {...}}.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROLLOUT_ENVS = 4096
ROLLOUT_STEPS = 20
SWEEP_BATCH = 4096
SWEEP_N = (1, 8, 16, 27, 28, 31, 32, 33, 64)
HUMANOID_NV = 27
# relative error bounds, kernel vs plain version (max over each system of
# |x_kernel - x_plain| / max |x_plain|): both factor the same Jacobi-scaled
# matrix, so they differ by rounding in another summation order
TOL = {torch.float32: 1e-3, torch.float64: 1e-10}
# peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): HBM bytes/s
# and FLOP/s outside the tensor cores per type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
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


def ptxas_report(log):
  """[(kernel, registers, stack bytes, spill store bytes, spill load
  bytes)] per entry function of nvcc -Xptxas -v output; kernel reads e.g.
  'chol_solve_reg_kernel<f, 32>'."""
  out, entry, props_for, frame = [], None, None, None
  for line in log.splitlines():
    m = re.search(r"Compiling entry function '(\w+)'", line)
    if m:
      entry, frame = m.group(1), None
    m = re.search(r'Function properties for (\w+)', line)
    if m:
      props_for = m.group(1)
    m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                  r'(\d+) bytes spill loads', line)
    if m and entry and props_for == entry:
      frame = tuple(int(v) for v in m.groups())
    m = re.search(r'Used (\d+) registers', line)
    if m and entry and frame:
      t = re.search(r'(chol_solve_(?:reg|smem)_kernel)I([fd])(?:Li(\d+)E)?E',
                    entry)
      name = (f'{t.group(1)}<{t.group(2)}' +
              (f', {t.group(3)}>' if t.group(3) else '>')) if t else entry
      out.append((name, int(m.group(1))) + frame)
      entry, frame = None, None
  return out


def bound_ms(batch, n, dtype):
  """Least time for B solves on the card: the bytes the function needs
  (the lower triangle of H, n (n + 1) / 2 elements, and g, each read
  once, and x written once) over the memory rate, or the work (the
  factor's n^3/3 multiply-adds, n^2 of the two substitutions, 2 n^2
  multiplies of the scaling) over the peak rate of the type; whichever is
  larger."""
  size = torch.finfo(dtype).bits // 8
  mem = batch * (n * (n + 1) // 2 + 2 * n) * size / PEAK_BYTES
  ops = batch * (2 * n ** 3 / 3 + 4 * n * n) / PEAK_FLOPS[dtype]
  return max(mem, ops) * 1e3, 'bytes' if mem >= ops else 'operations'


def host_ms(fn, iters):
  """ms per call by CUDA events around `iters` calls back to back: the
  slower of the card's work and the host's pace of queuing it."""
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


def sleep_cycles_per_ms():
  """Clock cycles of torch.cuda._sleep per ms on this card."""
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda._sleep(1000)
  start.record()
  torch.cuda._sleep(20_000_000)
  end.record()
  torch.cuda.synchronize()
  return 20_000_000 / start.elapsed_time(end)


def device_ms(fn, iters, cycles_per_ms):
  """ms per call of the card's own work, by CUDA events around `iters`
  calls that the host queues while a sleep kernel holds the card. The
  sleep lasts twice the host's time to queue the calls (measured first),
  and a reading counts only if the sleep was still running when the last
  call was queued; else the sleep is doubled and the reading taken again.
  Only for functions of few launches that never wait for the card: a full
  launch queue, or a call that synchronizes, makes the host wait, and
  then no sleep holds the card."""
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  held = torch.cuda.Event()
  fn()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(iters):
    fn()
  queue_ms = (time.perf_counter() - t0) * 1e3
  torch.cuda.synchronize()
  cycles = 2 * queue_ms * cycles_per_ms + 1e6
  for _ in range(4):
    torch.cuda._sleep(int(cycles))
    held.record()
    start.record()
    for _ in range(iters):
      fn()
    end.record()
    still_held = not held.query()
    torch.cuda.synchronize()
    if still_held:
      return start.elapsed_time(end) / iters
    cycles *= 2
  raise RuntimeError('the sleep never outlasted the host queuing the calls')


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
  path, seconds, log = cuda_kernels.build_chol_solve()
  print(f'[1] built {path} in {seconds:.2f} s', flush=True)
  report = ptxas_report(log)
  for name, regs, stack, spill_st, spill_ld in report:
    print(f'[1] ptxas {name}: {regs} registers, {stack} bytes stack frame, '
          f'{spill_st} bytes spill stores, {spill_ld} bytes spill loads')
  reg_variants = [r for r in report if r[0].startswith('chol_solve_reg')]
  if len(reg_variants) != 2 or any(r[2:] != (0, 0, 0) for r in reg_variants):
    raise RuntimeError('the register variant needs 2 kernels (float and '
                       'double, N = 28) with no stack frame and no spills')

  # ---- phase 2 ----
  rng = np.random.default_rng(0)
  for dtype in (torch.float32, torch.float64):
    cases = [(f'B={SWEEP_BATCH} n={n:2d}', random_spd(rng, SWEEP_BATCH, n),
              0) for n in SWEEP_N]
    # a ragged last block, from an address 1 element past an allocation
    # (not 16-byte aligned)
    cases.append(('B=4093 n=27 misaligned',
                  random_spd(rng, 4093, HUMANOID_NV), 1))
    # floored pivots: zero rows and columns (a massless dof) and zero
    # matrices; each pivot the floor meets is exactly 0 in any order
    sing = random_spd(rng, 512, HUMANOID_NV)
    sing[0::3, 5, :] = sing[0::3, :, 5] = 0
    sing[1::3, 0, :] = sing[1::3, :, 0] = 0
    sing[1::3, -1, :] = sing[1::3, :, -1] = 0
    sing[2::3] = 0
    cases.append(('B=512 n=27 singular', sing, 0))
    # NaN above every diagonal: the function reads only the lower triangle
    upper = random_spd(rng, SWEEP_BATCH, HUMANOID_NV)
    iu = np.triu_indices(HUMANOID_NV, 1)
    upper[:, iu[0], iu[1]] = np.nan
    cases.append((f'B={SWEEP_BATCH} n=27 upper NaN', upper, 0))
    for label, H_np, offset in cases:
      batch, n = H_np.shape[:2]
      flat = torch.empty(offset + H_np.size, dtype=dtype, device=dev)
      H = flat[offset:].view(batch, n, n)
      H.copy_(torch.as_tensor(H_np))
      g = torch.as_tensor(rng.standard_normal((batch, n)), dtype=dtype,
                          device=dev)
      got = cuda_kernels.chol_solve_cuda(H, g)
      want = linalg.chol_solve_plain(H, g)
      torch.cuda.synchronize()
      err = rel_err(got, want)
      ok = bool(torch.isfinite(got).all()) and err <= TOL[dtype]
      print(f'[2] {label} {str(dtype)[6:]} '
            f'({cuda_kernels.chol_solve_variant(n)}): max rel err {err:.3e} '
            f'(tol {TOL[dtype]:.0e}) {"ok" if ok else "FAIL"}', flush=True)
      if not ok:
        raise RuntimeError(f'kernel disagrees with plain: {label} {dtype}')
  timing = {}
  cycles_per_ms = sleep_cycles_per_ms()
  for dtype in (torch.float32, torch.float64):
    H = torch.as_tensor(random_spd(rng, SWEEP_BATCH, HUMANOID_NV),
                        dtype=dtype, device=dev)
    g = torch.as_tensor(rng.standard_normal((SWEEP_BATCH, HUMANOID_NV)),
                        dtype=dtype, device=dev)
    kern = lambda: cuda_kernels.chol_solve_cuda(H, g)
    plain = lambda: linalg.chol_solve_plain(H, g)
    # the library's batched Cholesky solve: a yardstick only, never called
    # by the port; it skips the Jacobi scaling and the pivot floor
    library = lambda: torch.cholesky_solve(
        g[..., None], torch.linalg.cholesky_ex(H).L)[..., 0]
    lib_err = rel_err(library(), plain())
    # the kernel: the card's time, held. No sleep holds the card for the
    # other two: the plain version issues hundreds of launches a call, more
    # than the launch queue holds, and the library's call waits for the
    # card within; both are timed back to back, at the host's pace
    p1 = host_ms(plain, 20)
    k1 = device_ms(kern, 200, cycles_per_ms)
    l1 = host_ms(library, 50)
    l2 = host_ms(library, 50)
    k2 = device_ms(kern, 200, cycles_per_ms)
    p2 = host_ms(plain, 20)
    host = host_ms(kern, 200)
    bound, bound_by = bound_ms(SWEEP_BATCH, HUMANOID_NV, dtype)
    timing[dtype] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                         library_ms=(l1 + l2) / 2, bound_ms=bound,
                         bound_by=bound_by, host_paced_ms=host)
    print(f'[2] time at B={SWEEP_BATCH} n={HUMANOID_NV} {str(dtype)[6:]}: '
          f'kernel {k1:.4f}, {k2:.4f} ms (card held); library {l1:.4f}, '
          f'{l2:.4f} ms (back to back; rel err vs plain {lib_err:.1e}); plain '
          f'{p1:.4f}, {p2:.4f} ms (back to back); bound {bound:.4f} ms '
          f'({bound_by}); kernel at {100 * bound / timing[dtype]["ms"]:.1f}% '
          f'of the bound; kernel back to back {host:.4f} ms (CUDA events, '
          f'L2-warm; {card})', flush=True)

  # ---- phase 3 ----
  t0 = time.perf_counter()
  # no device argument: the entry points build on the card by default
  env = suite.load('humanoid', 'run', dtype=torch.float32)
  if env.model.device.type != 'cuda':
    raise RuntimeError('suite.load built its model off the card')
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

  f32, f64 = timing[torch.float32], timing[torch.float64]
  print(json.dumps({'kernels': [{
      'name': 'chol_solve', 'route': 'cuda',
      'source': 'dm_control_tpu_torch/csrc/chol_solve.cu',
      'replaces': 'dm_control_tpu/ops/pallas_kernels.py:40',
      'variant': cuda_kernels.chol_solve_variant(HUMANOID_NV),
      'launches': launches, 'max_abs_err': main_abs, **f32,
      **{f'{k}_f64': v for k, v in f64.items()}}]}))
  print(card)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind,
      'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
  main()
