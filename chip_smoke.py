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
     their edges), at every n the suite's models give it, {1, 2, 3, 4, 7,
     9, 22, 28}, at B = 16384 and 4096, float32 and float64, with diagonals
     spanning 1e-6..1, and on a ragged batch at a misaligned address, a
     batch with singular (floored) pivots and a batch with NaN above the
     diagonals; time kernel, plain version and the library's Cholesky
     solve in turns at the main paths' shapes (humanoid B = 4096, n = 27;
     cartpole B = 16384, n = 2; cheetah and walker B = 4096, n = 9;
     quadruped.fetch B = 4096, n = 28; quadruped walk and run B = 4096,
     n = 22): the kernel with the card held by a sleep kernel while the
     host queues the calls (the card's time) and back to back, the other
     two back to back;
  3. drive the main paths on the card through suite.load and
     BatchedEnvironment.reset/rollout_random, float32: humanoid.run at
     4096 envs x 5 Euler substeps, cartpole.swingup at 16384 envs x 1 RK4
     substep, cheetah.run at 4096 envs (its reset settles for 200 steps)
     walker.walk at 4096 envs x 10 substeps and quadruped.fetch at 4096
     envs x 4 substeps; count the kernel's launches in each rollout,
     report active contacts and live constraint rows per env, check the
     outputs and hold the kernel against its plain version on each path's
     own mass matrices; for quadruped.fetch count the CUDA kernel launches
     of one substep and of its MPR group alone (torch.profiler);
  4. check one control step on the card against the same step on the CPU
     (where the solve is the plain version) at 4 envs in float64, for
     humanoid, the six domains of the RK4/energy slice and quadruped walk
     and fetch.
The last three lines are a JSON line of per-kernel numbers, the card's
name and power limit, and {"ok": true, "device": {...}}.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROLLOUT_STEPS = 20
# (domain, task, envs, substeps, nv) of each main path
PATHS = (('humanoid', 'run', 4096, 5, 27),
         ('cartpole', 'swingup', 16384, 1, 2),
         ('cheetah', 'run', 4096, 1, 9),
         ('walker', 'walk', 4096, 10, 9),
         ('quadruped', 'fetch', 4096, 4, 28))
SWEEP_BATCH = 4096
SWEEP_N = (1, 8, 16, 27, 28, 31, 32, 33, 64)
# every n the suite's ported models give the kernel: pendulum, cartpole
# and acrobot, two and three poles, hopper, cheetah and walker, quadruped
# walk and run, quadruped fetch
SUITE_N = (1, 2, 3, 4, 7, 9, 22, 28)
SUITE_BATCHES = (16384, 4096)
HUMANOID_NV = 27
# (batch, n) timed: humanoid's, cartpole's, cheetah's and walker's,
# quadruped fetch's, quadruped walk's and run's
TIMED_SHAPES = ((4096, 27), (16384, 2), (4096, 9), (4096, 28), (4096, 22))
# the domains whose control step is held card against CPU
STEP_DOMAINS = (('humanoid', 'run'), ('cartpole', 'swingup'),
                ('acrobot', 'swingup'), ('pendulum', 'swingup'),
                ('cheetah', 'run'), ('walker', 'walk'), ('hopper', 'hop'),
                ('quadruped', 'walk'), ('quadruped', 'fetch'))
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


def profiled_launches(fn):
  """(CUDA kernels the card ran, kernel launch calls the host made) in one
  call of fn, by torch.profiler."""
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  events = prof.events()
  kernels = sum(1 for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA)
  calls = sum(1 for e in events if e.name.startswith(
      ('cudaLaunchKernel', 'cuLaunchKernel')))
  return kernels, calls


def mpr_launches(m, data):
  """CUDA launches of one physics substep of the batch and of its MPR
  narrowphase groups alone."""
  import functools
  from dm_control_tpu_torch.ops import collision
  from dm_control_tpu_torch.ops import forward as forward_ops
  from dm_control_tpu_torch.ops import mpr
  groups = [(fn, g1, g2) for fn, g1, g2, _ in collision._plan(m)[0]
            if isinstance(fn, functools.partial) and fn.func is mpr.collide]

  def substep():
    forward_ops.step_batched(m, data, compute_sensors=False)

  def mpr_only():
    for fn, g1, g2 in groups:
      fn(data.geom_xpos[:, g1], data.geom_xmat[:, g1], m.geom_size[g1],
         data.geom_xpos[:, g2], data.geom_xmat[:, g2], m.geom_size[g2])

  substep()
  mpr_only()
  return profiled_launches(substep), profiled_launches(mpr_only), len(groups)


def drive_path(domain, task, envs, n_sub, nv, card, timing):
  """Builds `domain.task` on the card (float32), resets `envs` envs and
  runs rollout_random for ROLLOUT_STEPS control steps; checks the outputs
  and the kernel on the path's own mass matrices. Returns the path's
  numbers for the kernels line."""
  from dm_control_tpu_torch import suite
  from dm_control_tpu_torch.models import constants
  from dm_control_tpu_torch.ops import constraint
  from dm_control_tpu_torch.ops import cuda_kernels
  from dm_control_tpu_torch.ops import forward as forward_ops
  from dm_control_tpu_torch.ops import linalg
  from dm_control_tpu_torch.parallel import BatchedEnvironment

  name = f'{domain}.{task}'
  t0 = time.perf_counter()
  # no device argument: the entry points build on the card by default
  env = suite.load(domain, task, dtype=torch.float32)
  torch.cuda.synchronize()
  build_s = time.perf_counter() - t0
  m = env.model
  if m.device.type != 'cuda':
    raise RuntimeError(f'suite.load built {name} off the card')
  if env.n_sub_steps != n_sub or m.nv != nv:
    raise RuntimeError(f'unexpected {name} configuration: '
                       f'{env.n_sub_steps} substeps, nv {m.nv}')
  benv = BatchedEnvironment(m, env.task, batch_size=envs,
                            n_sub_steps=env.n_sub_steps, seed=0)
  cuda_kernels.chol_solve_cuda.launches = 0
  t0 = time.perf_counter()
  obs = benv.reset()
  torch.cuda.synchronize()
  reset_s = time.perf_counter() - t0
  reset_launches = cuda_kernels.chol_solve_cuda.launches
  for k, v in obs.items():
    if v.shape[0] != envs or not torch.isfinite(v).all():
      raise RuntimeError(f'{name}: bad initial observation {k}')
  print(f'[3] {name}: model build {build_s:.2f} s, reset of {envs} envs '
        f'{reset_s:.2f} s ({reset_launches} chol_solve launches); nv {m.nv}, '
        f'{m.nefc_max} constraint rows, {m.ncon_sel} contact slots, '
        f'n_sub_steps {env.n_sub_steps}, integrator '
        f'{constants.IntegratorType(int(m.opt.integrator)).name}', flush=True)
  cuda_kernels.chol_solve_cuda.launches = 0
  t0 = time.perf_counter()
  data, total = benv.rollout_random(ROLLOUT_STEPS)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = cuda_kernels.chol_solve_cuda.launches
  diverged = data.divergence
  rate = envs * ROLLOUT_STEPS / wall
  reward = total.mean().item() / ROLLOUT_STEPS
  print(f'[3] {name} rollout_random({ROLLOUT_STEPS}) x {envs} envs: '
        f'{wall:.3f} s, {rate:.1f} env-steps/s (smoke reading, first '
        f'rollout, eager; {card}); chol_solve launches {launches} '
        f'({launches / (ROLLOUT_STEPS * n_sub):.2f} a substep); diverged '
        f'envs {int(diverged.sum())}; reward per env-step: mean '
        f'{reward:.4f}; peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB', flush=True)
  if launches == 0:
    raise RuntimeError(f'the {name} rollout never launched the kernel')
  step_ms = wall * 1e3 / ROLLOUT_STEPS
  held = timing.get((envs, nv, torch.float32))
  if held is None:
    share = 'not timed at this shape'
  else:
    card_ms = launches / ROLLOUT_STEPS * held['ms']
    share = (f'{card_ms:.4f} ms of the card a control step, '
             f'{100 * card_ms / step_ms:.3f} % of it (held time at '
             f'B={envs} n={nv})')
  con = data.contact
  ncon = con.active.sum(dim=-1).float()
  live_rows = (constraint.make_rows(m, data).slot_active > 0).sum(
      dim=-1).float()
  overflow = int(con.overflow.sum())
  print(f'[3] {name}: {step_ms:.1f} ms a control step; the kernel: {share}; '
        f'per env at the end: active contacts mean {ncon.mean():.2f} max '
        f'{int(ncon.max())}, live constraint rows mean {live_rows.mean():.2f} '
        f'max {int(live_rows.max())} of {m.nefc_max}; contact.overflow in '
        f'{overflow} '
        f'envs', flush=True)
  extra = {}
  if domain == 'quadruped':
    (sub_k, sub_c), (mpr_k, mpr_c), n_groups = mpr_launches(m, data)
    print(f'[3] {name}: torch.profiler, one substep of {envs} envs: '
          f'{sub_k} CUDA kernels ({sub_c} launch calls); its {n_groups} MPR '
          f'group(s) alone: {mpr_k} kernels ({mpr_c} launch calls); the '
          f'substep without them: {sub_k - mpr_k} kernels', flush=True)
    extra = dict(substep_kernels=sub_k, mpr_kernels=mpr_k)
  if not torch.isfinite(total).all():
    raise RuntimeError(f'{name}: non-finite rewards')
  if total.shape != (envs,) or not ((total >= 0) &
                                    (total <= ROLLOUT_STEPS)).all():
    raise RuntimeError(f'{name}: rewards outside [0, steps]')
  live = ~diverged
  outputs = dict(qpos=data.qpos, qvel=data.qvel, **env.task.get_observation(
      m, data))
  if m.opt.enableflags & constants.EnableBit.ENERGY:
    outputs['energy'] = data.energy
  for k, v in outputs.items():
    if not torch.isfinite(v[live]).all():
      raise RuntimeError(f'{name}: non-finite {k} outside diverged envs')
  # the kernel on the main path's own systems: M qacc = qfrc_smooth
  d = forward_ops.forward_batched(m, data, compute_sensors=False)
  qfrc = d.qfrc_smooth.contiguous()
  got = cuda_kernels.chol_solve_cuda(d.qM.contiguous(), qfrc)
  want = linalg.chol_solve_plain(d.qM, qfrc)
  torch.cuda.synchronize()
  abs_err = (got - want).abs().max().item()
  rel = rel_err(got, want)
  print(f'[3] {name}: kernel vs plain on the rollout\'s mass matrices '
        f'{tuple(d.qM.shape)}: max abs err {abs_err:.3e}, max rel err '
        f'{rel:.3e} (tol {TOL[torch.float32]:.0e}); finite: '
        f'{", ".join(outputs)}', flush=True)
  if not rel <= TOL[torch.float32]:
    raise RuntimeError(f'kernel disagrees with plain on {name}')
  return dict(envs=envs, substeps=n_sub, build_s=build_s, reset_s=reset_s,
              reset_launches=reset_launches, env_steps_per_s=rate,
              control_step_ms=step_ms, launches=launches,
              reward_per_step=reward, max_abs_err=abs_err,
              contacts_mean=ncon.mean().item(),
              live_rows_mean=live_rows.mean().item(), overflow_envs=overflow,
              **extra)


def step_card_vs_cpu(domain, task):
  """One control step of 4 envs, float64, on the card and on the CPU from
  the card's reset state: qpos, qvel (relative to max(1, |x|)),
  observations and reward within STEP_TOL."""
  from dm_control_tpu_torch import suite
  from dm_control_tpu_torch.parallel import BatchedEnvironment
  env64 = suite.load(domain, task, device='cuda', dtype=torch.float64)
  envc = suite.load(domain, task, device='cpu', dtype=torch.float64)
  n_sub = env64.n_sub_steps
  b_gpu = BatchedEnvironment(env64.model, env64.task, batch_size=4,
                             n_sub_steps=n_sub, seed=3)
  b_cpu = BatchedEnvironment(envc.model, envc.task, batch_size=4,
                             n_sub_steps=n_sub, seed=3)
  b_gpu.reset()
  state = {k: v.cpu() for k, v in b_gpu.state.items()}
  actions = torch.rand((4, envc.model.nu), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(5)) * 2 - 1
  s_gpu, o_gpu, r_gpu, _, _ = b_gpu.step_core(
      {k: v.to('cuda') for k, v in state.items()}, actions.to('cuda'))
  s_cpu, o_cpu, r_cpu, _, _ = b_cpu.step_core(state, actions)
  rel = lambda a, b: ((a.cpu() - b).abs() / b.abs().clamp_min(1.0)).max(
  ).item()
  worst = max([rel(s_gpu[k], s_cpu[k]) for k in ('qpos', 'qvel')] +
              [rel(o_gpu[k], o_cpu[k]) for k in o_cpu] +
              [(r_gpu.cpu() - r_cpu).abs().max().item()])
  print(f'[4] {domain}.{task}: one control step ({n_sub} substeps), card vs '
        f'CPU, float64, 4 envs: max err {worst:.3e} (tol {STEP_TOL:.0e})',
        flush=True)
  if not worst <= STEP_TOL:
    raise RuntimeError(f'{domain}.{task}: control step on the card '
                       'disagrees with the CPU')


def time_shape(rng, batch, n, dtype, cycles_per_ms, card):
  """Kernel, plain version and library at one shape, in turns."""
  H = torch.as_tensor(random_spd(rng, batch, n), dtype=dtype, device='cuda')
  g = torch.as_tensor(rng.standard_normal((batch, n)), dtype=dtype,
                      device='cuda')
  from dm_control_tpu_torch.ops import cuda_kernels
  from dm_control_tpu_torch.ops import linalg
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
  bound, bound_by = bound_ms(batch, n, dtype)
  out = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
             library_ms=(l1 + l2) / 2, bound_ms=bound, bound_by=bound_by,
             host_paced_ms=host)
  print(f'[2] time at B={batch} n={n} {str(dtype)[6:]}: '
        f'kernel {k1:.4f}, {k2:.4f} ms (card held); library {l1:.4f}, '
        f'{l2:.4f} ms (back to back; rel err vs plain {lib_err:.1e}); plain '
        f'{p1:.4f}, {p2:.4f} ms (back to back); bound {bound:.5f} ms '
        f'({bound_by}); kernel at {100 * bound / out["ms"]:.1f}% of the '
        f'bound; kernel back to back {host:.4f} ms (CUDA events, L2-warm; '
        f'{card})', flush=True)
  return out


def main():
  # ---- phase 0 ----
  if not torch.cuda.is_available():
    raise SystemExit('chip_smoke: CUDA is not available (needs one NVIDIA '
                     'GPU); nothing was run')
  from dm_control_tpu_torch.ops import cuda_kernels
  from dm_control_tpu_torch.ops import linalg

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
    cases += [(f'B={batch} n={n:2d} (suite)', random_spd(rng, batch, n), 0)
              for batch in SUITE_BATCHES for n in SUITE_N]
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
  for batch, n in TIMED_SHAPES:
    for dtype in (torch.float32, torch.float64):
      timing[batch, n, dtype] = time_shape(rng, batch, n, dtype,
                                           cycles_per_ms, card)

  # ---- phase 3 ----
  paths = {}
  for domain, task, envs, n_sub, nv in PATHS:
    paths[f'{domain}.{task}'] = drive_path(domain, task, envs, n_sub, nv,
                                           card, timing)

  # ---- phase 4 ----
  for domain, task in STEP_DOMAINS:
    step_card_vs_cpu(domain, task)

  def shape_entry(batch, n):
    f32, f64 = timing[batch, n, torch.float32], timing[batch, n,
                                                       torch.float64]
    return dict(batch=batch, n=n,
                variant=cuda_kernels.chol_solve_variant(n), **f32,
                **{f'{k}_f64': v for k, v in f64.items()})

  # the top-level times are at humanoid's shape, as in earlier versions of
  # this line; `shapes` holds every timed shape, that one first
  print(json.dumps({'kernels': [{
      'name': 'chol_solve', 'route': 'cuda',
      'source': 'dm_control_tpu_torch/csrc/chol_solve.cu',
      'replaces': 'dm_control_tpu/ops/pallas_kernels.py:40',
      **shape_entry(SWEEP_BATCH, HUMANOID_NV),
      'launches': sum(p['launches'] for p in paths.values()),
      'max_abs_err': max(p['max_abs_err'] for p in paths.values()),
      'paths': paths,
      'shapes': [shape_entry(b, n) for b, n in TIMED_SHAPES]}]}))
  print(card)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind,
      'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
  main()
