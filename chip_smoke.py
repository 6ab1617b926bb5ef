"""Smoke run of the PyTorch port on one NVIDIA GPU.

Usage, from the root of a checkout, on a host with one CUDA card and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  0. require CUDA; print the card's name and power limit (nvidia-smi);
  1. build the CUDA kernel (dm_control_tpu_torch/csrc/chol_solve.cu) and
     print ptxas's registers, stack frame and spills for each variant;
     both variants (the register tile N = 28 and the block rows N = 64,
     each in float and double) must have neither stack nor spills;
  2. compare the kernel with its plain PyTorch version on the card at
     B = 4096, n in {1, 8, 16, 27, 28, 29, 31, 32, 33, 63, 64} (both
     variants and their edges), at every n the suite's models give it,
     {1, 2, 3, 4, 6, 7, 8, 9, 11, 13, 14, 17, 20, 22, 28, 62}, at
     B = 16384 and 4096,
     float32
     and float64, with diagonals spanning 1e-6..1, and, at n = 27 and 62,
     on a ragged batch at a misaligned address, a batch with singular
     (floored) pivots and a batch with NaN above the diagonals; time
     kernel, plain version and the library's Cholesky solve in turns at
     the main paths' shapes (humanoid B = 4096, n = 27; cartpole
     B = 16384, n = 2; cheetah and walker B = 4096, n = 9;
     quadruped.fetch B = 4096, n = 28; quadruped walk and run B = 4096,
     n = 22; humanoid_CMU B = 4096, n = 62, the block rows; swimmer6
     B = 4096, n = 8; finger B = 4096, n = 3; stacker.stack_4 B = 4096,
     n = 20): the kernel
     with the card held by a sleep kernel while the host queues the calls
     (the card's time) and back to back, the other two back to back;
  3. drive the main paths on the card through suite.load and
     BatchedEnvironment.reset/rollout_random, float32: humanoid.run at
     4096 envs x 5 Euler substeps, cartpole.swingup at 16384 envs x 1 RK4
     substep, cheetah.run at 4096 envs (its reset settles for 200 steps)
     walker.walk at 4096 envs x 10 substeps, quadruped.fetch at 4096
     envs x 4 substeps, humanoid_CMU.run at 4096 envs x 10 substeps, and,
     through BatchedEnvironment.step with a time limit of EPISODE control
     steps and staggered episode starts, so that every step auto-resets
     some envs (those must draw new target positions on the card and the
     others keep theirs), swimmer.swimmer6 at 4096 envs x 15 substeps,
     finger.turn_hard at 4096 envs x 2 substeps (elliptic cones, the
     hinge's frictionloss row) and stacker.stack_4 at 4096 envs x 10
     substeps (the box pairs; each reset draws the target's body_pos);
     count the kernel's launches in each
     rollout, the Newton iterations of each constraint solve and the envs
     with contact.overflow set at each control step (dropped contacts: a
     printed count, not a gate) and the rounds of each rejection-sampling
     reset, time the paths with auto-resets again
     without them (CORE_STEPS of step_core), report the envs still
     in contact after the reset, active contacts and live constraint rows
     per env, check the outputs and hold the kernel against its plain
     version on every system one more step of each path's end state
     solves (mass matrices and the Euler update at TOL; Newton Hessians
     by backward error, and at TOL where well conditioned); for
     quadruped.fetch, humanoid_CMU.run, swimmer.swimmer6,
     finger.turn_hard and stacker.stack_4 count the CUDA kernel launches
     of one substep and of its MPR groups alone (none in swimmer6 and
     stack_4) (torch.profiler);
  4. check one control step on the card against the same step on the CPU
     (where the solve is the plain version) at 4 envs in float64, for
     humanoid, the six domains of the RK4/energy slice, quadruped walk
     and fetch, humanoid_CMU, ball_in_cup, point_mass, fish, lqr, finger
     (spin, turn_easy, turn_hard), and the tasks that draw their model
     each episode (reacher easy and hard, point_mass.hard, fish.swim,
     swimmer6 and swimmer15, finger's turns, manipulator bring_ball,
     bring_peg, insert_ball and insert_peg, stacker stack_2 and stack_4),
     whose drawn leaves go from the card to the CPU with the state;
  5. read hopper.hop's touch observation over control steps on the card:
     it must see contact forces and change from step to step (the
     acceleration-stage sensors come from the last substep's solve).
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
# control steps of an episode on the paths with auto-resets (their time
# limit)
EPISODE = 8
# control steps of step_core alone (no resets) timed after such a path
CORE_STEPS = 5
# (domain, task, envs, substeps, nv, episode) of each main path; a path
# with an episode length runs BatchedEnvironment.step with auto-resets,
# its envs staggered (env i starts at step i % episode), the others
# rollout_random
PATHS = (('humanoid', 'run', 4096, 5, 27, None),
         ('cartpole', 'swingup', 16384, 1, 2, None),
         ('cheetah', 'run', 4096, 1, 9, None),
         ('walker', 'walk', 4096, 10, 9, None),
         ('quadruped', 'fetch', 4096, 4, 28, None),
         ('humanoid_CMU', 'run', 4096, 10, 62, None),
         ('swimmer', 'swimmer6', 4096, 15, 8, EPISODE),
         ('finger', 'turn_hard', 4096, 2, 3, EPISODE),
         ('stacker', 'stack_4', 4096, 10, 20, EPISODE))
SWEEP_BATCH = 4096
SWEEP_N = (1, 8, 16, 27, 28, 29, 31, 32, 33, 63, 64)
# every n the suite's ported models give the kernel: pendulum, cartpole,
# acrobot, point_mass, reacher and lqr_2_1, two and three poles,
# ball_in_cup, lqr_6_2, hopper, swimmer6, cheetah and walker, manipulator,
# fish, stack_2, swimmer15, stack_4, quadruped walk and run, quadruped
# fetch, humanoid_CMU
SUITE_N = (1, 2, 3, 4, 6, 7, 8, 9, 11, 13, 14, 17, 20, 22, 28, 62)
SUITE_BATCHES = (16384, 4096)
HUMANOID_NV = 27
# the n of the misaligned, singular and upper-NaN cases: humanoid's
# (the register tile) and humanoid_CMU's (the block rows)
EDGE_N = (HUMANOID_NV, 62)
# (batch, n) timed: humanoid's, cartpole's, cheetah's and walker's,
# quadruped fetch's, quadruped walk's and run's, humanoid_CMU's (the
# block rows), swimmer6's, finger's, stack_4's
TIMED_SHAPES = ((4096, 27), (16384, 2), (4096, 9), (4096, 28), (4096, 22),
                (4096, 62), (4096, 8), (4096, 3), (4096, 20))
# the tasks whose control step is held card against CPU, with the load
# arguments beyond device and dtype (lqr: the seed of its stiffnesses)
STEP_DOMAINS = (('humanoid', 'run', {}), ('cartpole', 'swingup', {}),
                ('acrobot', 'swingup', {}), ('pendulum', 'swingup', {}),
                ('cheetah', 'run', {}), ('walker', 'walk', {}),
                ('hopper', 'hop', {}), ('quadruped', 'walk', {}),
                ('quadruped', 'fetch', {}), ('humanoid_CMU', 'run', {}),
                ('ball_in_cup', 'catch', {}), ('point_mass', 'easy', {}),
                ('fish', 'upright', {}), ('lqr', 'lqr_2_1', {'random': 0}),
                ('lqr', 'lqr_6_2', {'random': 0}), ('reacher', 'easy', {}),
                ('reacher', 'hard', {}), ('point_mass', 'hard', {}),
                ('fish', 'swim', {}), ('swimmer', 'swimmer6', {}),
                ('swimmer', 'swimmer15', {}), ('finger', 'spin', {}),
                ('finger', 'turn_easy', {}), ('finger', 'turn_hard', {}),
                ('manipulator', 'bring_ball', {}),
                ('manipulator', 'bring_peg', {}),
                ('manipulator', 'insert_ball', {}),
                ('manipulator', 'insert_peg', {}), ('stacker', 'stack_2', {}),
                ('stacker', 'stack_4', {}))
# envs and control steps of the phase that reads hopper's touch on the card
TOUCH_ENVS, TOUCH_STEPS = 256, 25
# relative error bounds, kernel vs plain version (max over each system of
# |x_kernel - x_plain| / max |x_plain|): both factor the same Jacobi-scaled
# matrix, so they differ by rounding in another summation order
TOL = {torch.float32: 1e-3, torch.float64: 1e-10}
# a path's own Newton systems, float32: in no system may the kernel's
# backward error, its max or its mean over the envs, exceed the plain
# version's by more than this factor plus eps (a single env's is rounding
# noise: n = 2 systems read 1.4 eps beside the plain version's 0); where
# the Jacobi-scaled condition number is below WELL_CONDITIONED, cond * eps
# (1.2e-4) fixes the solution inside TOL and kernel vs plain is held there
BACKWARD_RATIO = 4
WELL_CONDITIONED = 1e3
# peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): HBM bytes/s
# and FLOP/s per type, the type's highest (float32 outside the tensor
# cores, float64 on them)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
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


def env_rel_err(got, want):
  """(B,) max |got - want| over max |want| of each system."""
  return ((got - want).abs().amax(-1) /
          want.abs().amax(-1).clamp_min(1e-30))


def rel_err(got, want):
  return env_rel_err(got, want).max().item()


def scaled_condition(H):
  """(B,) condition number of each Jacobi-scaled system (the matrix the
  solve factors), from its lower triangle, in float64."""
  from dm_control_tpu_torch.ops import linalg
  H = H.double()
  H = torch.tril(H) + torch.tril(H, -1).transpose(-1, -2)
  s = linalg.jacobi_scale(H)
  ev = torch.linalg.eigvalsh(H * s[..., :, None] * s[..., None, :])
  return ev[..., -1] / ev[..., 0].clamp_min(1e-300)


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
      t = re.search(r'(chol_solve_[a-z]+_kernel)I([fd])(?:Li(\d+)E)?E', entry)
      name = (f'{t.group(1)}<{t.group(2)}' +
              (f', {t.group(3)}>' if t.group(3) else '>')) if t else entry
      out.append((name, int(m.group(1))) + frame)
      entry, frame = None, None
  return out


def bound_ms(batch, n, dtype):
  """Least time for B solves on the card: the bytes the function needs
  (the lower triangle of H, n (n + 1) / 2 elements, and g, each read
  once, and x written once) over the memory rate, or the work (the
  factor's n^3/6 multiply-adds, n^3/3 operations; n^2 multiply-adds, 2 n^2
  operations, of the two substitutions; 2 n^2 multiplies of the scaling)
  over the peak rate of the type; whichever is larger. Returns (bound ms,
  what bounds it, the bytes' time in ms)."""
  size = torch.finfo(dtype).bits // 8
  mem = batch * (n * (n + 1) // 2 + 2 * n) * size / PEAK_BYTES
  ops = batch * (n ** 3 / 3 + 4 * n * n) / PEAK_FLOPS[dtype]
  return (max(mem, ops) * 1e3, 'bytes' if mem >= ops else 'operations',
          mem * 1e3)


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


def recorded_systems(m, data):
  """The SPD systems that one physics step of `data` hands the kernel, in
  call order, each as (H, g, mass), recorded at the dispatch. `mass` marks
  the step's mass-matrix systems, M qacc = qfrc_smooth and Euler's
  (M + h diag(damping)) qacc' = qfrc, told apart by H equal to the step's
  own M or M + h diag(damping); every other system (a Newton direction's
  M + J' D J, and an RK4 stage's systems) is held as a Newton system."""
  from dm_control_tpu_torch.ops import cuda_kernels
  from dm_control_tpu_torch.ops import forward as forward_ops
  systems = []
  dispatch = cuda_kernels.chol_solve_batched

  def record(H, g):
    systems.append((H.contiguous(), g.contiguous()))
    return dispatch(H, g)

  cuda_kernels.chol_solve_batched = record
  try:
    out = forward_ops.step_batched(m, data, compute_sensors=False)
  finally:
    cuda_kernels.chol_solve_batched = dispatch
  mass = (out.qM, out.qM + m.opt.timestep.to(out.qM.dtype) *
          torch.diag(m.dof_damping))
  return [(H, g, any(torch.equal(H, M) for M in mass)) for H, g in systems]


def backward_error(H, g, x):
  """(B,) normalized backward error of each system's solution, in float64,
  on the Jacobi-scaled system the solve factors (A = S H S, b = S g,
  y = x / s): |A y - b| / (|A| |y| + |b|) in the max norms, with H read
  from its lower triangle as the solve reads it. A backward-stable
  Cholesky solve keeps it near n eps whatever the condition number."""
  from dm_control_tpu_torch.ops import linalg
  H, g, x = H.double(), g.double(), x.double()
  H = torch.tril(H) + torch.tril(H, -1).transpose(-1, -2)
  s = linalg.jacobi_scale(H)
  A = H * s[..., :, None] * s[..., None, :]
  y, b = x / s, g * s
  r = torch.einsum('bij,bj->bi', A, y) - b
  scale = (A.abs().sum(-1).amax(-1) * y.abs().amax(-1) +
           b.abs().amax(-1)).clamp_min(1e-300)
  return r.abs().amax(-1) / scale


def worst(values):
  """Largest entry of a list of tensors, NaN if any entry is NaN (torch's
  reductions pass a NaN on); 0 for no entries."""
  flat = [v.flatten() for v in values if v.numel()]
  return torch.cat(flat).max().item() if flat else 0.0


def hold_systems(name, systems, solve):
  """`solve` (the kernel's wrapper) against the plain version on systems
  [(H, g, mass)] of one float32 step; raises on any disagreement.

  Envs whose H (lower triangle) or g is not finite are left out and
  counted. In every other env the solution must be finite. The mass-matrix
  systems are well conditioned: held by their forward error, kernel
  against plain, at TOL. A Newton Hessian M + J' D J can be so ill
  conditioned (Jacobi-scaled condition numbers above 1e6 on
  quadruped.fetch) that no float32 solve fixes its solution to TOL, the
  plain version's included. Each Newton env-system is held by the kernel's
  backward error, within n eps, and each Newton system by its backward
  errors' max and mean over the envs, within BACKWARD_RATIO times the
  plain version's plus eps; where its scaled condition number is below
  WELL_CONDITIONED it is held kernel against plain at TOL too."""
  from dm_control_tpu_torch.ops import linalg
  tol, eps = TOL[torch.float32], torch.finfo(torch.float32).eps
  mass_abs, mass_rel, newton_rel, back_k, back_p = [], [], [], [], []
  skipped = nonfinite = worse = held = n_newton = 0
  for H, g, mass in systems:
    ok_in = (torch.isfinite(torch.tril(H)).flatten(1).all(-1) &
             torch.isfinite(g).all(-1))
    skipped += int((~ok_in).sum())
    if not ok_in.any():
      continue
    H, g = H[ok_in], g[ok_in]
    got = solve(H, g)
    want = linalg.chol_solve_plain(H, g)
    nonfinite += int((~torch.isfinite(got).all(-1)).sum())
    rel = env_rel_err(got, want)
    if mass:
      mass_abs.append((got - want).abs())
      mass_rel.append(rel)
      continue
    n_newton += 1
    bk, bp = backward_error(H, g, got), backward_error(H, g, want)
    back_k.append(bk)
    back_p.append(bp)
    worse += int(not (bk.max() <= BACKWARD_RATIO * bp.max() + eps and
                      bk.mean() <= BACKWARD_RATIO * bp.mean() + eps))
    well = scaled_condition(H) < WELL_CONDITIONED
    held += int(well.sum())
    newton_rel.append(rel[well])
  n = systems[0][0].shape[-1]
  back_tol = n * eps
  res = dict(max_abs_err=worst(mass_abs), max_rel_err=worst(mass_rel),
             newton_backward_err=worst(back_k),
             newton_backward_err_plain=worst(back_p),
             newton_rel_err_well=worst(newton_rel), newton_well_held=held,
             nonfinite_input_envs=skipped)
  print(f'[3] {name}: kernel vs plain on one more step\'s {len(systems)} '
        f'systems (n {n}); {skipped} env-systems with non-finite H or g '
        f'left out; kernel solutions not finite in {nonfinite}; mass '
        f'matrices (smooth, Euler) max abs err {res["max_abs_err"]:.3e}, max '
        f'rel err {res["max_rel_err"]:.3e} (tol {tol:.0e}); {n_newton} '
        f'Newton Hessians: backward error kernel '
        f'{res["newton_backward_err"]:.3e}, plain '
        f'{res["newton_backward_err_plain"]:.3e} (tol n eps = '
        f'{back_tol:.1e}), the kernel\'s max or mean above {BACKWARD_RATIO} '
        f'x the plain version\'s + eps in {worse}; {held} env-systems of '
        f'scaled condition number < {WELL_CONDITIONED:.0e}: kernel vs plain '
        f'max rel err '
        f'{res["newton_rel_err_well"]:.3e} (tol {tol:.0e})', flush=True)
  if nonfinite:
    raise RuntimeError(f'{name}: the kernel\'s solution is not finite on '
                       'finite systems')
  if not res['max_rel_err'] <= tol:
    raise RuntimeError(f'kernel disagrees with plain on {name}\'s mass '
                       'matrices')
  if not res['newton_backward_err'] <= back_tol or worse:
    raise RuntimeError(f'kernel not backward stable on {name}\'s Newton '
                       'Hessians')
  if not res['newton_rel_err_well'] <= tol:
    raise RuntimeError(f'kernel disagrees with plain on {name}\'s well '
                       'conditioned Newton Hessians')
  return res


class StepRecorder:
  """What a rollout's control steps leave behind, recorded as device
  tensors and read after it: the envs with contact.overflow set at each
  control step (the task's after_step runs once a control step, on its
  new state) and the Newton iterations of each constraint solve (the
  batch's count, at fwd_constraint_batched). Launches nothing of the
  kernel."""

  def __init__(self, task):
    from dm_control_tpu_torch.ops import constraint
    self._task, self._constraint = task, constraint
    self.overflow, self.niter = [], []

  def __enter__(self):
    after = self._task.after_step
    self._solve = solve = self._constraint.fwd_constraint_batched

    def after_step(m, d):
      self.overflow.append(d.contact.overflow.sum())
      return after(m, d)

    def fwd_constraint_batched(m, d, compute_forces=True):
      out = solve(m, d, compute_forces)
      self.niter.append(out.solver_niter[0])
      return out

    self._task.after_step = after_step
    self._constraint.fwd_constraint_batched = fwd_constraint_batched
    return self

  def __exit__(self, *exc):
    del self._task.after_step
    self._constraint.fwd_constraint_batched = self._solve


class ResetRounds:
  """The rounds of each rejection-sampling reset while in the block
  (suite.base.contact_free_qpos): the draws after the first of each call,
  read from the host's count of its draw calls."""

  def __enter__(self):
    from dm_control_tpu_torch.suite import base
    self._base, sampler = base, base.contact_free_qpos
    self.rounds = []

    def counting(model, batch, draw, max_rounds):
      calls = []

      def counted(idx):
        calls.append(len(idx))
        return draw(idx)

      out = sampler(model, batch, counted, max_rounds)
      self.rounds.append(len(calls) - 1)
      return out

    base.contact_free_qpos = counting
    self._sampler = sampler
    return self

  def __exit__(self, *exc):
    self._base.contact_free_qpos = self._sampler

  def summary(self) -> str:
    if not self.rounds:
      return 'no rejection sampling'
    r = self.rounds
    return (f'{len(r)} rejection-sampling call(s), rounds after the first '
            f'draw: mean {sum(r) / len(r):.2f}, max {max(r)}')


def step_with_resets(benv, name):
  """ROLLOUT_STEPS control steps of BatchedEnvironment.step with uniform
  random actions in [-1, 1). At each step the envs that finish must draw
  new model leaves and every other env keep its own bit for bit, and
  every env must have been reset at least once by the end. Returns
  (Data, summed rewards (B,), resets per env (B,))."""
  envs, nu, dev = benv.batch_size, benv.model.nu, benv.model.device
  gen = torch.Generator(device=dev).manual_seed(7)
  total = torch.zeros(envs, device=dev)
  resets = torch.zeros(envs, dtype=torch.int64, device=dev)
  wrong = torch.zeros((), dtype=torch.int64, device=dev)
  for _ in range(ROLLOUT_STEPS):
    before = {k: v.clone() for k, v in benv.leaves.items()}
    actions = torch.rand((envs, nu), generator=gen, device=dev) * 2 - 1
    _, reward, done = benv.step(actions)
    total += reward
    resets += done
    for k, v in benv.leaves.items():
      wrong += ((v != before[k]).flatten(1).any(-1) != done).sum()
  if not benv.leaves:
    raise RuntimeError(f'{name}: the batch holds no drawn leaves')
  if int(wrong):
    raise RuntimeError(f'{name}: {int(wrong)} env-steps where a reset env '
                       'kept its leaves or a running env changed them')
  if int(resets.min()) == 0:
    raise RuntimeError(f'{name}: some envs were never reset')
  return benv.data, total, resets


def drive_path(domain, task, envs, n_sub, nv, episode, card, timing):
  """Builds `domain.task` on the card (float32), resets `envs` envs and
  runs ROLLOUT_STEPS control steps: rollout_random, or with an episode
  length, BatchedEnvironment.step with auto-resets (step_with_resets);
  checks the outputs and the kernel on the systems the path's own state
  gives it. Returns the path's numbers for the kernels line."""
  from dm_control_tpu_torch import suite
  from dm_control_tpu_torch.models import constants
  from dm_control_tpu_torch.ops import constraint
  from dm_control_tpu_torch.ops import cuda_kernels
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
  limit = (float('inf') if episode is None else
           episode * n_sub * float(m.opt.timestep))
  benv = BatchedEnvironment(m, env.task, batch_size=envs, time_limit=limit,
                            n_sub_steps=env.n_sub_steps, seed=0)
  cuda_kernels.chol_solve_cuda.launches = 0
  t0 = time.perf_counter()
  with ResetRounds() as first_rounds:
    obs = benv.reset()
  torch.cuda.synchronize()
  reset_s = time.perf_counter() - t0
  reset_launches = cuda_kernels.chol_solve_cuda.launches
  for k, v in obs.items():
    if v.shape[0] != envs or not torch.isfinite(v).all():
      raise RuntimeError(f'{name}: bad initial observation {k}')
  # envs whose reset state still touches: the rejection-sampling
  # initializers keep an env's last draw after their last round
  init_contact = int(benv.data.contact.active.any(dim=-1).sum())
  print(f'[3] {name}: model build {build_s:.2f} s, reset of {envs} envs '
        f'{reset_s:.2f} s ({reset_launches} chol_solve launches; '
        f'{init_contact} envs in contact after it; '
        f'{first_rounds.summary()}); nv {m.nv}, '
        f'{m.nefc_max} constraint rows, {m.ncon_sel} contact slots, '
        f'n_sub_steps {env.n_sub_steps}, integrator '
        f'{constants.IntegratorType(int(m.opt.integrator)).name}', flush=True)
  if episode is not None:
    benv.set_state(benv.state, steps=torch.arange(envs) % episode)
  cuda_kernels.chol_solve_cuda.launches = 0
  t0 = time.perf_counter()
  with StepRecorder(env.task) as rec, ResetRounds() as auto_rounds:
    if episode is None:
      data, total = benv.rollout_random(ROLLOUT_STEPS)
    else:
      data, total, resets = step_with_resets(benv, name)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = cuda_kernels.chol_solve_cuda.launches
  overflow_steps = [int(v) for v in rec.overflow]
  niter = torch.stack(rec.niter).float() if rec.niter else torch.zeros(1)
  extra = dict(overflow_envs_per_step=overflow_steps,
               newton_iters_mean=niter.mean().item(),
               newton_iters_max=int(niter.max()), solves=len(rec.niter),
               reset_rounds=first_rounds.rounds,
               auto_reset_rounds=auto_rounds.rounds)
  print(f'[3] {name}: envs with contact.overflow set, each control step: '
        f'{overflow_steps}; Newton iterations a constraint solve (the '
        f'batch\'s): mean {extra["newton_iters_mean"]:.2f}, max '
        f'{extra["newton_iters_max"]} of {m.opt.solver_iterations}, '
        f'{len(rec.niter)} solves', flush=True)
  if episode is not None:
    extra.update(episode_steps=episode, resets=int(resets.sum()),
                 resets_min=int(resets.min()))
    print(f'[3] {name}: BatchedEnvironment.step with auto-resets every '
          f'{episode} control steps, envs staggered: {extra["resets"]} '
          f'env resets in {ROLLOUT_STEPS} steps, at least '
          f'{extra["resets_min"]} an env; each reset env drew new leaves '
          f'({", ".join(benv.leaves)}) on the card and every other env kept '
          f'its own; auto-resets: {auto_rounds.summary()}', flush=True)
  bm = benv.batch_model
  diverged = data.divergence
  rate = envs * ROLLOUT_STEPS / wall
  reward = total.mean().item() / ROLLOUT_STEPS
  how = (f'rollout_random({ROLLOUT_STEPS})' if episode is None else
         f'{ROLLOUT_STEPS} x step')
  print(f'[3] {name} {how} x {envs} envs: '
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
  live_rows = (constraint.make_rows(bm, data).slot_active > 0).sum(
      dim=-1).float()
  overflow = int(con.overflow.sum())
  print(f'[3] {name}: {step_ms:.1f} ms a control step; the kernel: {share}; '
        f'per env at the end: active contacts mean {ncon.mean():.2f} max '
        f'{int(ncon.max())}, live constraint rows mean {live_rows.mean():.2f} '
        f'max {int(live_rows.max())} of {m.nefc_max}; contact.overflow in '
        f'{overflow} '
        f'envs', flush=True)
  if episode is not None:
    # the same control steps without the auto-resets: step_core alone,
    # from the path's end state
    gen = torch.Generator(device=m.device).manual_seed(11)
    state = benv.state
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(CORE_STEPS):
      actions = torch.rand((envs, m.nu), generator=gen, device=m.device)
      state = benv.step_core(state, actions * 2 - 1)[0]
    torch.cuda.synchronize()
    core_ms = (time.perf_counter() - t1) * 1e3 / CORE_STEPS
    extra['control_step_ms_without_resets'] = core_ms
    print(f'[3] {name}: {CORE_STEPS} control steps of step_core alone (no '
          f'resets): {core_ms:.1f} ms a control step, so the resets took '
          f'{step_ms - core_ms:.1f} of the path\'s {step_ms:.1f} ms',
          flush=True)
  if domain in ('quadruped', 'humanoid_CMU', 'swimmer', 'finger',
                'stacker'):
    (sub_k, sub_c), (mpr_k, mpr_c), n_groups = mpr_launches(bm, data)
    print(f'[3] {name}: torch.profiler, one substep of {envs} envs: '
          f'{sub_k} CUDA kernels ({sub_c} launch calls); its {n_groups} MPR '
          f'group(s) alone: {mpr_k} kernels ({mpr_c} launch calls); the '
          f'substep without them: {sub_k - mpr_k} kernels', flush=True)
    extra.update(substep_kernels=sub_k, mpr_kernels=mpr_k)
  if not torch.isfinite(total).all():
    raise RuntimeError(f'{name}: non-finite rewards')
  if total.shape != (envs,) or not ((total >= 0) &
                                    (total <= ROLLOUT_STEPS)).all():
    raise RuntimeError(f'{name}: rewards outside [0, steps]')
  live = ~diverged
  outputs = dict(qpos=data.qpos, qvel=data.qvel, **env.task.get_observation(
      bm, data))
  if m.opt.enableflags & constants.EnableBit.ENERGY:
    outputs['energy'] = data.energy
  for k, v in outputs.items():
    if not torch.isfinite(v[live]).all():
      raise RuntimeError(f'{name}: non-finite {k} outside diverged envs')
  own = hold_systems(name, recorded_systems(bm, data),
                     cuda_kernels.chol_solve_cuda)
  print(f'[3] {name}: finite: {", ".join(outputs)}', flush=True)
  return dict(envs=envs, substeps=n_sub, build_s=build_s, reset_s=reset_s,
              reset_launches=reset_launches, init_contact_envs=init_contact,
              env_steps_per_s=rate, control_step_ms=step_ms,
              launches=launches, reward_per_step=reward,
              contacts_mean=ncon.mean().item(),
              live_rows_mean=live_rows.mean().item(),
              live_rows_max=int(live_rows.max()), overflow_envs=overflow,
              **own, **extra)


def step_card_vs_cpu(domain, task, kwargs):
  """One control step of 4 envs, float64, on the card and on the CPU from
  the card's reset state and drawn model leaves: qpos, qvel (relative to
  max(1, |x|)), observations and reward within STEP_TOL."""
  from dm_control_tpu_torch import suite
  from dm_control_tpu_torch.parallel import BatchedEnvironment
  env64 = suite.load(domain, task, device='cuda', dtype=torch.float64,
                     **kwargs)
  envc = suite.load(domain, task, device='cpu', dtype=torch.float64,
                    **kwargs)
  n_sub = env64.n_sub_steps
  b_gpu = BatchedEnvironment(env64.model, env64.task, batch_size=4,
                             n_sub_steps=n_sub, seed=3)
  b_cpu = BatchedEnvironment(envc.model, envc.task, batch_size=4,
                             n_sub_steps=n_sub, seed=3)
  b_gpu.reset()
  state = {k: v.cpu() for k, v in b_gpu.state.items()}
  b_cpu.set_state(state, leaves={k: v.cpu() for k, v in
                                 b_gpu.leaves.items()})
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


def touch_changes(card):
  """hopper.hop on the card, float32: its `touch` observation over
  TOUCH_STEPS control steps of TOUCH_ENVS envs. It reads the last
  substep's contact forces, so it must be nonzero in some steps and
  change from step to step (stale sensors would hold the reset's)."""
  from dm_control_tpu_torch import suite
  from dm_control_tpu_torch.parallel import BatchedEnvironment
  env = suite.load('hopper', 'hop', dtype=torch.float32)
  benv = BatchedEnvironment(env.model, env.task, batch_size=TOUCH_ENVS,
                            n_sub_steps=env.n_sub_steps, seed=1)
  benv.reset()
  gen = torch.Generator(device='cuda').manual_seed(2)
  touch = []
  for _ in range(TOUCH_STEPS):
    actions = torch.rand((TOUCH_ENVS, env.model.nu), generator=gen,
                         device='cuda') * 2 - 1
    obs, _, _ = benv.step(actions)
    touch.append(obs['touch'])
  touch = torch.stack(touch)                       # (steps, envs, 2)
  if not torch.isfinite(touch).all():
    raise RuntimeError('hopper touch: non-finite values')
  touching = (touch > 0).any(dim=-1).sum(dim=-1)   # envs, per step
  changed = (touch[1:] != touch[:-1]).any(dim=-1).sum(dim=-1)
  print(f'[5] hopper.hop touch on the card, {TOUCH_ENVS} envs x '
        f'{TOUCH_STEPS} control steps: envs touching per step min '
        f'{int(touching.min())} max {int(touching.max())}; envs whose touch '
        f'changed from the step before, per step: min {int(changed.min())} '
        f'max {int(changed.max())}; max log1p(touch) '
        f'{touch.max().item():.3f} ({card})', flush=True)
  if int(touching.max()) == 0 or int(changed.max()) == 0:
    raise RuntimeError('hopper touch never read a contact force, or never '
                       'changed: acceleration-stage sensors are stale')
  return dict(envs=TOUCH_ENVS, steps=TOUCH_STEPS,
              touching_max=int(touching.max()),
              changed_max=int(changed.max()))


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
  bound, bound_by, bytes_ms = bound_ms(batch, n, dtype)
  out = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
             library_ms=(l1 + l2) / 2, bound_ms=bound, bound_by=bound_by,
             bytes_bound_ms=bytes_ms, host_paced_ms=host)
  print(f'[2] time at B={batch} n={n} {str(dtype)[6:]}: '
        f'kernel {k1:.4f}, {k2:.4f} ms (card held); library {l1:.4f}, '
        f'{l2:.4f} ms (back to back; rel err vs plain {lib_err:.1e}); plain '
        f'{p1:.4f}, {p2:.4f} ms (back to back); bound {bound:.5f} ms '
        f'({bound_by}; the bytes alone {bytes_ms:.5f} ms); kernel at '
        f'{100 * bound / out["ms"]:.1f}% of the bound; kernel back to back '
        f'{host:.4f} ms (CUDA events, L2-warm; {card})', flush=True)
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
  for kernel, count in (('chol_solve_reg', 2), ('chol_solve_rows', 2)):
    found = [r for r in report if r[0].startswith(kernel)]
    if len(found) != count or any(r[2:] != (0, 0, 0) for r in found):
      raise RuntimeError(f'{kernel}_kernel needs {count} instances (float '
                         'and double) with no stack frame and no spills')

  # ---- phase 2 ----
  rng = np.random.default_rng(0)
  for dtype in (torch.float32, torch.float64):
    cases = [(f'B={SWEEP_BATCH} n={n:2d}', random_spd(rng, SWEEP_BATCH, n),
              0) for n in SWEEP_N]
    cases += [(f'B={batch} n={n:2d} (suite)', random_spd(rng, batch, n), 0)
              for batch in SUITE_BATCHES for n in SUITE_N]
    for n in EDGE_N:
      # a ragged last block, from an address 1 element past an allocation
      # (not 16-byte aligned)
      cases.append((f'B=4093 n={n} misaligned', random_spd(rng, 4093, n), 1))
      # floored pivots: zero rows and columns (a massless dof) and zero
      # matrices; each pivot the floor meets is exactly 0 in any order
      sing = random_spd(rng, 512, n)
      sing[0::3, 5, :] = sing[0::3, :, 5] = 0
      sing[1::3, 0, :] = sing[1::3, :, 0] = 0
      sing[1::3, -1, :] = sing[1::3, :, -1] = 0
      sing[2::3] = 0
      cases.append((f'B=512 n={n} singular', sing, 0))
      # NaN above every diagonal: the function reads only the lower
      # triangle
      upper = random_spd(rng, SWEEP_BATCH, n)
      iu = np.triu_indices(n, 1)
      upper[:, iu[0], iu[1]] = np.nan
      cases.append((f'B={SWEEP_BATCH} n={n} upper NaN', upper, 0))
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
  for domain, task, envs, n_sub, nv, episode in PATHS:
    paths[f'{domain}.{task}'] = drive_path(domain, task, envs, n_sub, nv,
                                           episode, card, timing)

  # ---- phase 4 ----
  for domain, task, kwargs in STEP_DOMAINS:
    step_card_vs_cpu(domain, task, kwargs)

  # ---- phase 5 ----
  touch = touch_changes(card)

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
      'shapes': [shape_entry(b, n) for b, n in TIMED_SHAPES],
      'hopper_touch': touch}]}))
  print(card)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind,
      'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
  main()
