"""Times versions of the SPD-solve kernel side by side on one CUDA card.

Usage, from the root of a checkout, on a host with a CUDA card and nvcc:

    python3 time_chol_solve.py [--batch B] [--n N] A.cu B.cu [...]

Each source has the C interface dmc_chol_solve_f32/_f64(H, g, x, batch,
n, stream), which every version of dm_control_tpu_torch/csrc/chol_solve.cu
has. All are built at once with the flags of ops/cuda_kernels.py (ptxas's
registers, stack frame and spills printed per kernel, and the SASS
instructions and FMAs of each kernel by cuobjdump), then called on the
same inputs at B systems of size n (default 4096 and 27, humanoid's;
humanoid_CMU's is 62), float32 and float64, in turns (A B ... B A): the
card's time with the card held (chip_smoke.device_ms) and back to back
(chip_smoke.host_ms), by CUDA events. Each result is held against the
plain version at chip_smoke's tolerance. Prints one line per reading and
a JSON line of the means last.
"""

import argparse
import collections
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

import chip_smoke
from dm_control_tpu_torch.ops import cuda_kernels
from dm_control_tpu_torch.ops import linalg


def sass_counts(lib_path):
  """{kernel: (SASS instructions, FFMA + DFMA instructions)} of a built
  library, by the toolkit's cuobjdump."""
  cuobjdump = os.path.join(os.path.dirname(cuda_kernels._nvcc()), 'cuobjdump')
  sass = subprocess.run([cuobjdump, '-sass', lib_path], capture_output=True,
                        text=True, check=True).stdout
  counts, name = collections.defaultdict(lambda: [0, 0]), None
  for line in sass.splitlines():
    m = re.search(r'Function : \S*?(chol_solve_[a-z]+_kernel)I([fd])', line)
    if m:
      name = f'{m.group(1)}<{m.group(2)}>'
      continue
    # an instruction line: /*offset*/, an optional predicate, the opcode
    m = re.match(r'\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)',
                 line)
    if m and name:
      counts[name][0] += 1
      counts[name][1] += m.group(1).split('.')[0] in ('FFMA', 'DFMA')
  return {k: tuple(v) for k, v in counts.items()}


def build_all(sources):
  """Compiles every source with one nvcc each, all started together;
  returns the loaded libraries in order."""
  os.makedirs(cuda_kernels.BUILD_DIR, exist_ok=True)
  procs, paths = [], []
  for src in sources:
    with open(src, 'rb') as f:
      digest = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(cuda_kernels.BUILD_DIR, f'libtime_{digest}.so')
    cmd = [cuda_kernels._nvcc(), *cuda_kernels._NVCC_FLAGS, '-o', path, src]
    procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
    paths.append(path)
  libs = []
  for src, proc, path in zip(sources, procs, paths):
    log, _ = proc.communicate()
    if proc.returncode != 0:
      raise RuntimeError(f'nvcc failed on {src}:\n{log}')
    for name, regs, stack, spill_st, spill_ld in chip_smoke.ptxas_report(log):
      print(f'{src} ptxas {name}: {regs} registers, {stack} bytes stack '
            f'frame, {spill_st} bytes spill stores, {spill_ld} bytes spill '
            'loads', flush=True)
    for name, (total, fma) in sorted(sass_counts(path).items()):
      print(f'{src} SASS {name}: {total} instructions, {fma} FFMA/DFMA',
            flush=True)
    lib = ctypes.CDLL(path)
    for name in ('dmc_chol_solve_f32', 'dmc_chol_solve_f64'):
      fn = getattr(lib, name)
      fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
          ctypes.c_void_p]
      fn.restype = ctypes.c_int
    libs.append(lib)
  return libs


def solver(lib, H, g):
  fn = (lib.dmc_chol_solve_f32 if H.dtype == torch.float32
        else lib.dmc_chol_solve_f64)
  x = torch.empty_like(g)
  stream = torch.cuda.current_stream().cuda_stream
  batch, n = g.shape

  def call():
    err = fn(H.data_ptr(), g.data_ptr(), x.data_ptr(), batch, n, stream)
    if err:
      raise RuntimeError(f'launch failed: CUDA error {err}')
    return x
  return call


def main(argv):
  parser = argparse.ArgumentParser(usage=__doc__)
  parser.add_argument('--batch', type=int, default=4096)
  parser.add_argument('--n', type=int, default=27)
  parser.add_argument('sources', nargs='+')
  args = parser.parse_args(argv)
  sources, batch, n = args.sources, args.batch, args.n
  if not torch.cuda.is_available():
    raise SystemExit(__doc__)
  card = chip_smoke.card_line()
  libs = build_all(sources)
  rng = np.random.default_rng(0)
  cycles_per_ms = chip_smoke.sleep_cycles_per_ms()
  order = list(range(len(sources)))
  order += order[::-1]
  means = {}
  for dtype in (torch.float32, torch.float64):
    H = torch.as_tensor(chip_smoke.random_spd(rng, batch, n), dtype=dtype,
                        device='cuda')
    g = torch.as_tensor(rng.standard_normal((batch, n)), dtype=dtype,
                        device='cuda')
    want = linalg.chol_solve_plain(H, g)
    held = {i: [] for i in order}
    back = {i: [] for i in order}
    for i in order:
      call = solver(libs[i], H, g)
      err = chip_smoke.rel_err(call().clone(), want)
      if not err <= chip_smoke.TOL[dtype]:
        raise RuntimeError(f'{sources[i]} disagrees with plain: {err}')
      held[i].append(chip_smoke.device_ms(call, 200, cycles_per_ms))
      back[i].append(chip_smoke.host_ms(call, 200))
      print(f'{sources[i]} {str(dtype)[6:]}: {held[i][-1]:.5f} ms held, '
            f'{back[i][-1]:.5f} ms back to back, rel err vs plain '
            f'{err:.3e} ({card})', flush=True)
    for i in held:
      means[f'{sources[i]} {str(dtype)[6:]}'] = dict(
          held_ms=sum(held[i]) / len(held[i]),
          back_to_back_ms=sum(back[i]) / len(back[i]))
  bounds = {str(dtype)[6:]: chip_smoke.bound_ms(batch, n, dtype)[0]
            for dtype in (torch.float32, torch.float64)}
  print(json.dumps({'card': card, 'batch': batch, 'n': n,
                    'bound_ms': bounds, 'means': means}))


if __name__ == '__main__':
  main(sys.argv[1:])
