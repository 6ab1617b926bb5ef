"""Times versions of the SPD-solve kernel side by side on one CUDA card.

Usage, from the root of a checkout, on a host with a CUDA card and nvcc:

    python3 time_chol_solve.py A/chol_solve.cu B/chol_solve.cu [...]

Each argument is a source with the C interface
dmc_chol_solve_f32/_f64(H, g, x, batch, n, stream), which every version of
dm_control_tpu_torch/csrc/chol_solve.cu has. All are built at once with
the flags of ops/cuda_kernels.py, then called on the same inputs at
B = 4096, n = 27 (humanoid's), float32 and float64, in turns (A B ... B A):
the card's time with the card held (chip_smoke.device_ms) and back to back
(chip_smoke.host_ms), by CUDA events. Each result is held against the
plain version at chip_smoke's tolerance. Prints one line per reading and
a JSON line of the means last.
"""

import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke
from dm_control_tpu_torch.ops import cuda_kernels
from dm_control_tpu_torch.ops import linalg

BATCH = 4096
N = 27


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

  def call():
    err = fn(H.data_ptr(), g.data_ptr(), x.data_ptr(), BATCH, N, stream)
    if err:
      raise RuntimeError(f'launch failed: CUDA error {err}')
    return x
  return call


def main(sources):
  if not torch.cuda.is_available() or not sources:
    raise SystemExit(__doc__)
  card = chip_smoke.card_line()
  libs = build_all(sources)
  rng = np.random.default_rng(0)
  cycles_per_ms = chip_smoke.sleep_cycles_per_ms()
  order = list(range(len(sources)))
  order += order[::-1]
  means = {}
  for dtype in (torch.float32, torch.float64):
    H = torch.as_tensor(chip_smoke.random_spd(rng, BATCH, N), dtype=dtype,
                        device='cuda')
    g = torch.as_tensor(rng.standard_normal((BATCH, N)), dtype=dtype,
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
  print(json.dumps({'card': card, 'batch': BATCH, 'n': N, 'means': means}))


if __name__ == '__main__':
  main(sys.argv[1:])
