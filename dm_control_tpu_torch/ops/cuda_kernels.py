"""Hand-written CUDA kernels of the port, built at first use.

Counterpart of dm_control_tpu/ops/pallas_kernels.py. `chol_solve_batched`
is the one entry point the physics step calls: a CPU tensor takes the
plain PyTorch version (ops/linalg.py), a CUDA tensor launches the kernel
in csrc/chol_solve.cu or raises.

The kernel is compiled with nvcc into a shared library with a plain C
interface and loaded through ctypes. The library goes into `_build/`
beside this package (listed in .gitignore), named by a hash of the
source, so an edited source is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

from dm_control_tpu_torch.ops import linalg

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHOL_SOLVE_SOURCE = os.path.join(_PKG_DIR, 'csrc', 'chol_solve.cu')
BUILD_DIR = os.path.join(_PKG_DIR, '_build')
MAX_N = 64

_NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
               '-O3', '-shared', '-Xcompiler', '-fPIC')

# the loaded ctypes library, set by build_chol_solve
_LIB = None


def _nvcc() -> str:
  path = shutil.which('nvcc')
  if path is None:
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(cuda_home, 'bin', 'nvcc')
  if not os.path.exists(path):
    raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                       'toolkit (nvcc on PATH or under $CUDA_HOME/bin)')
  return path


def build_chol_solve(verbose: bool = False):
  """Compiles csrc/chol_solve.cu if needed and loads it.

  Returns (library path, seconds spent compiling, compiler log). With
  verbose=True, ptxas reports registers and shared memory per kernel.
  """
  global _LIB
  with open(CHOL_SOLVE_SOURCE, 'rb') as f:
    digest = hashlib.sha256(f.read() + repr(_NVCC_FLAGS).encode()).hexdigest()
  lib_path = os.path.join(BUILD_DIR, f'libchol_solve_{digest[:16]}.so')
  seconds, log = 0.0, ''
  if not os.path.exists(lib_path):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{lib_path}.{os.getpid()}.tmp'
    cmd = [_nvcc(), *_NVCC_FLAGS, *(['-Xptxas', '-v'] if verbose else []),
           '-o', tmp, CHOL_SOLVE_SOURCE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
      raise RuntimeError(f'nvcc failed ({proc.returncode}):\n{log}')
    os.replace(tmp, lib_path)
  if _LIB is None or _LIB._name != lib_path:
    lib = ctypes.CDLL(lib_path)
    for name in ('dmc_chol_solve_f32', 'dmc_chol_solve_f64'):
      fn = getattr(lib, name)
      fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
      fn.restype = ctypes.c_int
    _LIB = lib
  return lib_path, seconds, log


def chol_solve_cuda(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  """Launches the CUDA kernel: H (B, n, n) SPD, g (B, n) -> x (B, n).

  Counts each launch in `chol_solve_cuda.launches`.
  """
  if H.device.type != 'cuda' or g.device != H.device:
    raise ValueError(f'chol_solve_cuda needs both tensors on one CUDA '
                     f'device, got {H.device} and {g.device}')
  if H.dtype not in (torch.float32, torch.float64) or g.dtype != H.dtype:
    raise TypeError(f'chol_solve_cuda takes float32 or float64, got '
                    f'{H.dtype} and {g.dtype}')
  if H.dim() != 3 or H.shape[1] != H.shape[2] or tuple(g.shape) != tuple(
      H.shape[:2]):
    raise ValueError(f'bad shapes H {tuple(H.shape)}, g {tuple(g.shape)}')
  batch, n = H.shape[0], H.shape[-1]
  if not 1 <= n <= MAX_N:
    raise ValueError(f'chol_solve_cuda takes 1 <= n <= {MAX_N}, got {n}')
  if not (H.is_contiguous() and g.is_contiguous()):
    raise ValueError('chol_solve_cuda needs contiguous tensors')
  x = torch.empty_like(g)
  if batch == 0:
    return x
  if _LIB is None:
    build_chol_solve()
  fn = (_LIB.dmc_chol_solve_f32 if H.dtype == torch.float32
        else _LIB.dmc_chol_solve_f64)
  with torch.cuda.device(H.device):
    stream = torch.cuda.current_stream(H.device).cuda_stream
    err = fn(H.data_ptr(), g.data_ptr(), x.data_ptr(), batch, n, stream)
  if err != 0:
    raise RuntimeError(f'chol_solve kernel launch failed: CUDA error {err}')
  chol_solve_cuda.launches += 1
  return x


chol_solve_cuda.launches = 0


def chol_solve_batched(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  """Batched SPD solve H x = g; H (B, n, n), g (B, n).

  CPU tensors take the plain PyTorch version; CUDA tensors launch the
  kernel (or raise). There is no other path.
  """
  if H.device.type == 'cpu':
    return linalg.chol_solve_plain(H, g)
  return chol_solve_cuda(H.contiguous(), g.contiguous())
