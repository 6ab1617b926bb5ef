"""Populate the persistent XLA compilation cache for the tier-1 lane.

The lane (ROADMAP.md, "Tier-1 verify") runs pytest-xdist workers that each
collect every module under tests/, and six parity modules turn on
`jax_enable_x64` when they are imported (ROADMAP C.c). So every test of the
lane traces, and looks up in the cache, x64 programs. `tools/warm_cache.py`
runs each file on its own, where x64 stays off unless the file is one of the
six, so the lane finds none of its entries and compiles everything again.

This script runs the lane's tests with cache writes enabled
(DMC_TPU_CACHE_WRITE=1, see tests/conftest.py), in short-lived processes
that each collect the whole of tests/ as a lane worker does (the same
imports in the same order, x64 turned on at the same point) and run only
one chunk of it, so no process compiles enough modules to reach the
serializer's crash (see tools/warm_cache.py). The lane then reads what they
wrote. Test outcomes do not matter here; run the lane afterwards.

Usage:  python tools/warm_lane_cache.py [--jobs 4] [--chunk 4] [-m EXPR]
                                       [--only tests/test_x.py ...]

--only keeps the tests whose node ids hold one of the given strings: after
a change to a few files, only their tests need new entries.
"""

import argparse
import concurrent.futures
import os
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_IDS_ENV = 'WARM_LANE_CACHE_IDS'


def pytest_collection_modifyitems(session, config, items):
  """As a pytest plugin: keep the node ids listed in $WARM_LANE_CACHE_IDS."""
  path = os.environ.get(_IDS_ENV)
  if not path:
    return
  with open(path) as f:
    want = set(f.read().split())
  dropped = [i for i in items if i.nodeid not in want]
  items[:] = [i for i in items if i.nodeid in want]
  config.hook.pytest_deselected(items=dropped)


def _pytest(args, env):
  return subprocess.run(
      [sys.executable, '-m', 'pytest', 'tests/', '-q', '-p',
       'no:cacheprovider', '-p', 'no:randomly', *args],
      cwd=_ROOT, env=env, capture_output=True, text=True)


def main():
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--jobs', type=int, default=4,
                      help='processes at a time')
  parser.add_argument('--chunk', type=int, default=4,
                      help='tests a process')
  parser.add_argument('-m', dest='marks', default='not slow',
                      help="the lane's marker expression")
  parser.add_argument('--only', nargs='+', default=None,
                      help='keep the node ids that hold one of these')
  args = parser.parse_args()
  env = dict(os.environ, JAX_PLATFORMS='cpu')
  listing = _pytest(['-m', args.marks, '--collect-only'], env)
  ids = [line for line in listing.stdout.splitlines() if '::' in line]
  if args.only:
    ids = [i for i in ids if any(part in i for part in args.only)]
  chunks = [ids[i:i + args.chunk] for i in range(0, len(ids), args.chunk)]
  print(f'{len(ids)} tests in {len(chunks)} processes, {args.jobs} at a '
        'time', flush=True)
  env.update(DMC_TPU_CACHE_WRITE='1', PYTHONPATH=os.pathsep.join(
      [os.path.dirname(os.path.abspath(__file__)),
       env.get('PYTHONPATH', '')]).rstrip(os.pathsep))
  tmp = tempfile.mkdtemp(prefix='warm_lane_cache_')

  def run(k):
    path = os.path.join(tmp, f'{k}.txt')
    with open(path, 'w') as f:
      f.write('\n'.join(chunks[k]))
    t0 = time.time()
    proc = _pytest(['-m', args.marks, '-p', 'warm_lane_cache'],
                   dict(env, **{_IDS_ENV: path}))
    os.remove(path)
    tail = (proc.stdout.strip().splitlines() or ['?'])[-1]
    return k, proc.returncode, time.time() - t0, tail

  t00 = time.time()
  with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
    for k, rc, dt, tail in pool.map(run, range(len(chunks))):
      print(f'[{k + 1}/{len(chunks)}] rc={rc} {dt:6.1f}s  {chunks[k][0]}'
            f'  {tail}', flush=True)
  os.rmdir(tmp)
  print(f'warm done in {time.time() - t00:.0f}s')


if __name__ == '__main__':
  main()
