"""The port's box pairs (plane-box, sphere-box, capsule-box, box-box)
against the JAX package's pair functions.

Both sides run in float64 on the CPU from the same numpy inputs, drawn
from a seed; the JAX side enables x64 only inside a scoped context. Each
JAX pair function is jitted once, over a vmapped batch of every case of
its pair; the port's runs once over the same cases laid out as it runs
them in a step, (B, k) poses with (k,) sizes shared by the batch. dist,
pos and normal are compared slot by slot at TOL_SMOOTH (1e-10): every tie
that decides a slot's order is exact on both sides (a box lying flat on a
plane has four bottom corners of one height; equal boxes stacked with one
orientation tie on their facing faces), and both sides break it to the
lower index, jnp.argsort and jnp.argmax as torch.sort(stable=True) and
torch.argmax do.

The two tasks whose models carry box pairs are held whole here, a few
control steps env by env against the unbatched JAX pipeline
(`check_control_steps` of tests/test_torch_manipulator.py): insert_peg
(capsule-box and sphere-box, the peg's blade on its env's drawn slot) and
stack_2 (plane-box, box-box, capsule-box and sphere-box, a box flat on
the floor and another turned on it, off the exact face tie). The lane
budget: besides the four pair functions, this file compiles two
whole-model JAX programs, insert_peg's and stack_2's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dm_control_tpu.ops import collision as jcollision

from dm_control_tpu_torch.models import constants
from dm_control_tpu_torch.models.compiler import _PAIR_NCON
from dm_control_tpu_torch.ops import collision as tcollision

from test_torch_manipulator import check_control_steps
from test_torch_slice import TOL_SMOOTH, assert_close, np_

torch.set_num_threads(1)

_G = constants.GeomType
# the batch axis of the port's call: case i of a pair's k cases and case
# i + k share their sizes, as the envs of a batch share the model's
B = 2
# a stacker box's half size
BOX = .022


def _quat_mat(q):
  q = np.asarray(q, dtype=np.float64)
  w, x, y, z = q / np.linalg.norm(q)
  return np.array([
      [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _about_y(angle):
  """The frame of a body turned by `angle` on a hinge along y (the planar
  arm's and the props' axis)."""
  return _quat_mat([np.cos(angle / 2), 0.0, np.sin(angle / 2), 0.0])


def _random_mat(rng):
  return _quat_mat(rng.normal(size=4))


def _case(p1, m1, s1, p2, m2, s2):
  return tuple(np.asarray(v, dtype=np.float64)
               for v in (p1, m1, s1, p2, m2, s2))


def _plane_box_cases(rng):
  eye = np.eye(3)
  plane = np.zeros(3)
  cases = []
  for i in range(8):
    size = rng.uniform(.01, .1, 3)
    # flat on the floor, in frames with exact zeros (a box that rests
    # flat): four bottom corners of one height, the four-way tie; turned
    # about z, or a quarter turn about y; touching, a hair deep, or above
    c, s = np.cos(i / 3), np.sin(i / 3)
    if i % 2:
      flat, half = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]), size[2]
    else:
      flat, half = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]]), size[0]
    z = half * [1.0, 0.999, 1.2, 0.98][i % 4]
    cases.append(_case(plane, eye, [0, 0, 1],
                       [rng.uniform(-1, 1), rng.uniform(-1, 1), z], flat,
                       size))
  for _ in range(8):
    # any pose against a tilted plane
    size = rng.uniform(.01, .1, 3)
    cases.append(_case(rng.normal(size=3) * .1, _random_mat(rng), [0, 0, 1],
                       rng.normal(size=3) * .1, _random_mat(rng), size))
  return cases


def _sphere_box_cases(rng):
  cases = []
  for i in range(12):
    size = rng.uniform(.02, .1, 3)
    box_mat = _random_mat(rng)
    r = rng.uniform(.005, .03)
    if i < 4:
      # the centre inside the box, nearer one face than the others
      local = rng.uniform(-.8, .8, 3) * size
    elif i < 8:
      # outside a face, an edge or a corner, touching or not
      local = size * rng.choice([-1, 1], 3) * rng.uniform(.9, 1.3, 3)
    else:
      local = rng.normal(size=3) * .2
    centre = np.ones(3) * .1
    cases.append(_case(centre + box_mat @ local, np.eye(3), [r, 0, 0],
                       centre, box_mat, size))
  return cases


def _capsule_box_cases(rng):
  cases = []
  for i in range(12):
    size = rng.uniform(.02, .1, 3)
    box_mat = _random_mat(rng)
    r, half = rng.uniform(.004, .01), rng.uniform(.02, .08)
    if i < 6:
      # across a face: its axis through the face, one end inside
      axis = rng.choice(3)
      local = rng.uniform(-.5, .5, 3) * size
      local[axis] = size[axis] * rng.choice([-1, 1])
      cap_mat = box_mat @ _random_mat(rng)
      centre = box_mat @ local + cap_mat[:, 2] * half * .3
    else:
      centre = rng.normal(size=3) * .1
      cap_mat = _random_mat(rng)
    cases.append(_case(centre, cap_mat, [r, half, 0], np.zeros(3), box_mat,
                       size))
  return cases


def _box_box_cases(rng):
  box = [BOX] * 3
  cases = []
  # the aligned stack stacker builds: equal boxes, one on the other,
  # unturned or both turned by one angle about y, shifted along x, at rest
  # or a hair deep
  for angle, dx, gap in ((0.0, 0.0, 0.0), (0.0, .01, -.001),
                         (.3, -.005, -.0005), (np.pi / 2, .015, .0002)):
    mat = _about_y(angle)
    lower = np.array([.1, 0, BOX])
    upper = lower + mat @ np.array([dx, 0, 2 * BOX + gap])
    cases.append(_case(lower, mat, box, upper, mat, box))
  # face contacts of unequal, slightly turned boxes
  for _ in range(4):
    s1, s2 = rng.uniform(.02, .06, 3), rng.uniform(.02, .06, 3)
    m1 = _random_mat(rng)
    m2 = m1 @ _quat_mat([1, *rng.normal(size=3) * .05])
    axis = rng.choice(3)
    offset = np.zeros(3)
    offset[axis] = (s1[axis] + s2[axis] * .98) * rng.choice([-1, 1])
    offset += rng.uniform(-.3, .3, 3) * s1 * (np.arange(3) != axis)
    cases.append(_case(np.zeros(3), m1, s1, m1 @ offset, m2, s2))
  # edge against edge: boxes turned 45 degrees about two axes
  for i in range(4):
    s1, s2 = rng.uniform(.02, .05, 3), rng.uniform(.02, .05, 3)
    m1 = _quat_mat([np.cos(np.pi / 8), np.sin(np.pi / 8), 0, 0])
    m2 = _quat_mat([np.cos(np.pi / 8), 0, 0, np.sin(np.pi / 8)])
    m1, m2 = (m1, m2) if i % 2 else (_random_mat(rng), _random_mat(rng))
    direction = rng.normal(size=3)
    direction /= np.linalg.norm(direction)
    reach = np.linalg.norm(s1) + np.linalg.norm(s2)
    cases.append(_case(np.zeros(3), m1, s1, direction * reach * .75, m2,
                       s2))
  # separated, and any pose
  for far in (True, True, False, False):
    s1, s2 = rng.uniform(.02, .06, 3), rng.uniform(.02, .06, 3)
    p2 = rng.normal(size=3) * (.5 if far else .04)
    cases.append(_case(np.zeros(3), _random_mat(rng), s1, p2,
                       _random_mat(rng), s2))
  return cases


PAIRS = {
    'plane-box': ((_G.PLANE, _G.BOX), _plane_box_cases,
                  jcollision._plane_box, tcollision._plane_box),
    'sphere-box': ((_G.SPHERE, _G.BOX), _sphere_box_cases,
                   jcollision._sphere_box, tcollision._sphere_box),
    'capsule-box': ((_G.CAPSULE, _G.BOX), _capsule_box_cases,
                    jcollision._capsule_box, tcollision._capsule_box),
    'box-box': ((_G.BOX, _G.BOX), _box_box_cases, jcollision._box_box,
                tcollision._box_box),
}


@functools.lru_cache(maxsize=None)
def _inputs(name):
  """(cases for the JAX side, each (6,) arrays, stacked; the port's
  inputs: (B, k, ...) poses and (k, 3) sizes). Case i and i + k carry
  the same sizes."""
  rng = np.random.default_rng(sorted(PAIRS).index(name) + 11)
  cases = PAIRS[name][1](rng)
  k = len(cases)
  # the second half of the batch: the same sizes, other poses
  rng2 = np.random.default_rng(sorted(PAIRS).index(name) + 41)
  second = PAIRS[name][1](rng2)
  second = [c[:2] + (cases[i][2],) + c[3:5] + (cases[i][5],)
            for i, c in enumerate(second)]
  flat = [np.stack([c[j] for c in cases + second]) for j in range(6)]
  port = [torch.as_tensor(v.reshape((B, k) + v.shape[1:])) for v in flat]
  port[2], port[5] = port[2][0], port[5][0]
  return flat, port


@pytest.mark.parametrize('name', sorted(PAIRS))
def test_box_pair_matches_jax(name):
  """Every case of the pair: dist, pos and normal slot by slot at
  TOL_SMOOTH, with the slot count of _PAIR_NCON; the cases reach
  contacts (negative dist) and non-contacts, and box-box reaches its face
  and edge branches and its separated result."""
  key, _, jfn, tfn = PAIRS[name]
  flat, port = _inputs(name)
  with jax.enable_x64(True):
    want = jax.jit(jax.vmap(jfn))(*[jnp.asarray(v) for v in flat])
    want = [np.asarray(w) for w in want]
  got = tfn(*port)
  n = flat[0].shape[0]
  K = _PAIR_NCON[key]
  for label, w, g in zip(('dist', 'pos', 'normal'), want, got):
    g = np_(g).reshape((n,) + g.shape[2:])
    assert g.shape == w.shape == (n, K) + w.shape[2:], (label, g.shape)
    assert_close(g, w, TOL_SMOOTH, f'{name} {label}')
  dist = want[0]
  touching = (dist < 0).any(axis=1)
  assert touching.sum() >= n // 4 and (~touching).sum() >= 2, touching
  if name == 'box-box':
    live = (dist < 1e9).sum(axis=1)
    assert (live == 0).any()                 # separated
    assert (live == 1).any()                 # an edge pair
    assert (live >= 4).any()                 # a face patch
  if name == 'plane-box':
    # the flat boxes' four slots are their four bottom corners, in corner
    # order (the stable sort over exact ties)
    assert (np.ptp(dist[:8], axis=1) < 1e-15).all()


@pytest.mark.parametrize('task', ['insert_peg', 'stack_2'])
def test_control_steps_match_jax(task):
  check_control_steps(task)
