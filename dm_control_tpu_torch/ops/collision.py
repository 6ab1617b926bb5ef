"""Narrowphase collision into static contact slots, batched.

Port of dm_control_tpu/ops/collision.py for its primitive pairs. Closed
forms: plane against sphere, capsule, cylinder, ellipsoid and box; sphere
against sphere, capsule, cylinder, ellipsoid and box; capsule against
capsule, cylinder and box; box against box (separating axes, then
face-patch samples or an edge pair's closest points). The box pairs are the
JAX package's approximations, copied as they are: plane-box keeps the four
deepest corners, capsule-box is a sphere-box contact at each end of the
capsule. Other pairs of primitive convex geoms (capsule-ellipsoid,
ellipsoid-cylinder, cylinder-box, ...) go through Minkowski portal
refinement (ops/mpr.py), as in the JAX package. The candidate list and slot
layout are the model's static ones; when the model compacts its slots
(ncon_sel < ncon_max) the deepest slots of each condim group are kept, in
the same order as the JAX package (a stable descending sort, lower slot
first among equals). Meshes and heightfields raise NotImplementedError.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from dm_control_tpu_torch.models import constants
from dm_control_tpu_torch.models.compiler import _PAIR_NCON
from dm_control_tpu_torch.models.types import Data, Model
from dm_control_tpu_torch.ops import math as mops
from dm_control_tpu_torch.ops import mpr

_G = constants.GeomType

_BIG = 1e10

# Each function: (pos1, mat1, size1, pos2, mat2, size2) with leading dims
# (B, k) on positions/matrices and (k, 3) on sizes ->
#   (dist (B, k, K), pos (B, k, K, 3), normal (B, k, K, 3)), normal from
# geom1 to geom2.


def _plane_sphere(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  h = mops.dot(n, p2 - p1)
  r = s2[..., 0]
  dist = h - r
  pos = p2 - n * ((h + r) * 0.5)[..., None]
  return dist[..., None], pos[..., None, :], n[..., None, :]


def _plane_capsule(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  axis = m2[..., :, 2]
  r, half = s2[..., 0], s2[..., 1]
  ends = torch.stack([p2 + axis * half[..., None],
                      p2 - axis * half[..., None]], dim=-2)
  h = mops.dot(ends, n[..., None, :]) - mops.dot(p1, n)[..., None]
  dist = h - r[..., None]
  pos = ends - n[..., None, :] * ((h + r[..., None]) * 0.5)[..., None]
  return dist, pos, torch.stack([n, n], dim=-2)


def _to_local(mat, v):
  """mat' v over the leading dims."""
  return torch.einsum('...ji,...j->...i', mat, v)


def _to_world(mat, v):
  return torch.einsum('...ij,...j->...i', mat, v)


def _plane_cylinder(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  axis = m2[..., :, 2]
  r, half = s2[..., 0, None], s2[..., 1, None]
  # the end cap facing the plane
  na = mops.dot(n, axis)
  center = p2 - axis * (half * torch.sign(na + 1e-12)[..., None])
  # rim direction: steepest descent along -n in the cap plane
  t = axis * na[..., None] - n
  tn = mops.norm(t, keepdim=True)
  t = torch.where(tn > 1e-8, t / torch.clamp(tn, min=1e-12),
                  mops.make_frame(axis)[..., 1, :])
  u = mops.cross(axis, t)
  pts = torch.stack([center + r * t, center - r * t, center + r * u,
                     center - r * u], dim=-2)
  h = mops.dot(pts, n[..., None, :]) - mops.dot(p1, n)[..., None]
  pos = pts - n[..., None, :] * (h * 0.5)[..., None]
  return h, pos, n[..., None, :].expand(pos.shape)


def _plane_ellipsoid(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  sn = s2 * _to_local(m2, n)
  support = mops.norm(sn, keepdim=True)
  # deepest point of the ellipsoid's surface along -n
  point = p2 + _to_world(m2, -(s2 * sn) / torch.clamp(support, min=1e-12))
  h = mops.dot(n, point - p1)
  pos = point - n * (h * 0.5)[..., None]
  return h[..., None], pos[..., None, :], n[..., None, :]


def _sphere_sphere(p1, m1, s1, p2, m2, s2):
  dif = p2 - p1
  dist = mops.norm(dif)
  n = dif / torch.clamp(dist, min=1e-12)[..., None]
  up = torch.zeros_like(n)
  up[..., 2] = 1.0
  n = torch.where((dist < 1e-12)[..., None], up, n)
  r1 = s1[..., 0]
  pen = dist - r1 - s2[..., 0]
  pos = p1 + n * (r1 + 0.5 * pen)[..., None]
  return pen[..., None], pos[..., None, :], n[..., None, :]


def _sphere_capsule(p1, m1, s1, p2, m2, s2):
  axis = m2[..., :, 2]
  half = s2[..., 1][..., None]
  seg_pt = mops.closest_segment_point(p2 - axis * half, p2 + axis * half, p1)
  return _sphere_sphere(p1, m1, s1, seg_pt, m2, s2)


def _sphere_cylinder(p1, m1, s1, p2, m2, s2):
  # the sphere's center clamped into the cylinder's solid volume
  local = _to_local(m2, p1 - p2)
  r, half = s2[..., 0], s2[..., 1]
  rad = mops.norm(local[..., :2], keepdim=True)
  xy = local[..., :2] * torch.clamp(
      r[..., None] / torch.clamp(rad, min=1e-12), max=1.0)
  z = torch.maximum(torch.minimum(local[..., 2], half), -half)
  surf = p2 + _to_world(m2, torch.cat([xy, z[..., None]], dim=-1))
  dif = surf - p1
  dist = mops.norm(dif)
  n = dif / torch.clamp(dist, min=1e-12)[..., None]
  pen = dist - s1[..., 0]
  pos = surf - n * (0.5 * pen)[..., None]
  return pen[..., None], pos[..., None, :], n[..., None, :]


def _sphere_ellipsoid(p1, m1, s1, p2, m2, s2):
  # the sphere's center projected radially in the ellipsoid's scaled space
  local = _to_local(m2, p1 - p2)
  nrm = mops.norm(local / torch.clamp(s2, min=1e-12), keepdim=True)
  surface = p2 + _to_world(m2, local / torch.clamp(nrm, min=1e-12))
  dif = p1 - surface
  dist = mops.norm(dif)
  outside = nrm[..., 0] > 1.0
  n = dif / torch.clamp(dist, min=1e-12)[..., None] * torch.where(
      outside, -1.0, 1.0).to(dist.dtype)[..., None]
  pen = torch.where(outside, dist, -dist) - s1[..., 0]
  pos = surface - n * (0.5 * pen)[..., None]
  return pen[..., None], pos[..., None, :], -n[..., None, :]


def _capsule_capsule(p1, m1, s1, p2, m2, s2):
  a1, h1 = m1[..., :, 2], s1[..., 1][..., None]
  a2, h2 = m2[..., :, 2], s2[..., 1][..., None]
  e1a, e1b = p1 - a1 * h1, p1 + a1 * h1
  e2a, e2b = p2 - a2 * h2, p2 + a2 * h2
  c1, c2 = mops.closest_segment_segment(e1a, e1b, e2a, e2b)
  d0, pos0, n0 = _sphere_sphere(c1, m1, s1, c2, m2, s2)
  # second slot (inactive unless near-parallel and deep): midpoints
  mid1 = 0.5 * (c1 + p1)
  c2b = mops.closest_segment_point(e2a, e2b, mid1)
  c1c = mops.closest_segment_point(e1a, e1b, c2b)
  d1, pos1, n1 = _sphere_sphere(c1c, m1, s1, c2b, m2, s2)
  dup = mops.norm(pos1[..., 0, :] - pos0[..., 0, :]) < 0.25 * (
      s1[..., 0] + s2[..., 0])
  d1 = torch.where(dup[..., None], torch.full_like(d1, _BIG), d1)
  return (torch.cat([d0, d1], dim=-1), torch.cat([pos0, pos1], dim=-2),
          torch.cat([n0, n1], dim=-2))


def _capsule_cylinder(p1, m1, s1, p2, m2, s2):
  # a sphere at each end of the capsule's segment
  a1, h1 = m1[..., :, 2], s1[..., 1, None]
  da, posa, na = _sphere_cylinder(p1 - a1 * h1, m1, s1, p2, m2, s2)
  db, posb, nb = _sphere_cylinder(p1 + a1 * h1, m1, s1, p2, m2, s2)
  return (torch.cat([da, db], dim=-1), torch.cat([posa, posb], dim=-2),
          torch.cat([na, nb], dim=-2))


# the eight corners of a box as signs, x slowest (the JAX package's order)
_CORNER_SIGNS = [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                 for sz in (-1, 1)]


def _take(x, i):
  """x[..., i, :] with a per-(B, k) index i ((B, k) ints), x (B, k, m, c)
  or x[..., i] for x (B, k, m)."""
  if x.dim() == i.dim() + 1:
    return torch.gather(x, -1, i[..., None])[..., 0]
  idx = i[..., None, None].expand(i.shape + (1, x.shape[-1]))
  return torch.gather(x, -2, idx)[..., 0, :]


def _onehot(i, dtype=None):
  """(B, k, 3) bool (or `dtype`) one-hot rows of axis indices i."""
  oh = torch.nn.functional.one_hot(i, 3).bool()
  return oh if dtype is None else oh.to(dtype)


def _plane_box(p1, m1, s1, p2, m2, s2):
  # the four deepest of the eight corners (a stable sort: a box lying flat
  # keeps its bottom corners in corner order, as jnp.argsort does)
  n = m1[..., :, 2]
  signs = torch.as_tensor(_CORNER_SIGNS, dtype=p2.dtype, device=p2.device)
  corners = p2[..., None, :] + (signs * s2[..., None, :3]) @ m2.transpose(
      -1, -2)
  h = mops.dot(corners, n[..., None, :]) - mops.dot(p1, n)[..., None]
  idx = torch.sort(h, dim=-1, stable=True)[1][..., :4]
  hh = torch.gather(h, -1, idx)
  pos = torch.gather(corners, -2, idx[..., None].expand(idx.shape + (3,)))
  pos = pos - n[..., None, :] * (hh * 0.5)[..., None]
  return hh, pos, n[..., None, :].expand(pos.shape)


def _sphere_box(p1, m1, s1, p2, m2, s2):
  local = _to_local(m2, p1 - p2)
  half = s2[..., :3]
  clamped = torch.minimum(torch.maximum(local, -half), half)
  inside = torch.all(torch.abs(local) < half, dim=-1)
  # inside: push out through the nearest face
  gaps = half - torch.abs(local)
  ax = _onehot(torch.argmin(gaps, dim=-1))
  face = torch.where(ax, torch.sign(local) * half, clamped)
  surface = p2 + _to_world(m2, torch.where(inside[..., None], face, clamped))
  dif = surface - p1
  dist = mops.norm(dif)
  n_out = dif / torch.clamp(dist, min=1e-12)[..., None]
  n = torch.where(inside[..., None], -n_out, n_out)
  r = s1[..., 0]
  pen = torch.where(inside, -dist - r, dist - r)
  pos = surface - n * (0.5 * pen)[..., None]
  return pen[..., None], pos[..., None, :], n[..., None, :]


def _capsule_box(p1, m1, s1, p2, m2, s2):
  # a sphere-box contact at each end of the capsule's segment (the JAX
  # package's approximation, not MuJoCo's capsule-box)
  a1, h1 = m1[..., :, 2], s1[..., 1, None]
  da, posa, na = _sphere_box(p1 - a1 * h1, m1, s1, p2, m2, s2)
  db, posb, nb = _sphere_box(p1 + a1 * h1, m1, s1, p2, m2, s2)
  return (torch.cat([da, db], dim=-1), torch.cat([posa, posb], dim=-2),
          torch.cat([na, nb], dim=-2))


def _box_face_contacts(ref_half, inc_half, rot_ri, t_ri, k, sign):
  """Up to 8 contacts of an incident box on face k of a reference box at
  the origin, in the reference frame (the JAX package's face-patch
  sampling). rot_ri (B, k, 3, 3) takes incident-frame vectors to the
  reference frame, t_ri (B, k, 3) is the incident centre, k (B, k) the
  face axis and sign (B, k) the side of the face normal that points at
  the incident box. Returns (dist (B, k, 8), pos (B, k, 8, 3))."""
  shape = t_ri.shape
  ref_half = torch.broadcast_to(ref_half, shape)
  inc_half = torch.broadcast_to(inc_half, shape)
  u, v = (k + 1) % 3, (k + 2) % 3
  # the incident face: the incident axis most anti-parallel to the normal
  n_in_inc = sign[..., None] * _take(rot_ri, k)
  inc_axis = torch.argmax(torch.abs(n_in_inc), dim=-1)
  inc_sign = -_take(torch.sign(n_in_inc), inc_axis)
  onehot = _onehot(inc_axis, t_ri.dtype)
  fc = (inc_sign * _take(inc_half, inc_axis))[..., None] * onehot
  au, av = (inc_axis + 1) % 3, (inc_axis + 2) % 3
  iu = _onehot(au, t_ri.dtype) * _take(inc_half, au)[..., None]
  iv = _onehot(av, t_ri.dtype) * _take(inc_half, av)[..., None]
  quad_inc = torch.stack([fc + iu + iv, fc - iu + iv, fc - iu - iv,
                          fc + iu - iv], dim=-2)
  quad = quad_inc @ rot_ri.transpose(-1, -2) + t_ri[..., None, :]

  # the incident plane in the reference frame: w . x = w . q0
  w = _to_world(rot_ri, inc_sign[..., None] * onehot)
  wq0 = mops.dot(w, quad[..., 0, :])
  w_k, w_u, w_v = _take(w, k), _take(w, u), _take(w, v)
  wk = torch.where(torch.abs(w_k) < 1e-8,
                   torch.sign(w_k + 1e-30) * 1e-8, w_k)

  def plane_coord(pu, pv):
    # x[k] on the incident plane at (x[u], x[v]) = (pu, pv)
    return ((wq0[..., None] - w_u[..., None] * pu - w_v[..., None] * pv) /
            wk[..., None])

  hu, hv, hk = _take(ref_half, u), _take(ref_half, v), _take(ref_half, k)
  qu = _take(quad, u[..., None].expand(u.shape + (4,)))
  qv = _take(quad, v[..., None].expand(v.shape + (4,)))
  # candidates 0-3: the incident corners clamped into the reference face
  cu = torch.minimum(torch.maximum(qu, -hu[..., None]), hu[..., None])
  cv = torch.minimum(torch.maximum(qv, -hv[..., None]), hv[..., None])
  ck = plane_coord(cu, cv)
  # candidates 4-7: the reference face's corners inside the incident
  # quad's (u, v) projection
  su = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=t_ri.dtype,
                    device=t_ri.device)
  sv = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=t_ri.dtype,
                    device=t_ri.device)
  ru, rv = su * hu[..., None], sv * hv[..., None]
  rk = plane_coord(ru, rv)
  # point in quad: every edge's cross product of one sign
  cross = torch.stack([
      (qu[..., (e + 1) % 4] - qu[..., e])[..., None] * (
          rv - qv[..., e, None]) -
      (qv[..., (e + 1) % 4] - qv[..., e])[..., None] * (
          ru - qu[..., e, None]) for e in range(4)], dim=-1)
  ok_ref = (torch.all(cross >= -1e-9, dim=-1) |
            torch.all(cross <= 1e-9, dim=-1))
  ok = torch.cat([torch.ones_like(ok_ref), ok_ref], dim=-1)
  cand_u = torch.cat([cu, ru], dim=-1)[..., None]          # (B, k, 8, 1)
  cand_v = torch.cat([cv, rv], dim=-1)[..., None]
  cand_k = torch.cat([ck, rk], dim=-1)[..., None]
  is_u = _onehot(u)[..., None, :]
  is_v = _onehot(v)[..., None, :]
  is_k = _onehot(k)[..., None, :]
  pts = torch.where(is_u, cand_u, torch.where(is_v, cand_v, cand_k))
  depth = sign[..., None] * cand_k[..., 0] - hk[..., None]  # < 0: overlap
  dist = torch.where(ok, depth, torch.full_like(depth, _BIG))
  # the contact point midway between the point and the reference face
  proj = torch.where(is_k, (sign * hk)[..., None, None], pts)
  return dist, 0.5 * (pts + proj)


def _box_box(p1, m1, s1, p2, m2, s2):
  """Separating axes, then the face-patch samples of the best face axis
  or the closest points of the best edge pair (the JAX package's
  approximation of polygon clipping, alike for aligned stacks)."""
  a, b = s1[..., :3], s2[..., :3]
  c = m1.transpose(-1, -2) @ m2          # B-frame vectors into A's frame
  t = _to_local(m1, p2 - p1)             # B's centre in A's frame
  absc = torch.abs(c) + 1e-9
  sep_a = torch.abs(t) - (a + (absc @ b[..., None])[..., 0])
  t_b = _to_local(c, t)
  sep_b = torch.abs(t_b) - (b + (absc.transpose(-1, -2) @ a[..., None])[
      ..., 0])

  eye = torch.eye(3, dtype=t.dtype, device=t.device)
  edge_seps, edge_axes = [], []
  for i in range(3):
    for j in range(3):
      axis = mops.cross(eye[i].expand(t.shape), c[..., :, j])
      nrm = mops.norm(axis)
      inv = torch.clamp(nrm, min=1e-12)
      axis_n = axis / inv[..., None]
      i1, i2, j1, j2 = (i + 1) % 3, (i + 2) % 3, (j + 1) % 3, (j + 2) % 3
      ra = (a[..., i1] * absc[..., i2, j] + a[..., i2] * absc[..., i1, j]) / inv
      rb = (b[..., j1] * absc[..., i, j2] + b[..., j2] * absc[..., i, j1]) / inv
      sep = torch.abs(mops.dot(t, axis_n)) - (ra + rb)
      edge_seps.append(torch.where(nrm > 1e-6, sep,
                                   torch.full_like(sep, -_BIG)))
      edge_axes.append(axis_n)
  edge_seps = torch.stack(edge_seps, dim=-1)         # (B, k, 9)
  edge_axes = torch.stack(edge_axes, dim=-2)         # (B, k, 9, 3)

  face_seps = torch.cat([sep_a, sep_b], dim=-1)      # (B, k, 6)
  separated = torch.maximum(face_seps.amax(-1), edge_seps.amax(-1)) > 0
  # argmax takes the first of equal maxima, as jnp.argmax does
  best_face = torch.argmax(face_seps, dim=-1)
  best_edge = torch.argmax(edge_seps, dim=-1)
  # a face contact unless an edge axis is clearly better
  use_edge = _take(edge_seps, best_edge) > _take(face_seps, best_face) + 1e-9
  a_is_ref = best_face < 3
  ref = torch.where(a_is_ref, best_face, best_face - 3)
  e_ref = _onehot(ref, t.dtype)

  sign_a = torch.sign(_take(t, ref) + 1e-30)
  dist_fa, pos_fa = _box_face_contacts(a, b, c, t, ref, sign_a)
  pos_fa = pos_fa @ m1.transpose(-1, -2) + p1[..., None, :]
  n_fa = _to_world(m1, sign_a[..., None] * e_ref)
  side_b = torch.sign(_take(t_b, ref) + 1e-30)
  dist_fb, pos_fb = _box_face_contacts(b, a, c.transpose(-1, -2), -t_b, ref,
                                       -side_b)
  pos_fb = pos_fb @ m2.transpose(-1, -2) + p2[..., None, :]
  n_fb = _to_world(m2, side_b[..., None] * e_ref)
  dist_face = torch.where(a_is_ref[..., None], dist_fa, dist_fb)
  pos_face = torch.where(a_is_ref[..., None, None], pos_fa, pos_fb)
  n_face = torch.where(a_is_ref[..., None], n_fa, n_fb)

  # edge-edge: the closest points of the two boxes' edges along the axis
  i_e, j_e = best_edge // 3, best_edge % 3
  axis_e = _take(edge_axes, best_edge)
  axis_e = axis_e * torch.sign(mops.dot(axis_e, t) + 1e-30)[..., None]
  oh_i, oh_j = _onehot(i_e), _onehot(j_e)
  corner_a = torch.where(oh_i, torch.zeros_like(axis_e),
                         torch.sign(axis_e) * a)
  axis_e_b = _to_local(c, axis_e)
  corner_b = _to_world(c, torch.where(oh_j, torch.zeros_like(axis_e),
                                      -torch.sign(axis_e_b) * b)) + t
  dir_a = oh_i.to(t.dtype)
  dir_b = _take(c.transpose(-1, -2), j_e)
  ha = _take(torch.broadcast_to(a, t.shape), i_e)[..., None]
  hb = _take(torch.broadcast_to(b, t.shape), j_e)[..., None]
  pa, pb = mops.closest_segment_segment(
      corner_a - dir_a * ha, corner_a + dir_a * ha,
      corner_b - dir_b * hb, corner_b + dir_b * hb)
  dist_edge = _take(edge_seps, best_edge)
  pos_edge = _to_world(m1, 0.5 * (pa + pb)) + p1
  n_edge = _to_world(m1, axis_e)

  first = torch.arange(8, device=t.device) == 0
  dist_e8 = torch.where(first, dist_edge[..., None], _BIG)
  pos_e8 = torch.where(first[:, None], pos_edge[..., None, :], 0.0)
  dist8 = torch.where(use_edge[..., None], dist_e8, dist_face)
  pos8 = torch.where(use_edge[..., None, None], pos_e8, pos_face)
  n8 = torch.where(use_edge[..., None], n_edge, n_face)[..., None, :].expand(
      pos8.shape)
  dist8 = torch.where(separated[..., None], _BIG, dist8)
  return dist8, pos8, n8


_FUNCS = {
    (_G.PLANE, _G.SPHERE): _plane_sphere,
    (_G.PLANE, _G.CAPSULE): _plane_capsule,
    (_G.PLANE, _G.ELLIPSOID): _plane_ellipsoid,
    (_G.PLANE, _G.CYLINDER): _plane_cylinder,
    (_G.PLANE, _G.BOX): _plane_box,
    (_G.SPHERE, _G.SPHERE): _sphere_sphere,
    (_G.SPHERE, _G.CAPSULE): _sphere_capsule,
    (_G.SPHERE, _G.ELLIPSOID): _sphere_ellipsoid,
    (_G.SPHERE, _G.CYLINDER): _sphere_cylinder,
    (_G.SPHERE, _G.BOX): _sphere_box,
    (_G.CAPSULE, _G.CAPSULE): _capsule_capsule,
    (_G.CAPSULE, _G.CYLINDER): _capsule_cylinder,
    (_G.CAPSULE, _G.BOX): _capsule_box,
    (_G.BOX, _G.BOX): _box_box,
}

# primitive pairs that have no closed form in the JAX package either: one
# contact slot each, found by MPR (ops/mpr.py)
_MPR_PAIRS = frozenset([
    (_G.CAPSULE, _G.ELLIPSOID), (_G.ELLIPSOID, _G.ELLIPSOID),
    (_G.ELLIPSOID, _G.CYLINDER), (_G.ELLIPSOID, _G.BOX),
    (_G.CYLINDER, _G.CYLINDER), (_G.CYLINDER, _G.BOX)])


def _merge_params(m: Model, cand: List[int]):
  """Merged contact parameters (margin, gap, friction, solref, solimp)
  per candidate pair; the winner of a priority contest, else max
  friction and solmix-weighted solref/solimp; explicit pairs override."""
  g1 = np.asarray([m.cpair_geom1[ci] for ci in cand], dtype=np.int64)
  g2 = np.asarray([m.cpair_geom2[ci] for ci in cand], dtype=np.int64)
  exp = np.asarray([m.cpair_explicit[ci] for ci in cand], dtype=np.int64)
  prio = np.asarray(m.geom_priority)
  p1, p2 = prio[g1], prio[g2]
  ix = lambda a: torch.as_tensor(a, device=m.device)
  g1t, g2t = ix(g1), ix(g2)

  gm, gg, gf = m.geom_margin, m.geom_gap, m.geom_friction
  gr, gi, gs = m.geom_solref, m.geom_solimp, m.geom_solmix
  mrg = torch.maximum(gm[g1t], gm[g2t])
  gap = torch.maximum(gg[g1t], gg[g2t])
  src = ix(np.where(p1 > p2, g1, g2))
  pr = ix((p1 != p2)[:, None])
  f3w, rw, iw_ = gf[src], gr[src], gi[src]
  f3m = torch.maximum(gf[g1t], gf[g2t])
  s1, s2 = gs[g1t], gs[g2t]
  tot = torch.clamp(s1 + s2, min=1e-12)
  one, zero = torch.ones_like(s1), torch.zeros_like(s1)
  w1 = torch.where((s1 < 1e-12) & (s2 < 1e-12), 0.5 * one,
                   torch.where(s1 < 1e-12, zero,
                               torch.where(s2 < 1e-12, one, s1 / tot)))
  r1, r2 = gr[g1t], gr[g2t]
  mix = w1[:, None] * r1 + (1 - w1)[:, None] * r2
  direct = ((r1[:, 0] <= 0) | (r2[:, 0] <= 0))[:, None]
  rm = torch.where(direct, torch.minimum(r1, r2), mix)
  im = w1[:, None] * gi[g1t] + (1 - w1)[:, None] * gi[g2t]
  f3 = torch.where(pr, f3w, f3m)
  sref = torch.where(pr, rw, rm)
  simp = torch.where(pr, iw_, im)
  fric = torch.stack([f3[:, 0], f3[:, 0], f3[:, 1], f3[:, 2], f3[:, 2]],
                     dim=1)
  if np.any(exp >= 0):
    e = ix(np.maximum(exp, 0))
    emask = ix(exp >= 0)
    mrg = torch.where(emask, m.xpair_margin[e], mrg)
    gap = torch.where(emask, m.xpair_gap[e], gap)
    fric = torch.where(emask[:, None], m.xpair_friction[e], fric)
    sref = torch.where(emask[:, None], m.xpair_solref[e], sref)
    simp = torch.where(emask[:, None], m.xpair_solimp[e], simp)
  return mrg, gap, fric, sref, simp


def _plan(m: Model):
  """Static narrowphase plan: per type group (fn, geom ids, slot ids, K),
  the env-independent per-slot parameter table, and the compaction
  groups."""

  def make():
    ncand = len(m.cpair_geom1)
    groups: Dict[Tuple[int, int], List[int]] = {}
    slot_of = []
    off = 0
    for ci in range(ncand):
      key = (m.geom_type[m.cpair_geom1[ci]], m.geom_type[m.cpair_geom2[ci]])
      groups.setdefault(key, []).append(ci)
      slot_of.append(off)
      off += _PAIR_NCON[key]
    ix = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=m.device)
    dtype, dev = m.dtype, m.device
    nmax = m.ncon_max
    imargin = torch.zeros(nmax, dtype=dtype, device=dev)
    igap = torch.zeros(nmax, dtype=dtype, device=dev)
    friction = torch.ones((nmax, 5), dtype=dtype, device=dev)
    solref = torch.tensor([0.02, 1.0], dtype=dtype, device=dev).repeat(
        nmax, 1)
    solimp = torch.tensor([0.9, 0.95, 0.001, 0.5, 2.0], dtype=dtype,
                          device=dev).repeat(nmax, 1)
    cap_tangent = np.zeros(nmax, dtype=bool)
    calls = []
    for (t1, t2), cand in groups.items():
      # merged first: the margin inflates the MPR supports
      mrg, gap, fric, sref, simp = _merge_params(m, cand)
      if (t1, t2) in _FUNCS:
        fn = _FUNCS[(t1, t2)]
      elif (t1, t2) in _MPR_PAIRS:
        fn = functools.partial(mpr.collide, t1, t2, margin=mrg)
      else:
        raise NotImplementedError(
            f'no ported narrowphase for geom types '
            f'({_G(t1).name.lower()}, {_G(t2).name.lower()})')
      k = _PAIR_NCON[(t1, t2)]
      slots = ix([slot_of[ci] + j for ci in cand for j in range(k)])
      calls.append((fn, ix([m.cpair_geom1[ci] for ci in cand]),
                    ix([m.cpair_geom2[ci] for ci in cand]), slots))
      rep = lambda x: torch.repeat_interleave(x, k, dim=0)
      imargin[slots] = rep(mrg)
      igap[slots] = rep(gap)
      friction[slots] = rep(fric)
      solref[slots] = rep(sref)
      solimp[slots] = rep(simp)
      if (t1, t2) == (_G.PLANE, _G.CAPSULE):
        for ci in cand:
          cap_tangent[slot_of[ci]:slot_of[ci] + k] = True
    select = []
    if m.ncon_sel < m.ncon_max:
      for cdim in sorted(set(m.pair_condim)):
        grp = [s for s in range(nmax) if m.pair_condim[s] == cdim]
        k_c = sum(1 for s in m.sel_condim if s == cdim)
        select.append((ix(grp), k_c))
    params = dict(imargin=imargin, igap=igap, friction=friction,
                  solref=solref, solimp=solimp,
                  cap=torch.as_tensor(cap_tangent, device=dev),
                  g1=ix(m.pair_geom1), g2=ix(m.pair_geom2))
    return calls, params, select, bool(np.any(cap_tangent))

  return m.memo('collision_plan', make)


def collision(m: Model, d: Data) -> Data:
  """Narrowphase over all candidate pairs, then per-condim compaction."""
  if not len(m.cpair_geom1):
    return d
  B, dtype, dev = d.qpos.shape[0], d.qpos.dtype, d.qpos.device
  calls, params, select, any_cap = _plan(m)
  nmax = m.ncon_max
  dist = torch.full((B, nmax), _BIG, dtype=dtype, device=dev)
  pos = torch.zeros((B, nmax, 3), dtype=dtype, device=dev)
  normal = torch.zeros((B, nmax, 3), dtype=dtype, device=dev)
  normal[..., 2] = 1.0
  for fn, g1, g2, slots in calls:
    dd, pp, nn = fn(d.geom_xpos[:, g1], d.geom_xmat[:, g1], m.geom_size[g1],
                    d.geom_xpos[:, g2], d.geom_xmat[:, g2], m.geom_size[g2])
    dist[:, slots] = dd.reshape(B, -1)
    pos[:, slots] = pp.reshape(B, -1, 3)
    normal[:, slots] = nn.reshape(B, -1, 3)

  imargin = params['imargin'].expand(B, nmax)
  igap = params['igap'].expand(B, nmax)
  friction = params['friction'].expand(B, nmax, 5)
  solref = params['solref'].expand(B, nmax, 2)
  solimp = params['solimp'].expand(B, nmax, 5)
  g1s = params['g1'].expand(B, nmax)
  g2s = params['g2'].expand(B, nmax)
  cap = params['cap'].expand(B, nmax)
  active = dist < imargin
  overflow = torch.zeros(B, dtype=torch.bool, device=dev)

  if select:
    # keep the deepest k_c slots (largest margin - dist) of each group
    picks = []
    for grp, k_c in select:
      if k_c < len(grp):
        key = imargin[:, grp] - dist[:, grp]
        order = torch.sort(key, dim=-1, descending=True, stable=True)[1]
        picks.append(grp[order[:, :k_c]])
        overflow = overflow | (active[:, grp].sum(dim=-1) > k_c)
      else:
        picks.append(grp.expand(B, len(grp)))
    sel = torch.cat(picks, dim=-1)                     # (B, ncon_sel)
    take = lambda x: torch.gather(x, 1, sel)
    take3 = lambda x: torch.gather(
        x, 1, sel[..., None].expand(B, sel.shape[1], x.shape[-1]))
    dist, pos, normal, active = take(dist), take3(pos), take3(normal), take(
        active)
    imargin, igap = take(imargin), take(igap)
    friction, solref, solimp = take3(friction), take3(solref), take3(solimp)
    g1s, g2s, cap = take(g1s), take(g2s), take(cap)

  frame = mops.make_frame(normal)
  if any_cap:
    # plane-capsule slots align t1 with the capsule axis projected into
    # the plane (mjc_PlaneCapsule), unless it is perpendicular to it
    idx = g2s[..., None, None].expand(B, g2s.shape[1], 3, 3)
    caxis = torch.gather(d.geom_xmat, 1, idx)[..., :, 2]
    t_ip = caxis - normal * torch.sum(caxis * normal, dim=-1, keepdim=True)
    t_nrm = mops.norm(t_ip, keepdim=True)
    t1v = torch.where(cap[..., None] & (t_nrm > 1e-10),
                      t_ip / torch.clamp(t_nrm, min=1e-12), frame[..., 1, :])
    frame = torch.stack([normal, t1v, mops.cross(normal, t1v)], dim=-2)

  con = d.contact.replace(
      dist=dist, pos=pos, frame=frame, includemargin=imargin, gap=igap,
      friction=friction, solref=solref, solimp=solimp, active=active,
      geom1=g1s, geom2=g2s, overflow=overflow)
  return d.replace(contact=con)
