"""Convex-convex narrowphase by Minkowski portal refinement, batched.

Port of dm_control_tpu/ops/mpr.py (`_support_local`, `make_kernel`) for
primitive geoms: sphere, capsule, ellipsoid, cylinder and box. Convex mesh
hulls raise NotImplementedError. The portal discovery and refinement loops
run a fixed number of passes over the whole (B, k) batch of candidates,
each candidate masked once it is done, so the loops hold no
data-dependent branch and never wait for the device.

Both supports are inflated by margin / 2 along the query direction, so the
inflated shapes touch exactly when dist < margin, the activation rule of
the other narrowphase functions.
"""

from __future__ import annotations

import torch

from dm_control_tpu_torch.models import constants
from dm_control_tpu_torch.ops import math as mops

_G = constants.GeomType
_BIG = 1e10

_DISCOVERY_ITERS = 12
_REFINE_ITERS = 24

# geom types with a support function here
PRIMITIVES = (_G.SPHERE, _G.CAPSULE, _G.ELLIPSOID, _G.CYLINDER, _G.BOX)


def _support_local(gtype: int, size, d):
  """Support points (..., 3) of one geom type in its local frame for local
  directions d (..., 3); size broadcasts against d."""
  eps = 1e-12
  if gtype == _G.SPHERE:
    return size[..., 0, None] * (
        d / torch.clamp(mops.norm(d, keepdim=True), min=eps))
  if gtype == _G.CAPSULE:
    dn = d / torch.clamp(mops.norm(d, keepdim=True), min=eps)
    cap = torch.zeros_like(d)
    cap[..., 2] = torch.sign(d[..., 2]) * size[..., 1]
    return size[..., 0, None] * dn + cap
  if gtype == _G.ELLIPSOID:
    w = size * d
    return size * w / torch.clamp(mops.norm(w, keepdim=True), min=eps)
  if gtype == _G.CYLINDER:
    rxy = mops.norm(d[..., :2], keepdim=True)
    radial = torch.where(
        rxy > eps, size[..., 0, None] * d[..., :2] / torch.clamp(rxy, min=eps),
        torch.zeros_like(d[..., :2]))
    z = torch.sign(d[..., 2:]) * size[..., 1, None]
    return torch.cat([radial, z], dim=-1)
  if gtype == _G.BOX:
    return torch.sign(d) * size
  raise NotImplementedError(
      f'no MPR support function for geom type {_G(gtype).name.lower()}')


def _pick(mask, new, old):
  """Per candidate, `new` where mask holds, else `old`; vertices (..., 3,
  3) carry the Minkowski vertex and its two witnesses as rows."""
  return torch.where(mask[..., None, None], new, old)


def _cross(a, b):
  return torch.linalg.cross(a, b, dim=-1)


def collide(t1: int, t2: int, p1, m1, s1, p2, m2, s2, margin):
  """MPR contact of geom type t1 against t2.

  p* (..., 3), m* (..., 3, 3), s* and margin broadcast against them ->
  (dist (..., 1), pos (..., 1, 3), normal (..., 1, 3)), the normal from
  geom1 to geom2 and dist < 0 penetrating; dist is _BIG where the
  inflated shapes do not touch.
  """
  dtype = p1.dtype
  eps = 1e-12
  margin = torch.as_tensor(margin, dtype=dtype, device=p1.device)
  infl = 0.5 * torch.clamp(margin, min=0.0)[..., None]

  def sup_pair(d):
    """Rows [b - a, a, b]: the Minkowski vertex for world direction d and
    its witnesses, a on geom1 (support along -d), b on geom2 (along d)."""
    dn = d / torch.clamp(mops.norm(d, keepdim=True), min=eps)
    a = p1 + torch.einsum('...ij,...j->...i', m1, _support_local(
        t1, s1, torch.einsum('...ji,...j->...i', m1, -dn))) - infl * dn
    b = p2 + torch.einsum('...ij,...j->...i', m2, _support_local(
        t2, s2, torch.einsum('...ji,...j->...i', m2, dn))) + infl * dn
    return torch.stack([b - a, a, b], dim=-2)

  # interior point: the centers' difference, nudged off the origin
  v0 = p2 - p1
  v0 = torch.where(mops.norm(v0, keepdim=True) < 1e-9,
                   torch.tensor([1e-5, 2e-5, 3e-5], dtype=dtype,
                                device=p1.device), v0)

  # ---- portal discovery ----
  V1 = sup_pair(-v0)
  v1 = V1[..., 0, :]
  miss = mops.dot(v1, -v0) <= 0
  d2 = _cross(v1, v0)
  # origin on the v0-v1 line: nudge the second direction
  diag = torch.full_like(v0, 0.577)
  d2 = torch.where(mops.norm(d2, keepdim=True) < 1e-10,
                   _cross(v1 - v0, diag), d2)
  V2 = sup_pair(d2)
  miss = miss | (mops.dot(V2[..., 0, :], d2) <= 0)
  n = _cross(v1 - v0, V2[..., 0, :] - v0)
  swap = mops.dot(n, v0) > 0
  V1, V2 = _pick(swap, V2, V1), _pick(swap, V1, V2)
  n = torch.where(swap[..., None], -n, n)

  done = miss
  for _ in range(_DISCOVERY_ITERS):
    V3 = sup_pair(n)
    v1, v2, v3 = V1[..., 0, :], V2[..., 0, :], V3[..., 0, :]
    miss_i = mops.dot(v3, n) <= 0
    # origin outside plane (v0, v1, v3): v2 <- v3; outside (v0, v3, v2):
    # v1 <- v3
    out1 = mops.dot(_cross(v1, v3), v0) < 0
    out2 = mops.dot(_cross(v3, v2), v0) < 0
    found = ~(out1 | out2)
    upd = ~done & ~miss_i
    V2 = _pick(upd & out1, V3, V2)
    V1 = _pick(upd & ~out1 & out2, V3, V1)
    n = torch.where((upd & ~found)[..., None],
                    _cross(V1[..., 0, :] - v0, V2[..., 0, :] - v0), n)
    miss = miss | (~done & miss_i)
    done = done | found | miss_i
  V3 = sup_pair(n)
  miss = miss | (mops.dot(V3[..., 0, :], n) <= 0)

  # ---- portal refinement ----
  done = miss
  for _ in range(_REFINE_ITERS):
    v1, v2, v3 = V1[..., 0, :], V2[..., 0, :], V3[..., 0, :]
    pn = _cross(v2 - v1, v3 - v1)
    pn = pn / torch.clamp(mops.norm(pn, keepdim=True), min=eps)
    V4 = sup_pair(pn)
    v4 = V4[..., 0, :]
    conv = mops.dot(v4 - v3, pn) < 1e-7
    # which portal vertex v4 replaces, so that the ray from v0 through
    # the origin stays inside the new portal
    t1c = mops.dot(_cross(v4, v1), v0) < 0
    t2c = mops.dot(_cross(v4, v2), v0) < 0
    t3c = mops.dot(_cross(v4, v3), v0) < 0
    upd = ~done & ~conv
    V1 = _pick(upd & ((t1c & t2c) | (~t1c & ~t3c)), V4, V1)
    V2 = _pick(upd & ~t1c & t3c, V4, V2)
    V3 = _pick(upd & t1c & ~t2c, V4, V3)
    done = done | conv

  v1, v2, v3 = V1[..., 0, :], V2[..., 0, :], V3[..., 0, :]
  pn = _cross(v2 - v1, v3 - v1)
  pn = pn / torch.clamp(mops.norm(pn, keepdim=True), min=eps)
  # penetration of the inflated shapes along the portal normal
  depth = mops.dot(v1, pn)
  hit = ~miss & (depth >= 0)

  # witness points: the origin projected on the portal, barycentric mix
  p0 = pn * depth[..., None]
  w = torch.stack([
      mops.dot(_cross(v2 - p0, v3 - p0), pn),
      mops.dot(_cross(v3 - p0, v1 - p0), pn),
      mops.dot(_cross(v1 - p0, v2 - p0), pn)], dim=-1)
  w = torch.clamp(w, min=0.0)
  wsum = w.sum(dim=-1, keepdim=True)
  w = torch.where(wsum > 1e-14, w / torch.clamp(wsum, min=1e-14),
                  torch.full_like(w, 1.0 / 3.0))
  witness = (w[..., 0, None, None] * V1 + w[..., 1, None, None] * V2 +
             w[..., 2, None, None] * V3)
  pos = 0.5 * (witness[..., 1, :] + witness[..., 2, :])

  # the portal normal points from geom2 toward geom1; flip it to the
  # geom1 -> geom2 convention. dist is the true distance.
  dist = torch.where(hit, margin - depth, torch.full_like(depth, _BIG))
  return dist[..., None], pos[..., None, :], -pn[..., None, :]
