"""Quaternion, rotation and spatial-algebra helpers (torch).

Port of dm_control_tpu/ops/math.py. Every function broadcasts over any
leading dims. Conventions: quaternions (w, x, y, z); rotation matrices
world_from_local; spatial motion [angular; linear]; spatial force
[torque; force].
"""

from __future__ import annotations

import math

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """3-vector cross product over the last axis, with broadcasting."""
  a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
  b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
  return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                      a0 * b1 - a1 * b0], dim=-1)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return torch.sum(a * b, dim=-1)


def norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
  return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def mul_quat(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
  """Hamilton product q1 * q2."""
  w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
  w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
  return torch.stack([
      w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
      w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
      w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
      w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
  ], dim=-1)


def neg_quat(q: torch.Tensor) -> torch.Tensor:
  """Conjugate (inverse for unit quats)."""
  return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def rot_vec_quat(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
  """Rotate v by q: v + 2w (u x v) + 2 u x (u x v)."""
  w = q[..., 0:1]
  u = q[..., 1:4]
  uv = cross(u, v)
  return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
  w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
  xx, yy, zz = x * x, y * y, z * z
  xy, xz, yz = x * y, x * z, y * z
  wx, wy, wz = w * x, w * y, w * z
  m = torch.stack([
      1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
      2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
      2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
  ], dim=-1)
  return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
  """3x3 rotation matrix -> unit quaternion (w, x, y, z), branch-free:
  Shepperd's four candidates, the one of the largest score taken."""
  m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
  tr = m00 + m11 + m22
  d21, d02, d10 = (m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
                   m[..., 1, 0] - m[..., 0, 1])
  s01, s02, s12 = (m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0],
                   m[..., 1, 2] + m[..., 2, 1])
  scores = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
  cands = torch.stack([
      torch.stack([scores[..., 0], d21, d02, d10], -1),
      torch.stack([d21, scores[..., 1], s01, s02], -1),
      torch.stack([d02, s01, scores[..., 2], s12], -1),
      torch.stack([d10, s02, s12, scores[..., 3]], -1)], -2)
  best = torch.argmax(scores, dim=-1)
  q = torch.gather(cands, -2, best[..., None, None].expand(
      best.shape + (1, 4)))[..., 0, :]
  return normalize_quat(q)


def normalize_quat(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
  return q / torch.clamp(norm(q, keepdim=True), min=eps)


def axis_angle_to_quat(axis: torch.Tensor,
                       angle: torch.Tensor) -> torch.Tensor:
  half = 0.5 * angle
  s = torch.sin(half)
  c = torch.cos(half)
  return torch.cat([c[..., None], axis * s[..., None]], dim=-1)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor,
                   dt) -> torch.Tensor:
  """q <- q * exp(0.5 * omega_local * dt) (mju_quatIntegrate)."""
  angle = norm(omega, keepdim=True)
  small = angle < 1e-12
  axis = omega / torch.where(small, torch.ones_like(angle), angle)
  half = 0.5 * angle[..., 0] * dt
  dq = torch.cat([torch.cos(half)[..., None],
                  axis * torch.sin(half)[..., None]], dim=-1)
  dq_small = torch.cat([torch.ones_like(angle), omega * (0.5 * dt)], dim=-1)
  dq = torch.where(small, dq_small, dq)
  return normalize_quat(mul_quat(q, dq))


def quat_to_vel(q: torch.Tensor) -> torch.Tensor:
  """Unit quaternion -> rotation vector (axis * angle)."""
  sin_half = norm(q[..., 1:4], keepdim=True)
  angle = 2.0 * torch.atan2(sin_half[..., 0], q[..., 0])
  angle = torch.where(angle > math.pi, angle - 2.0 * math.pi, angle)
  axis = q[..., 1:4] / torch.clamp(sin_half, min=1e-12)
  return torch.where(sin_half < 1e-12, 2.0 * q[..., 1:4],
                     axis * angle[..., None])


def quat_sub(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
  """Rotation vector v with qa = qb * exp(v / 2) (mju_subQuat)."""
  return quat_to_vel(mul_quat(neg_quat(qb), qa))


def cross_motion(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
  vang, vlin = v[..., :3], v[..., 3:]
  mang, mlin = m[..., :3], m[..., 3:]
  return torch.cat([cross(vang, mang),
                    cross(vang, mlin) + cross(vlin, mang)], dim=-1)


def cross_force(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
  vang, vlin = v[..., :3], v[..., 3:]
  fang, flin = f[..., :3], f[..., 3:]
  return torch.cat([cross(vang, fang) + cross(vlin, flin),
                    cross(vang, flin)], dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
  x, y, z = v[..., 0], v[..., 1], v[..., 2]
  zero = torch.zeros_like(x)
  m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
  return m.reshape(v.shape[:-1] + (3, 3))


def spatial_inertia(mass: torch.Tensor, inertia_mat: torch.Tensor,
                    offset: torch.Tensor) -> torch.Tensor:
  """6x6 spatial inertia at a frame displaced by `offset` from the com."""
  cx = skew(offset)
  m = mass[..., None, None]
  eye = torch.eye(3, dtype=offset.dtype, device=offset.device)
  cxcxt = torch.sum(cx[..., :, None, :] * cx[..., None, :, :], dim=-1)
  top = torch.cat([inertia_mat + m * cxcxt, m * cx], dim=-1)
  bot = torch.cat([m * cx.transpose(-1, -2), (m * eye).expand_as(cx)],
                  dim=-1)
  return torch.cat([top, bot], dim=-2)


def normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
  return v / torch.clamp(norm(v, keepdim=True), min=eps)


def make_frame(normal: torch.Tensor) -> torch.Tensor:
  """Right-handed frame with rows [normal; t1; t2] (mju_makeFrame)."""
  n = normalize(normal)
  ey = torch.zeros_like(n)
  ey[..., 1] = 1.0
  ez = torch.zeros_like(n)
  ez[..., 2] = 1.0
  cand = torch.where(torch.abs(n[..., 1:2]) < 0.5, ey, ez)
  t1 = normalize(cand - n * torch.sum(cand * n, dim=-1, keepdim=True))
  t2 = cross(n, t1)
  return torch.stack([n, t1, t2], dim=-2)


def closest_segment_point(a: torch.Tensor, b: torch.Tensor,
                          p: torch.Tensor) -> torch.Tensor:
  ab = b - a
  denom = torch.sum(ab * ab, dim=-1, keepdim=True)
  t = torch.sum((p - a) * ab, dim=-1, keepdim=True) / torch.clamp(
      denom, min=1e-12)
  return a + torch.clamp(t, 0.0, 1.0) * ab


def closest_segment_segment(p1, q1, p2, q2):
  """Closest points (c1, c2) between segments [p1,q1] and [p2,q2]."""
  d1 = q1 - p1
  d2 = q2 - p2
  r = p1 - p2
  a = dot(d1, d1)
  e = dot(d2, d2)
  f = dot(d2, r)
  c = dot(d1, r)
  b = dot(d1, d2)
  denom = a * e - b * b
  s = torch.where(
      denom > 1e-12,
      torch.clamp((b * f - c * e) / torch.clamp(denom, min=1e-12), 0.0, 1.0),
      torch.zeros_like(denom))
  t = (b * s + f) / torch.clamp(e, min=1e-12)
  t_cl = torch.clamp(t, 0.0, 1.0)
  s = torch.clamp((b * t_cl - c) / torch.clamp(a, min=1e-12), 0.0, 1.0)
  return p1 + d1 * s[..., None], p2 + d2 * t_cl[..., None]
