# Copied from dm_control_tpu/models/mesh.py (pure Python and numpy).
"""Mesh asset loading and mass properties (host-side, compile time).

Supports binary/ASCII STL and MuJoCo .msh (legacy binary) files. Mass
properties use exact signed-tetrahedron volume integrals (verified to
match the C compiler's behavior for watertight meshes: the oracle bakes
the center of mass and principal inertia frame into `mesh_pos` /
`mesh_quat` and applies the same transform to referencing geoms —
reference consumer: dm_control/suite/dog.py loads 162 STL bone meshes
whose density-derived inertia defines the body masses).

The convex hull (for collision support functions and rendering) is
computed with scipy.spatial.ConvexHull and stored as a padded vertex
array on the Model.
"""

from __future__ import annotations

import io
import struct
from typing import Dict, Tuple

import numpy as np


def load_mesh(content: bytes, name: str = '',
              scale: np.ndarray | None = None):
  """Parse a mesh file (STL binary/ASCII or MuJoCo .msh binary).

  Returns (verts (n,3) float64, faces (m,3) int32).
  """
  if name.lower().endswith('.msh'):
    verts, faces = _load_msh(content)
  else:
    verts, faces = _load_stl(content)
  if scale is not None:
    verts = verts * np.asarray(scale, dtype=np.float64)
    if np.prod(np.sign(scale)) < 0:
      # odd number of negative scales flips orientation
      faces = faces[:, ::-1]
  return verts, faces


def _load_stl(content: bytes):
  head = content[:5]
  if head == b'solid' and b'facet' in content[:500]:
    return _load_stl_ascii(content)
  ntri = struct.unpack('<I', content[80:84])[0]
  rec = np.frombuffer(content[84:84 + ntri * 50], dtype=np.uint8)
  rec = rec.reshape(ntri, 50)
  tri = rec[:, 12:48].copy().view('<f4').reshape(ntri, 3, 3)
  verts, faces = _dedup(tri.astype(np.float64))
  return verts, faces


def _load_stl_ascii(content: bytes):
  tris = []
  cur = []
  for line in io.BytesIO(content).read().decode('utf-8',
                                                'replace').splitlines():
    parts = line.split()
    if len(parts) >= 4 and parts[0] == 'vertex':
      cur.append([float(parts[1]), float(parts[2]), float(parts[3])])
      if len(cur) == 3:
        tris.append(cur)
        cur = []
  return _dedup(np.asarray(tris, dtype=np.float64))


def _load_msh(content: bytes):
  """Legacy MuJoCo binary .msh: int32 nvert, nnormal, ntex, nface then
  float32 vertex data followed by the optional blocks and int32 faces."""
  nvert, nnorm, ntex, nface = struct.unpack('<4i', content[:16])
  off = 16
  verts = np.frombuffer(content, dtype='<f4', count=3 * nvert,
                        offset=off).reshape(nvert, 3).astype(np.float64)
  off += 12 * nvert + 12 * nnorm + 8 * ntex
  faces = np.frombuffer(content, dtype='<i4', count=3 * nface,
                        offset=off).reshape(nface, 3).copy()
  return verts, faces


def _dedup(tri: np.ndarray):
  """Merge duplicate vertices of a triangle soup into an indexed mesh."""
  flat = tri.reshape(-1, 3)
  # quantize for robust matching of float32-roundtripped coordinates
  key = np.round(flat * 1e8).astype(np.int64)
  _, idx, inv = np.unique(key, axis=0, return_index=True,
                          return_inverse=True)
  verts = flat[idx]
  faces = inv.reshape(-1, 3).astype(np.int32)
  # drop degenerate triangles
  ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) &
        (faces[:, 0] != faces[:, 2]))
  return verts, faces[ok]


def mass_properties(verts: np.ndarray, faces: np.ndarray):
  """Volume, center of mass and inertia of a triangle mesh.

  Reproduces the C compiler's legacy mesh algorithm bit-for-bit
  (numerically verified against mujoco 3.11 on the dog bone STLs):
    1. apex = area-weighted mean of face centroids;
    2. provisional volume and CoM from ABSOLUTE-volume tetrahedra
       (apex, a, b, c) — the abs makes the result robust to
       non-watertight/inverted faces (most scanned bone meshes are not
       watertight);
    3. FINAL volume (the one mass = density * volume uses) and inertia
       from absolute-volume tetrahedra re-apexed at the CoM. For
       non-watertight meshes the two volumes differ; the oracle's mass
       comes from the CoM-apexed one (verified to 1e-15 on the dog
       bone STLs).

  Returns (volume, com, inertia_about_com (3,3)).
  """
  if len(faces) == 0 or len(verts) < 4:
    return 0.0, np.zeros(3), np.zeros((3, 3))
  a = verts[faces[:, 0]]
  b = verts[faces[:, 1]]
  c = verts[faces[:, 2]]
  area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
  tot_area = area.sum()
  if tot_area <= 0:
    return 0.0, np.zeros(3), np.zeros((3, 3))
  facecen = (area[:, None] * (a + b + c) / 3.0).sum(axis=0) / tot_area

  det = np.abs(np.einsum(
      'ij,ij->i', a - facecen, np.cross(b - facecen, c - facecen)))
  vol = det.sum() / 6.0
  if vol <= 1e-14:
    return 0.0, facecen, np.zeros((3, 3))
  com = (det[:, None] * (facecen + a + b + c) / 4.0).sum(axis=0) / (
      6.0 * vol)

  # covariance integral about the com, per tetra (com apex):
  # C_tet = |det|/120 * (s s' + sum_i v_i v_i'), v relative to com
  ra, rb, rc = a - com, b - com, c - com
  det2 = np.abs(np.einsum('ij,ij->i', ra, np.cross(rb, rc)))
  vv = np.stack([ra, rb, rc], axis=1)                 # (n, 3verts, 3)
  s = vv.sum(axis=1)                                  # (n, 3)
  outer_ss = np.einsum('ni,nj->nij', s, s)
  outer_ii = np.einsum('nki,nkj->nij', vv, vv)
  C = (det2[:, None, None] * (outer_ss + outer_ii)).sum(axis=0) / 120.0
  inertia = np.trace(C) * np.eye(3) - C
  vol_final = det2.sum() / 6.0
  return vol_final, com, inertia


def _hull_faces(verts: np.ndarray, hull) -> np.ndarray:
  """Outward-oriented hull simplices (scipy does not guarantee winding)."""
  faces = hull.simplices.astype(np.int32)
  centroid = verts[hull.vertices].mean(axis=0)
  a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
  n = np.cross(b - a, c - a)
  flip = np.einsum('ij,ij->i', n, a - centroid) < 0
  faces[flip] = faces[flip][:, [0, 2, 1]]
  return faces


def principal_frame(inertia: np.ndarray):
  """Diagonalize an inertia tensor: (moments desc-sorted?, quat).

  Matches the C compiler convention: eigenvalues in DESCENDING order,
  right-handed eigenvector frame.
  """
  w, V = np.linalg.eigh(inertia)                      # ascending
  order = np.argsort(w)[::-1]
  w = w[order]
  V = V[:, order]
  if np.linalg.det(V) < 0:
    V[:, 2] = -V[:, 2]
  quat = _mat_to_quat(V)
  return w, quat


def _mat_to_quat(m: np.ndarray) -> np.ndarray:
  tr = np.trace(m)
  if tr > 0:
    s = np.sqrt(tr + 1.0) * 2
    q = np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                  (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
  elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
    s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
    q = np.array([(m[2, 1] - m[1, 2]) / s, 0.25 * s,
                  (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s])
  elif m[1, 1] > m[2, 2]:
    s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
    q = np.array([(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s,
                  0.25 * s, (m[1, 2] + m[2, 1]) / s])
  else:
    s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
    q = np.array([(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
                  (m[1, 2] + m[2, 1]) / s, 0.25 * s])
  return q / np.linalg.norm(q)


class MeshAsset:
  """A compiled mesh: baked into its principal inertial frame.

  After baking, `verts` are expressed in a frame centered at the center
  of mass and aligned with the principal axes of inertia — so the
  referencing geom's inertia is diagonal and the stored `pos`/`quat`
  must be composed into the geom's frame (the mesh_pos/mesh_quat
  mechanism of the C compiler).
  """

  def __init__(self, name: str, verts: np.ndarray, faces: np.ndarray):
    self.name = name
    vol, com, inertia = mass_properties(verts, faces)
    moments, quat = principal_frame(inertia)
    self.volume = float(vol)
    self.pos = com
    self.quat = quat
    R = _quat_mat(quat)
    self.verts = (verts - com) @ R                    # into principal frame
    self.faces = faces
    # unit-density principal moments about com
    self.inertia_diag = moments
    # convex hull vertex subset (collision support points), in the baked
    # frame; capped for padded device layout
    try:
      from scipy.spatial import ConvexHull
      hull = ConvexHull(self.verts)
      hv = self.verts[hull.vertices]
    except Exception:
      hv = self.verts
    self.hull_verts = hv

  def geom_inertia(self, mass: float) -> np.ndarray:
    if self.volume <= 0:
      return np.zeros(3)
    return self.inertia_diag * (mass / self.volume)

  def aabb_halfsize(self) -> np.ndarray:
    # oracle convention: per-axis max |coordinate| in the baked frame
    # (not the tight AABB half-extent)
    if not len(self.verts):
      return np.zeros(3)
    return np.abs(self.verts).max(axis=0)


def _quat_mat(q):
  w, x, y, z = q
  return np.array([
      [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
  ])
