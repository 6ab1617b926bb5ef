# Copied from dm_control_tpu/models/compiler.py (pure Python and numpy).
"""From-scratch MJCF -> device Model compiler.

Parses the MJCF XML dialect (the subset exercised by the dm_control suite and
composer-generated models — see reference dm_control/mjcf/schema.xml for the
format inventory) and compiles it directly to the TPU-resident `Model` pytree:
struct-of-arrays parameters, static topology metadata, a compile-time contact
candidate list, and a static constraint-row layout.

This is a re-design, not a port: there is no mjModel memory image; the
"compiled" artifact is a JAX pytree whose numeric leaves can be batched and
randomized under vmap without recompilation.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Tuple
from xml.etree import ElementTree

import numpy as np

from dm_control_tpu_torch.models import constants
from dm_control_tpu_torch.models import names as names_lib


_J = constants.JointType
_G = constants.GeomType
_DEG = math.pi / 180.0

# contact capacity per geom-type pair (static slots per candidate pair);
# must stay in sync with ops/collision.py _FUNCS
_PAIR_NCON = {
    (_G.PLANE, _G.SPHERE): 1,
    (_G.PLANE, _G.CAPSULE): 2,
    (_G.PLANE, _G.ELLIPSOID): 1,
    (_G.PLANE, _G.CYLINDER): 4,
    (_G.PLANE, _G.BOX): 4,
    (_G.SPHERE, _G.SPHERE): 1,
    (_G.SPHERE, _G.CAPSULE): 1,
    (_G.SPHERE, _G.ELLIPSOID): 1,
    (_G.SPHERE, _G.CYLINDER): 1,
    (_G.SPHERE, _G.BOX): 1,
    (_G.CAPSULE, _G.CAPSULE): 2,
    (_G.CAPSULE, _G.CYLINDER): 2,
    (_G.CAPSULE, _G.BOX): 2,
    (_G.BOX, _G.BOX): 8,
    (_G.HFIELD, _G.SPHERE): 1,
    (_G.HFIELD, _G.CAPSULE): 2,
    (_G.HFIELD, _G.ELLIPSOID): 1,
    (_G.HFIELD, _G.CYLINDER): 4,
    (_G.HFIELD, _G.BOX): 4,
    # convex pairs routed through the MPR kernel (ops/mpr.py): one
    # contact per pair, the C engine's libccd behavior for these
    (_G.SPHERE, _G.MESH): 1,
    (_G.CAPSULE, _G.ELLIPSOID): 1,
    (_G.CAPSULE, _G.MESH): 1,
    (_G.ELLIPSOID, _G.ELLIPSOID): 1,
    (_G.ELLIPSOID, _G.CYLINDER): 1,
    (_G.ELLIPSOID, _G.BOX): 1,
    (_G.ELLIPSOID, _G.MESH): 1,
    (_G.CYLINDER, _G.CYLINDER): 1,
    (_G.CYLINDER, _G.BOX): 1,
    (_G.CYLINDER, _G.MESH): 1,
    (_G.BOX, _G.MESH): 1,
    (_G.MESH, _G.MESH): 1,
    (_G.PLANE, _G.MESH): 4,
}

_SENSOR_INFO = {
    # tag: (SensorType, objtype attr name, namespace, dim)
    'touch': (constants.SensorType.TOUCH, 'site', 'site', 1),
    'accelerometer': (constants.SensorType.ACCELEROMETER, 'site', 'site', 3),
    'velocimeter': (constants.SensorType.VELOCIMETER, 'site', 'site', 3),
    'gyro': (constants.SensorType.GYRO, 'site', 'site', 3),
    'force': (constants.SensorType.FORCE, 'site', 'site', 3),
    'torque': (constants.SensorType.TORQUE, 'site', 'site', 3),
    'jointpos': (constants.SensorType.JOINTPOS, 'joint', 'joint', 1),
    'jointvel': (constants.SensorType.JOINTVEL, 'joint', 'joint', 1),
    'tendonpos': (constants.SensorType.TENDONPOS, 'tendon', 'tendon', 1),
    'tendonvel': (constants.SensorType.TENDONVEL, 'tendon', 'tendon', 1),
    'actuatorpos': (constants.SensorType.ACTUATORPOS, 'actuator', 'actuator',
                    1),
    'actuatorvel': (constants.SensorType.ACTUATORVEL, 'actuator', 'actuator',
                    1),
    'actuatorfrc': (constants.SensorType.ACTUATORFRC, 'actuator', 'actuator',
                    1),
    'framepos': (constants.SensorType.FRAMEPOS, 'objname', None, 3),
    'framequat': (constants.SensorType.FRAMEQUAT, 'objname', None, 4),
    'framexaxis': (constants.SensorType.FRAMEXAXIS, 'objname', None, 3),
    'frameyaxis': (constants.SensorType.FRAMEYAXIS, 'objname', None, 3),
    'framezaxis': (constants.SensorType.FRAMEZAXIS, 'objname', None, 3),
    'framelinvel': (constants.SensorType.FRAMELINVEL, 'objname', None, 3),
    'frameangvel': (constants.SensorType.FRAMEANGVEL, 'objname', None, 3),
    'subtreecom': (constants.SensorType.SUBTREECOM, 'body', 'body', 3),
    'subtreelinvel': (constants.SensorType.SUBTREELINVEL, 'body', 'body', 3),
    'subtreeangmom': (constants.SensorType.SUBTREEANGMOM, 'body', 'body', 3),
    'magnetometer': (constants.SensorType.MAGNETOMETER, 'site', 'site', 3),
    'ballquat': (constants.SensorType.BALLQUAT, 'joint', 'joint', 4),
    'ballangvel': (constants.SensorType.BALLANGVEL, 'joint', 'joint', 3),
    'clock': (constants.SensorType.CLOCK, None, None, 1),
    'rangefinder': (constants.SensorType.RANGEFINDER, 'site', 'site', 1),
}


# ---------------------------------------------------------------------------
# small parse helpers
# ---------------------------------------------------------------------------


def _floats(s: str, n: Optional[int] = None, pad: float = 0.0) -> np.ndarray:
  v = np.array([float(x) for x in s.split()], dtype=np.float64)
  if n is not None:
    if v.size > n:
      raise ValueError(f'expected <= {n} floats in {s!r}')
    v = np.concatenate([v, np.full(n - v.size, pad)])
  return v


def _floats_defaulted(s: str, defaults: str) -> np.ndarray:
  """Parse floats, completing missing trailing entries from `defaults`.

  MJCF semantics for multi-element attributes like solimp: a value string
  shorter than the full width keeps the built-in defaults for the
  unspecified tail (so solimp="0.9 0.99 0.003" keeps midpoint=0.5 and
  power=2 rather than zeroing them).
  """
  dv = np.array([float(x) for x in defaults.split()], dtype=np.float64)
  v = np.array([float(x) for x in s.split()], dtype=np.float64)
  if v.size > dv.size:
    raise ValueError(f'expected <= {dv.size} floats in {s!r}')
  out = dv.copy()
  out[:v.size] = v
  return out


def _bool(s: str) -> bool:
  return s.lower() in ('true', '1')


class _MJCFError(ValueError):
  pass


def _norm(v: np.ndarray) -> np.ndarray:
  n = np.linalg.norm(v)
  if n < 1e-14:
    raise _MJCFError(f'zero-norm vector {v}')
  return v / n


def _quat_mul(a, b):
  w1, x1, y1, z1 = a
  w2, x2, y2, z2 = b
  return np.array([
      w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
      w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
      w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
      w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
  ])


def _quat_rotate(q, v):
  w, u = q[0], q[1:]
  uv = np.cross(u, v)
  return v + 2.0 * (w * uv + np.cross(u, uv))


def _quat_from_axis_angle(axis, angle):
  axis = _norm(np.asarray(axis, dtype=np.float64))
  return np.concatenate([[math.cos(angle / 2)],
                         axis * math.sin(angle / 2)])


def _quat_from_zaxis(z):
  """Minimal rotation mapping (0,0,1) to z."""
  z = _norm(np.asarray(z, dtype=np.float64))
  axis = np.cross([0.0, 0.0, 1.0], z)
  s = np.linalg.norm(axis)
  c = z[2]
  if s < 1e-14:
    if c > 0:
      return np.array([1.0, 0, 0, 0])
    return np.array([0.0, 1, 0, 0])  # 180 deg about x
  angle = math.atan2(s, c)
  return _quat_from_axis_angle(axis / s, angle)


def _quat_from_xyaxes(xy):
  x = _norm(xy[:3])
  y = xy[3:6]
  y = y - np.dot(y, x) * x
  y = _norm(y)
  z = np.cross(x, y)
  m = np.stack([x, y, z], axis=1)
  return _quat_from_mat(m)


def _quat_from_mat(m):
  tr = np.trace(m)
  if tr > 0:
    s = math.sqrt(tr + 1.0) * 2
    return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                     (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
  i = int(np.argmax(np.diag(m)))
  j, k = (i + 1) % 3, (i + 2) % 3
  s = math.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k]) * 2
  q = np.zeros(4)
  q[0] = (m[k, j] - m[j, k]) / s
  q[1 + i] = 0.25 * s
  q[1 + j] = (m[j, i] + m[i, j]) / s
  q[1 + k] = (m[k, i] + m[i, k]) / s
  return q


def _quat_to_mat(q):
  w, x, y, z = q
  return np.array([
      [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
  ])


# ---------------------------------------------------------------------------
# defaults
# ---------------------------------------------------------------------------

_DEFAULT_KINDS = ('joint', 'geom', 'site', 'camera', 'light', 'pair',
                  'equality', 'tendon', 'general', 'motor', 'position',
                  'velocity', 'intvelocity', 'damper', 'muscle', 'cylinder',
                  'mesh')


class _DefaultTree:
  """MJCF defaults class tree with per-kind attribute dictionaries."""

  def __init__(self):
    self.classes: Dict[str, Dict[str, Dict[str, str]]] = {
        'main': {k: {} for k in _DEFAULT_KINDS}}
    self.parent: Dict[str, str] = {}

  def parse(self, elem: ElementTree.Element, parent: Optional[str] = None):
    cls = elem.get('class', 'main' if parent is None else None)
    if cls is None:
      raise _MJCFError('nested <default> must have a class name')
    if cls not in self.classes:
      self.classes[cls] = {k: {} for k in _DEFAULT_KINDS}
      if parent is not None:
        self.parent[cls] = parent
    for child in elem:
      if child.tag == 'default':
        self.parse(child, parent=cls)
      elif child.tag in _DEFAULT_KINDS:
        self.classes[cls][child.tag].update(child.attrib)

  def resolve(self, kind: str, cls: str) -> Dict[str, str]:
    chain = []
    c = cls
    while c is not None:
      chain.append(c)
      c = self.parent.get(c, 'main' if c != 'main' else None)
    out: Dict[str, str] = {}
    for c in reversed(chain):
      if c in self.classes:
        out.update(self.classes[c].get(kind, {}))
    return out


# ---------------------------------------------------------------------------
# intermediate spec records
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Body:
  name: str
  parentid: int
  pos: np.ndarray
  quat: np.ndarray
  childclass: str
  explicit_inertial: bool = False
  ipos: np.ndarray = None
  iquat: np.ndarray = None
  mass: float = 0.0
  fullinertia: np.ndarray = None   # 3x3 about com, in body frame
  gravcomp: float = 0.0
  mocapid: int = -1


@dataclasses.dataclass
class _Joint:
  name: str
  jtype: int
  bodyid: int
  pos: np.ndarray
  axis: np.ndarray
  range: np.ndarray
  limited: bool
  stiffness: float
  springref: float
  ref: float
  damping: float
  armature: float
  frictionloss: float
  solref: np.ndarray
  solimp: np.ndarray
  margin: float
  springdamper: np.ndarray = None   # (timeconst, dampratio) or None


@dataclasses.dataclass
class _Geom:
  name: str
  gtype: int
  bodyid: int
  pos: np.ndarray
  quat: np.ndarray
  size: np.ndarray
  contype: int
  conaffinity: int
  condim: int
  priority: int
  group: int
  friction: np.ndarray
  solref: np.ndarray
  solimp: np.ndarray
  solmix: float
  margin: float
  gap: float
  mass: Optional[float]
  density: float
  rgba: np.ndarray
  dataname: str = ''    # referenced hfield/mesh asset name
  mesh: Optional[object] = None   # MeshAsset for MESH geoms
  material: str = ''    # material asset name (visual)


# ---------------------------------------------------------------------------
# geom mass / inertia
# ---------------------------------------------------------------------------


def _geom_volume(gtype: int, size: np.ndarray) -> float:
  if gtype == _G.SPHERE:
    return 4.0 / 3.0 * math.pi * size[0] ** 3
  if gtype == _G.CAPSULE:
    r, h = size[0], size[1]
    return 4.0 / 3.0 * math.pi * r ** 3 + math.pi * r * r * 2 * h
  if gtype == _G.CYLINDER:
    return math.pi * size[0] ** 2 * 2 * size[1]
  if gtype == _G.BOX:
    return 8.0 * size[0] * size[1] * size[2]
  if gtype == _G.ELLIPSOID:
    return 4.0 / 3.0 * math.pi * size[0] * size[1] * size[2]
  if gtype in (_G.PLANE, _G.HFIELD):
    return 0.0
  raise _MJCFError(f'volume for geom type {gtype} not supported')


def _geom_inertia_diag(gtype: int, size: np.ndarray, mass: float):
  """Diagonal inertia about geom com, in geom frame (z = symmetry axis)."""
  if mass == 0.0:
    return np.zeros(3)
  if gtype == _G.SPHERE:
    i = 0.4 * mass * size[0] ** 2
    return np.array([i, i, i])
  if gtype == _G.CAPSULE:
    r, h = size[0], size[1]
    v_cyl = math.pi * r * r * 2 * h
    v_sph = 4.0 / 3.0 * math.pi * r ** 3
    rho = mass / (v_cyl + v_sph)
    mc, ms = rho * v_cyl, rho * v_sph
    length = 2 * h
    iz = 0.5 * mc * r * r + 0.4 * ms * r * r
    ix = (mc * (length * length / 12.0 + r * r / 4.0) +
          ms * (0.4 * r * r + h * h + 0.75 * h * r))
    return np.array([ix, ix, iz])
  if gtype == _G.CYLINDER:
    r, h = size[0], size[1]
    length = 2 * h
    iz = 0.5 * mass * r * r
    ix = mass * (3 * r * r + length * length) / 12.0
    return np.array([ix, ix, iz])
  if gtype == _G.BOX:
    a, b, c = size[:3]
    return mass / 3.0 * np.array([b * b + c * c, a * a + c * c,
                                  a * a + b * b])
  if gtype == _G.ELLIPSOID:
    a, b, c = size[:3]
    return mass / 5.0 * np.array([b * b + c * c, a * a + c * c,
                                  a * a + b * b])
  raise _MJCFError(f'inertia for geom type {gtype} not supported')


# ---------------------------------------------------------------------------
# the compiler
# ---------------------------------------------------------------------------


class Compiler:
  """Single-use MJCF compiler instance."""

  def __init__(self, xml_string: str, assets: Optional[Dict] = None,
               base_dir: Optional[str] = None):
    self.assets = assets or {}
    self.base_dir = base_dir
    root = ElementTree.fromstring(xml_string)
    self._resolve_includes(root)
    if root.tag != 'mujoco':
      raise _MJCFError(f'root element must be <mujoco>, got {root.tag}')
    self.root = root
    self.model_name = root.get('model', 'unnamed')

    # compiler settings
    self.angle = 'degree'
    self.eulerseq = 'xyz'
    self.settotalmass = -1.0
    self.boundmass = 0.0
    self.boundinertia = 0.0
    self.balanceinertia = False
    self.autolimits = True
    self.inertiafromgeom = 'auto'
    self.inertiagrouprange = (0, 5)

    self.defaults = _DefaultTree()

    # accumulators
    self.bodies: List[_Body] = []
    self.joints: List[_Joint] = []
    self.geoms: List[_Geom] = []
    self.sites: List[dict] = []
    self.cams: List[dict] = []
    self.lights: List[str] = []
    self.actuators: List[dict] = []
    self.tendons: List[dict] = []
    self.wraps: List[Tuple[int, int, float]] = []  # (type, objid, prm)
    self.sensors: List[dict] = []
    self.equalities: List[dict] = []
    self.excludes: List[Tuple[str, str]] = []
    self.explicit_pairs: List[dict] = []
    self.keys: List[dict] = []
    self.nmocap = 0
    self.hfields: List[dict] = []
    self.meshes: Dict[str, object] = {}   # name -> MeshAsset
    self.meshdir = ''
    self.textures: List[dict] = []        # visual assets (renderer)
    self.materials: List[dict] = []
    self.headlight: Optional[dict] = None

  # ---------------- includes ----------------

  def _resolve_includes(self, elem: ElementTree.Element):
    i = 0
    while i < len(elem):
      child = elem[i]
      if child.tag == 'include':
        fname = child.get('file')
        content = None
        if fname in self.assets:
          content = self.assets[fname]
        else:
          path = fname
          if self.base_dir is not None and not os.path.isabs(path):
            path = os.path.join(self.base_dir, fname)
          if os.path.exists(path):
            with open(path, 'rb') as f:
              content = f.read()
        if content is None:
          # tolerated: include of purely-visual assets we cannot find
          del elem[i]
          continue
        if isinstance(content, bytes):
          content = content.decode('utf-8')
        sub = ElementTree.fromstring(content)
        del elem[i]
        for j, subchild in enumerate(sub):
          elem.insert(i + j, subchild)
        continue
      self._resolve_includes(child)
      i += 1

  # ---------------- angle helper ----------------

  def _angle(self, x: float) -> float:
    return x * _DEG if self.angle == 'degree' else x

  def _orientation(self, attrib: Dict[str, str],
                   default_quat=None) -> np.ndarray:
    """Resolve quat/euler/axisangle/xyaxes/zaxis attributes to a quat."""
    if 'quat' in attrib:
      return _norm(_floats(attrib['quat'], 4))
    if 'axisangle' in attrib:
      v = _floats(attrib['axisangle'], 4)
      return _quat_from_axis_angle(v[:3], self._angle(v[3]))
    if 'euler' in attrib:
      e = [self._angle(x) for x in _floats(attrib['euler'], 3)]
      q = np.array([1.0, 0, 0, 0])
      axes = {'x': [1.0, 0, 0], 'y': [0, 1.0, 0], 'z': [0, 0, 1.0],
              'X': [1.0, 0, 0], 'Y': [0, 1.0, 0], 'Z': [0, 0, 1.0]}
      for ch, ang in zip(self.eulerseq, e):
        r = _quat_from_axis_angle(axes[ch], ang)
        # lowercase: intrinsic (rotate about current frame) = right-multiply
        q = _quat_mul(q, r) if ch.islower() else _quat_mul(r, q)
      return q
    if 'xyaxes' in attrib:
      return _quat_from_xyaxes(_floats(attrib['xyaxes'], 6))
    if 'zaxis' in attrib:
      return _quat_from_zaxis(_floats(attrib['zaxis'], 3))
    if default_quat is not None:
      return np.asarray(default_quat, dtype=np.float64)
    return np.array([1.0, 0, 0, 0])

  # ---------------- top-level parse ----------------

  def parse(self):
    # <compiler> first: meshdir/angle settings affect asset/body parsing
    # regardless of document order
    for elem in self.root:
      if elem.tag == 'compiler':
        self._parse_compiler(elem)
    for elem in self.root:
      if elem.tag == 'default':
        self.defaults.parse(elem)
      elif elem.tag == 'asset':
        self._parse_asset(elem)
      elif elem.tag == 'visual':
        for child in elem:
          if child.tag == 'headlight':
            self.headlight = dict(
                ambient=_floats(child.get('ambient', '0.1 0.1 0.1'), 3),
                diffuse=_floats(child.get('diffuse', '0.4 0.4 0.4'), 3),
                specular=_floats(child.get('specular', '0.5 0.5 0.5'),
                                 3),
                active=int(child.get('active', '1')))
    # multiple <option> elements merge in document order (C compiler
    # semantics; e.g. reference suite/lqr.xml splits timestep and flags)
    self.option = None
    for opt_elem in self.root.findall('option'):
      self.option = self._parse_option(opt_elem, self.option)
    if self.option is None:
      self.option = self._parse_option(None)

    world = self.root.find('worldbody')
    if world is None:
      raise _MJCFError('model has no <worldbody>')
    # world body
    self.bodies.append(_Body(
        name='world', parentid=-1, pos=np.zeros(3),
        quat=np.array([1.0, 0, 0, 0]), childclass='main'))
    self._parse_body_children(world, bodyid=0, childclass='main')

    for elem in self.root:
      if elem.tag == 'actuator':
        self._parse_actuators(elem)
      elif elem.tag == 'tendon':
        self._parse_tendons(elem)
      elif elem.tag == 'sensor':
        self._parse_sensors(elem)
      elif elem.tag == 'contact':
        self._parse_contact(elem)
      elif elem.tag == 'equality':
        self._parse_equality(elem)
      elif elem.tag == 'keyframe':
        self._parse_keyframe(elem)
    return self

  def _parse_asset(self, elem):
    """Parse <asset>: heightfields are structural (collision geometry);
    textures/materials/meshes-without-consumers are visual-only and
    recorded by name where needed later (rasterizer)."""
    for child in elem:
      if child.tag == 'hfield':
        nrow = int(child.get('nrow', '0'))
        ncol = int(child.get('ncol', '0'))
        size = _floats(child.get('size', '1 1 1 0.1'), 4)
        data = None
        if child.get('elevation'):
          data = np.fromstring(child.get('elevation'), sep=' ')
          data = data.reshape(nrow, ncol)
          lo, hi = data.min(), data.max()
          if hi > lo:
            data = (data - lo) / (hi - lo)   # C compiler normalization
        self.hfields.append(dict(
            name=child.get('name', f'hfield{len(self.hfields)}'),
            nrow=nrow, ncol=ncol, size=size, data=data))
      elif child.tag == 'mesh':
        self._parse_mesh(child)
      elif child.tag == 'texture':
        ttype = {'2d': 0, 'cube': 1, 'skybox': 2}.get(
            child.get('type', 'cube'), 1)
        self.textures.append(dict(
            name=child.get('name', child.get('type', '')),
            type=ttype,
            builtin={'none': 0, 'flat': 1, 'checker': 2,
                     'gradient': 3}.get(child.get('builtin', 'none'), 0),
            rgb1=_floats(child.get('rgb1', '0.8 0.8 0.8'), 3),
            rgb2=_floats(child.get('rgb2', '0.5 0.5 0.5'), 3),
            mark={'none': 0, 'edge': 1, 'cross': 2,
                  'random': 3}.get(child.get('mark', 'none'), 0),
            markrgb=_floats(child.get('markrgb', '0 0 0'), 3),
            width=int(child.get('width', '1')),
            height=int(child.get('height', '1')),
            file=child.get('file', '')))
      elif child.tag == 'material':
        d = self.defaults.resolve('material', child.get('class', 'main'))
        a = {**d, **child.attrib}
        self.materials.append(dict(
            name=a.get('name', f'mat{len(self.materials)}'),
            texture=a.get('texture', ''),
            texrepeat=_floats(a.get('texrepeat', '1 1'), 2),
            texuniform=1 if a.get('texuniform', 'false') == 'true' else 0,
            rgba=_floats(a.get('rgba', '1 1 1 1'), 4),
            specular=float(a.get('specular', '0.5')),
            shininess=float(a.get('shininess', '0.5')),
            emission=float(a.get('emission', '0')),
            reflectance=float(a.get('reflectance', '0'))))

  def _parse_mesh(self, child):
    from dm_control_tpu_torch.models import mesh as mesh_lib
    fname = child.get('file', '')
    name = child.get('name') or os.path.splitext(
        os.path.basename(fname))[0]
    scale = _floats(child.get('scale', '1 1 1'), 3)
    if child.get('vertex'):
      verts = np.fromstring(child.get('vertex'), sep=' ').reshape(-1, 3)
      verts = verts * scale
      try:
        from scipy.spatial import ConvexHull
        hull = ConvexHull(verts)
        faces = mesh_lib._hull_faces(verts, hull)
      except Exception:
        faces = np.zeros((0, 3), dtype=np.int32)
      self.meshes[name] = mesh_lib.MeshAsset(name, verts, faces)
      return
    content = self._find_asset_bytes(fname)
    if content is None:
      # visual-only mesh we cannot locate: tolerate; referencing a
      # missing mesh from a geom raises at that point instead
      return
    verts, faces = mesh_lib.load_mesh(content, fname, scale)
    self.meshes[name] = mesh_lib.MeshAsset(name, verts, faces)

  def _find_asset_bytes(self, fname: str):
    """Locate an asset's bytes: assets dict (with/without meshdir and
    directory prefixes), then the filesystem relative to base_dir."""
    cands = [fname, os.path.join(self.meshdir, fname),
             os.path.basename(fname)]
    for key in cands:
      if key in self.assets:
        content = self.assets[key]
        return content.encode() if isinstance(content, str) else content
    for key in cands:
      path = key
      if self.base_dir is not None and not os.path.isabs(path):
        path = os.path.join(self.base_dir, key)
      if os.path.exists(path):
        with open(path, 'rb') as f:
          return f.read()
    return None

  def _parse_compiler(self, elem):
    self.angle = elem.get('angle', self.angle)
    self.eulerseq = elem.get('eulerseq', self.eulerseq)
    if 'settotalmass' in elem.attrib:
      self.settotalmass = float(elem.get('settotalmass'))
    if 'boundmass' in elem.attrib:
      self.boundmass = float(elem.get('boundmass'))
    if 'boundinertia' in elem.attrib:
      self.boundinertia = float(elem.get('boundinertia'))
    if 'balanceinertia' in elem.attrib:
      self.balanceinertia = _bool(elem.get('balanceinertia'))
    if 'autolimits' in elem.attrib:
      self.autolimits = _bool(elem.get('autolimits'))
    self.inertiafromgeom = elem.get('inertiafromgeom', self.inertiafromgeom)
    self.meshdir = elem.get('meshdir', self.meshdir)

  def _parse_option(self, elem, prior: dict = None) -> dict:
    o = prior if prior is not None else dict(
        timestep=0.002, gravity=np.array([0.0, 0, -9.81]),
        wind=np.zeros(3), magnetic=np.array([0.0, -0.5, 0.0]),
        density=0.0, viscosity=0.0, impratio=1.0, tolerance=1e-8,
        integrator=constants.IntegratorType.EULER,
        cone=constants.ConeType.PYRAMIDAL,
        iterations=100, ls_iterations=50,
        disableflags=0, enableflags=0)
    if elem is None:
      return o
    if 'timestep' in elem.attrib:
      o['timestep'] = float(elem.get('timestep'))
    if 'gravity' in elem.attrib:
      o['gravity'] = _floats(elem.get('gravity'), 3)
    if 'wind' in elem.attrib:
      o['wind'] = _floats(elem.get('wind'), 3)
    if 'density' in elem.attrib:
      o['density'] = float(elem.get('density'))
    if 'viscosity' in elem.attrib:
      o['viscosity'] = float(elem.get('viscosity'))
    if 'impratio' in elem.attrib:
      o['impratio'] = float(elem.get('impratio'))
    if 'tolerance' in elem.attrib:
      o['tolerance'] = float(elem.get('tolerance'))
    if 'iterations' in elem.attrib:
      o['iterations'] = int(elem.get('iterations'))
    if 'ls_iterations' in elem.attrib:
      o['ls_iterations'] = int(elem.get('ls_iterations'))
    if 'integrator' in elem.attrib:
      o['integrator'] = {
          'Euler': constants.IntegratorType.EULER,
          'RK4': constants.IntegratorType.RK4,
          'implicit': constants.IntegratorType.IMPLICIT,
          'implicitfast': constants.IntegratorType.IMPLICITFAST,
      }[elem.get('integrator')]
    if 'cone' in elem.attrib:
      o['cone'] = (constants.ConeType.ELLIPTIC
                   if elem.get('cone') == 'elliptic'
                   else constants.ConeType.PYRAMIDAL)
    flag = elem.find('flag')
    if flag is not None:
      dbits = dict(
          constraint=constants.DisableBit.CONSTRAINT,
          equality=constants.DisableBit.EQUALITY,
          frictionloss=constants.DisableBit.FRICTIONLOSS,
          limit=constants.DisableBit.LIMIT,
          contact=constants.DisableBit.CONTACT,
          passive=constants.DisableBit.PASSIVE,
          gravity=constants.DisableBit.GRAVITY,
          clampctrl=constants.DisableBit.CLAMPCTRL,
          actuation=constants.DisableBit.ACTUATION,
          refsafe=constants.DisableBit.REFSAFE,
          filterparent=constants.DisableBit.FILTERPARENT,
      )
      for k, bit in dbits.items():
        v = flag.get(k)
        if v == 'disable':
          o['disableflags'] |= int(bit)
      if flag.get('energy') == 'enable':
        o['enableflags'] |= int(constants.EnableBit.ENERGY)
    return o

  # ---------------- worldbody recursion ----------------

  def _parse_body_children(self, elem, bodyid: int, childclass: str):
    # Two passes: a body's OWN elements are numbered before any
    # descendant body's, regardless of document position (MJCF allows
    # <joint> after a nested <body>; the oracle assigns ids by body
    # order — dog.xml's lumbar chain relies on this).
    for child in elem:
      tag = child.tag
      if tag in ('joint', 'freejoint'):
        self._parse_joint(child, bodyid, childclass, free=(tag == 'freejoint'))
      elif tag == 'geom':
        self._parse_geom(child, bodyid, childclass)
      elif tag == 'site':
        self._parse_site(child, bodyid, childclass)
      elif tag == 'camera':
        self._parse_camera(child, bodyid, childclass)
      elif tag == 'light':
        self.lights.append(child.get('name', ''))
      elif tag == 'inertial':
        self._parse_inertial(child, bodyid)
    for child in elem:
      if child.tag == 'body':
        self._parse_body(child, parentid=bodyid, childclass=childclass)

  def _parse_body(self, elem, parentid: int, childclass: str):
    cc = elem.get('childclass', childclass)
    pos = _floats(elem.get('pos', '0 0 0'), 3)
    quat = self._orientation(elem.attrib)
    body = _Body(
        name=elem.get('name', f'body{len(self.bodies)}'),
        parentid=parentid, pos=pos, quat=quat, childclass=cc,
        gravcomp=float(elem.get('gravcomp', '0')))
    if _bool(elem.get('mocap', 'false')):
      body.mocapid = self.nmocap
      self.nmocap += 1
    bodyid = len(self.bodies)
    self.bodies.append(body)
    self._parse_body_children(elem, bodyid, cc)

  def _parse_inertial(self, elem, bodyid: int):
    b = self.bodies[bodyid]
    b.explicit_inertial = True
    b.ipos = _floats(elem.get('pos', '0 0 0'), 3)
    b.iquat = self._orientation(elem.attrib)
    b.mass = float(elem.get('mass'))
    if 'diaginertia' in elem.attrib:
      d = _floats(elem.get('diaginertia'), 3)
      b.fullinertia = np.diag(d)
    elif 'fullinertia' in elem.attrib:
      f = _floats(elem.get('fullinertia'), 6)
      b.fullinertia = np.array([[f[0], f[3], f[4]],
                                [f[3], f[1], f[5]],
                                [f[4], f[5], f[2]]])
    else:
      b.fullinertia = np.zeros((3, 3))

  def _parse_joint(self, elem, bodyid: int, childclass: str, free: bool):
    if bodyid == 0:
      raise _MJCFError('joints are not allowed on the world body')
    if free:
      a = dict(elem.attrib)
      a['type'] = 'free'
    else:
      d = self.defaults.resolve('joint', elem.get('class', childclass))
      a = {**d, **elem.attrib}
    jtype = {'free': _J.FREE, 'ball': _J.BALL, 'slide': _J.SLIDE,
             'hinge': _J.HINGE}[a.get('type', 'hinge')]
    rng = _floats(a.get('range', '0 0'), 2)
    if jtype in (_J.HINGE, _J.BALL):
      rng = np.array([self._angle(rng[0]), self._angle(rng[1])])
    limited_attr = a.get('limited')
    if limited_attr is not None:
      limited = _bool(limited_attr)
    else:
      limited = self.autolimits and 'range' in a and np.any(rng != 0)
    ref = float(a.get('ref', '0'))
    springref = float(a.get('springref', '0'))
    if jtype == _J.HINGE:
      ref = self._angle(ref)
      springref = self._angle(springref)
    self.joints.append(_Joint(
        name=a.get('name', f'joint{len(self.joints)}'),
        jtype=int(jtype), bodyid=bodyid,
        pos=_floats(a.get('pos', '0 0 0'), 3),
        axis=_norm(_floats(a.get('axis', '0 0 1'), 3)),
        range=rng, limited=bool(limited),
        stiffness=float(a.get('stiffness', '0')),
        springref=springref, ref=ref,
        damping=float(a.get('damping', '0')),
        armature=float(a.get('armature', '0')),
        frictionloss=float(a.get('frictionloss', '0')),
        solref=_floats(a.get('solreflimit', '0.02 1'), 2),
        solimp=_floats_defaulted(a.get('solimplimit', '0.9 0.95 0.001 0.5 2'), '0.9 0.95 0.001 0.5 2'),
        margin=float(a.get('margin', '0')),
        springdamper=(_floats(a['springdamper'], 2)
                      if 'springdamper' in a else None)))

  def _parse_geom(self, elem, bodyid: int, childclass: str):
    d = self.defaults.resolve('geom', elem.get('class', childclass))
    a = {**d, **elem.attrib}
    gtype = {'plane': _G.PLANE, 'hfield': _G.HFIELD, 'sphere': _G.SPHERE,
             'capsule': _G.CAPSULE, 'ellipsoid': _G.ELLIPSOID,
             'cylinder': _G.CYLINDER, 'box': _G.BOX,
             'mesh': _G.MESH}[a.get('type', 'sphere')]
    size = _floats(a.get('size', '0 0 0'), 3)
    pos = _floats(a.get('pos', '0 0 0'), 3)
    quat = self._orientation(a)
    if 'fromto' in a:
      ft = _floats(a['fromto'], 6)
      p1, p2 = ft[:3], ft[3:]
      pos = 0.5 * (p1 + p2)
      quat = _quat_from_zaxis(p2 - p1) if np.linalg.norm(
          p2 - p1) > 1e-14 else np.array([1.0, 0, 0, 0])
      size = np.array([size[0], 0.5 * np.linalg.norm(p2 - p1), 0.0])
    friction = _floats(a.get('friction', '1 0.005 0.0001'))
    fr = np.array([1.0, 0.005, 0.0001])
    fr[:friction.size] = friction
    mass = float(a['mass']) if 'mass' in a else None
    mesh = None
    if gtype == _G.MESH:
      mname = a.get('mesh', '')
      if mname not in self.meshes:
        raise _MJCFError(f'geom references undefined mesh {mname!r}')
      mesh = self.meshes[mname]
      # bake the mesh's center-of-mass / principal-axis frame into the
      # geom frame (the C compiler's mesh_pos/mesh_quat mechanism)
      pos = pos + _quat_to_mat(quat) @ mesh.pos
      quat = _quat_mul(quat, mesh.quat)
      size = mesh.aabb_halfsize()
    self.geoms.append(_Geom(
        name=a.get('name', f'geom{len(self.geoms)}'),
        gtype=int(gtype), bodyid=bodyid, pos=pos, quat=quat, size=size,
        contype=int(a.get('contype', '1')),
        conaffinity=int(a.get('conaffinity', '1')),
        condim=int(a.get('condim', '3')),
        priority=int(a.get('priority', '0')),
        group=int(a.get('group', '0')),
        friction=fr,
        solref=_floats(a.get('solref', '0.02 1'), 2),
        solimp=_floats_defaulted(a.get('solimp', '0.9 0.95 0.001 0.5 2'), '0.9 0.95 0.001 0.5 2'),
        solmix=float(a.get('solmix', '1')),
        margin=float(a.get('margin', '0')),
        gap=float(a.get('gap', '0')),
        mass=mass, density=float(a.get('density', '1000')),
        rgba=_floats(a.get('rgba', '0.5 0.5 0.5 1'), 4),
        dataname=a.get('hfield', a.get('mesh', '')),
        mesh=mesh,
        material=a.get('material', '')))

  def _parse_site(self, elem, bodyid: int, childclass: str):
    d = self.defaults.resolve('site', elem.get('class', childclass))
    a = {**d, **elem.attrib}
    stype = {'sphere': _G.SPHERE, 'capsule': _G.CAPSULE,
             'ellipsoid': _G.ELLIPSOID, 'cylinder': _G.CYLINDER,
             'box': _G.BOX}[a.get('type', 'sphere')]
    size = _floats(a.get('size', '0.005 0.005 0.005'))
    sz = np.array([0.005, 0.005, 0.005])
    sz[:size.size] = size
    pos = _floats(a.get('pos', '0 0 0'), 3)
    quat = self._orientation(a)
    if 'fromto' in a:
      ft = _floats(a['fromto'], 6)
      p1, p2 = ft[:3], ft[3:]
      pos = 0.5 * (p1 + p2)
      quat = _quat_from_zaxis(p2 - p1)
      sz = np.array([sz[0], 0.5 * np.linalg.norm(p2 - p1), 0.0])
    self.sites.append(dict(
        name=a.get('name', f'site{len(self.sites)}'),
        stype=int(stype), bodyid=bodyid, pos=pos, quat=quat, size=sz))

  def _parse_camera(self, elem, bodyid: int, childclass: str):
    a = dict(elem.attrib)
    mode = {'fixed': 0, 'track': 1, 'trackcom': 2, 'targetbody': 3,
            'targetbodycom': 4}[a.get('mode', 'fixed')]
    self.cams.append(dict(
        name=a.get('name', f'cam{len(self.cams)}'),
        bodyid=bodyid, mode=mode,
        target=a.get('target', ''),
        pos=_floats(a.get('pos', '0 0 0'), 3),
        quat=self._orientation(a),
        fovy=float(a.get('fovy', '45'))))

  # ---------------- actuators ----------------

  def _parse_actuators(self, elem):
    for child in elem:
      kind = child.tag
      if kind not in ('motor', 'position', 'velocity', 'general',
                      'intvelocity', 'damper', 'adhesion'):
        continue
      d = self.defaults.resolve(kind, child.get('class', 'main'))
      a = {**d, **child.attrib}
      gear = _floats(a.get('gear', '1'))
      g = np.zeros(6)
      g[:gear.size] = gear
      dynprm = np.zeros(3)
      gainprm = np.zeros(9)
      biasprm = np.zeros(9)
      dyntype = constants.DynType.NONE
      gaintype = constants.GainType.FIXED
      biastype = constants.BiasType.NONE
      if kind == 'motor':
        gainprm[0] = 1.0
      elif kind == 'adhesion':
        # ctrl slot compiled for action-layout parity; force model TODO
        gainprm[0] = float(a.get('gain', '1'))
      elif kind == 'position':
        kp = float(a.get('kp', '1'))
        kv = float(a.get('kv', '0'))
        gainprm[0] = kp
        biastype = constants.BiasType.AFFINE
        biasprm[1] = -kp
        biasprm[2] = -kv
      elif kind == 'velocity':
        kv = float(a.get('kv', '1'))
        gainprm[0] = kv
        biastype = constants.BiasType.AFFINE
        biasprm[2] = -kv
      elif kind == 'general':
        dyntype = {'none': constants.DynType.NONE,
                   'integrator': constants.DynType.INTEGRATOR,
                   'filter': constants.DynType.FILTER,
                   'filterexact': constants.DynType.FILTEREXACT,
                   'muscle': constants.DynType.MUSCLE}[
                       a.get('dyntype', 'none')]
        gaintype = {'fixed': constants.GainType.FIXED,
                    'affine': constants.GainType.AFFINE,
                    'muscle': constants.GainType.MUSCLE}[
                        a.get('gaintype', 'fixed')]
        biastype = {'none': constants.BiasType.NONE,
                    'affine': constants.BiasType.AFFINE,
                    'muscle': constants.BiasType.MUSCLE}[
                        a.get('biastype', 'none')]
        dp = _floats(a.get('dynprm', '1 0 0'))
        dynprm[:min(3, dp.size)] = dp[:3]
        gp = _floats(a.get('gainprm', '1 0 0'))
        gainprm[:gp.size] = gp
        bp = _floats(a.get('biasprm', '0 0 0'))
        biasprm[:bp.size] = bp
      ctrlrange = _floats(a.get('ctrlrange', '0 0'), 2)
      forcerange = _floats(a.get('forcerange', '0 0'), 2)
      actrange = _floats(a.get('actrange', '0 0'), 2)
      ctrllimited = (_bool(a['ctrllimited']) if 'ctrllimited' in a
                     else self.autolimits and np.any(ctrlrange != 0))
      forcelimited = (_bool(a['forcelimited']) if 'forcelimited' in a
                      else self.autolimits and np.any(forcerange != 0))
      if 'joint' in a:
        trntype, target, tns = constants.TrnType.JOINT, a['joint'], 'joint'
      elif 'tendon' in a:
        trntype, target, tns = constants.TrnType.TENDON, a['tendon'], 'tendon'
      elif 'site' in a:
        trntype, target, tns = constants.TrnType.SITE, a['site'], 'site'
      elif 'body' in a:
        trntype, target, tns = constants.TrnType.BODY, a['body'], 'body'
      else:
        raise _MJCFError(f'actuator {a.get("name")} has no transmission')
      self.actuators.append(dict(
          name=a.get('name', f'actuator{len(self.actuators)}'),
          trntype=int(trntype), target=target, target_ns=tns,
          dyntype=int(dyntype), gaintype=int(gaintype),
          biastype=int(biastype),
          dynprm=dynprm, gainprm=gainprm, biasprm=biasprm, gear=g,
          ctrlrange=ctrlrange, forcerange=forcerange, actrange=actrange,
          ctrllimited=bool(ctrllimited), forcelimited=bool(forcelimited),
          actlimited=_bool(a.get('actlimited', 'false'))))

  # ---------------- tendons ----------------

  def _parse_tendons(self, elem):
    for child in elem:
      if child.tag not in ('fixed', 'spatial'):
        continue
      d = self.defaults.resolve('tendon', child.get('class', 'main'))
      a = {**d, **child.attrib}
      rng = _floats(a.get('range', '0 0'), 2)
      limited_attr = a.get('limited')
      if limited_attr is not None:
        limited = _bool(limited_attr)
      else:
        limited = self.autolimits and 'range' in a and np.any(rng != 0)
      springlength = _floats(a.get('springlength', '-1'),)
      if springlength.size == 1:
        springlength = np.array([springlength[0], springlength[0]])
      wraps = []
      for w in child:
        if child.tag == 'fixed' and w.tag == 'joint':
          wraps.append((int(constants.WrapType.JOINT), w.get('joint'),
                        float(w.get('coef'))))
        elif child.tag == 'spatial' and w.tag == 'site':
          wraps.append((int(constants.WrapType.SITE), w.get('site'), 0.0))
        elif child.tag == 'spatial' and w.tag == 'geom':
          raise _MJCFError('tendon geom wrapping not yet supported')
      self.tendons.append(dict(
          name=a.get('name', f'tendon{len(self.tendons)}'),
          fixed=(child.tag == 'fixed'), limited=bool(limited), range=rng,
          stiffness=float(a.get('stiffness', '0')),
          damping=float(a.get('damping', '0')),
          springlength=springlength,
          solref=_floats(a.get('solreflimit', '0.02 1'), 2),
          solimp=_floats_defaulted(a.get('solimplimit', '0.9 0.95 0.001 0.5 2'), '0.9 0.95 0.001 0.5 2'),
          margin=float(a.get('margin', '0')),
          width=float(a.get('width', '0.003')),
          wraps=wraps))

  # ---------------- sensors ----------------

  def _parse_sensors(self, elem):
    for child in elem:
      if child.tag not in _SENSOR_INFO:
        continue
      stype, attr, ns, dim = _SENSOR_INFO[child.tag]
      target = child.get(attr, '') if attr else ''
      if child.tag.startswith('frame'):
        ns = child.get('objtype', 'body')
        ns = {'body': 'body', 'xbody': 'body', 'geom': 'geom',
              'site': 'site', 'camera': 'camera'}[ns]
      self.sensors.append(dict(
          name=child.get('name', f'sensor{len(self.sensors)}'),
          stype=int(stype), target=target, target_ns=ns, dim=dim,
          cutoff=float(child.get('cutoff', '0'))))

  # ---------------- contact overrides ----------------

  def _parse_contact(self, elem):
    for child in elem:
      if child.tag == 'exclude':
        self.excludes.append((child.get('body1'), child.get('body2')))
      elif child.tag == 'pair':
        d = self.defaults.resolve('pair', child.get('class', 'main'))
        a = {**d, **child.attrib}
        fr = _floats(a.get('friction', '1 1 0.005 0.0001 0.0001'), 5,
                     pad=0.0)
        self.explicit_pairs.append(dict(
            geom1=a['geom1'], geom2=a['geom2'],
            condim=int(a.get('condim', '3')),
            friction=fr,
            solref=_floats(a.get('solref', '0.02 1'), 2),
            solimp=_floats_defaulted(a.get('solimp', '0.9 0.95 0.001 0.5 2'), '0.9 0.95 0.001 0.5 2'),
            margin=float(a.get('margin', '0')),
            gap=float(a.get('gap', '0'))))

  # ---------------- equality ----------------

  def _parse_equality(self, elem):
    for child in elem:
      d = self.defaults.resolve('equality', child.get('class', 'main'))
      a = {**d, **child.attrib}
      data = np.zeros(11)
      if child.tag == 'connect':
        etype = constants.EqType.CONNECT
        obj1, obj2 = a['body1'], a.get('body2', 'world')
        ns = 'body'
        data[:3] = _floats(a['anchor'], 3)
      elif child.tag == 'weld':
        etype = constants.EqType.WELD
        obj1, obj2 = a['body1'], a.get('body2', 'world')
        ns = 'body'
        if 'relpose' in a:
          data[3:10] = _floats(a['relpose'], 7)
        else:
          data[6] = 1.0  # unit quat marker -> use current relpose
        data[10] = float(a.get('torquescale', '1'))
      elif child.tag == 'joint':
        etype = constants.EqType.JOINT
        obj1, obj2 = a['joint1'], a.get('joint2', '')
        ns = 'joint'
        poly = _floats(a.get('polycoef', '0 1 0 0 0'), 5)
        data[:5] = poly
      elif child.tag == 'tendon':
        etype = constants.EqType.TENDON
        obj1, obj2 = a['tendon1'], a.get('tendon2', '')
        ns = 'tendon'
        poly = _floats(a.get('polycoef', '0 1 0 0 0'), 5)
        data[:5] = poly
      else:
        continue
      self.equalities.append(dict(
          name=a.get('name', f'eq{len(self.equalities)}'),
          etype=int(etype), obj1=obj1, obj2=obj2, ns=ns, data=data,
          active=_bool(a.get('active', 'true')),
          solref=_floats(a.get('solref', '0.02 1'), 2),
          solimp=_floats_defaulted(a.get('solimp', '0.9 0.95 0.001 0.5 2'), '0.9 0.95 0.001 0.5 2')))

  def _parse_keyframe(self, elem):
    for child in elem:
      if child.tag == 'key':
        self.keys.append(dict(
            name=child.get('name', f'key{len(self.keys)}'),
            qpos=child.get('qpos'), qvel=child.get('qvel'),
            ctrl=child.get('ctrl')))
