# Copied from dm_control_tpu/models/constants.py (pure Python and numpy).
"""Enumerations for the TPU-native physics model format.

Numbering follows the MJCF file-format semantics (these are facts of the
interchange format the compiler consumes, chosen so that oracle-parity tests
can compare compiled fields index-for-index).
"""

import enum


class JointType(enum.IntEnum):
  FREE = 0
  BALL = 1
  SLIDE = 2
  HINGE = 3


# dofs / qpos widths per joint type
DOF_WIDTH = {JointType.FREE: 6, JointType.BALL: 3,
             JointType.SLIDE: 1, JointType.HINGE: 1}
QPOS_WIDTH = {JointType.FREE: 7, JointType.BALL: 4,
              JointType.SLIDE: 1, JointType.HINGE: 1}


class GeomType(enum.IntEnum):
  PLANE = 0
  HFIELD = 1
  SPHERE = 2
  CAPSULE = 3
  ELLIPSOID = 4
  CYLINDER = 5
  BOX = 6
  MESH = 7


class TrnType(enum.IntEnum):
  JOINT = 0
  JOINTINPARENT = 1
  SLIDERCRANK = 2
  TENDON = 3
  SITE = 4
  BODY = 5


class DynType(enum.IntEnum):
  NONE = 0
  INTEGRATOR = 1
  FILTER = 2
  FILTEREXACT = 3
  MUSCLE = 4


class GainType(enum.IntEnum):
  FIXED = 0
  AFFINE = 1
  MUSCLE = 2


class BiasType(enum.IntEnum):
  NONE = 0
  AFFINE = 1
  MUSCLE = 2


class IntegratorType(enum.IntEnum):
  EULER = 0
  RK4 = 1
  IMPLICIT = 2
  IMPLICITFAST = 3


class ConeType(enum.IntEnum):
  PYRAMIDAL = 0
  ELLIPTIC = 1


class EqType(enum.IntEnum):
  CONNECT = 0
  WELD = 1
  JOINT = 2
  TENDON = 3


class WrapType(enum.IntEnum):
  JOINT = 1
  PULLEY = 2
  SITE = 3
  SPHERE = 4
  CYLINDER = 5


class SensorType(enum.IntEnum):
  TOUCH = 0
  ACCELEROMETER = 1
  VELOCIMETER = 2
  GYRO = 3
  FORCE = 4
  TORQUE = 5
  JOINTPOS = 6
  JOINTVEL = 7
  TENDONPOS = 8
  TENDONVEL = 9
  ACTUATORPOS = 10
  ACTUATORVEL = 11
  ACTUATORFRC = 12
  SITEPOS = 13
  BALLQUAT = 14
  BALLANGVEL = 15
  FRAMEPOS = 16
  FRAMEQUAT = 17
  FRAMEXAXIS = 18
  FRAMEYAXIS = 19
  FRAMEZAXIS = 20
  FRAMELINVEL = 21
  FRAMEANGVEL = 22
  FRAMELINACC = 23
  FRAMEANGACC = 24
  SUBTREECOM = 25
  SUBTREELINVEL = 26
  SUBTREEANGMOM = 27
  RANGEFINDER = 28
  MAGNETOMETER = 29
  CLOCK = 30
  VELOCIMETERGLOBAL = 31  # extension


class ObjType(enum.IntEnum):
  """Object kinds referenced by sensors / frames."""
  BODY = 0
  XBODY = 1
  JOINT = 2
  GEOM = 3
  SITE = 4
  CAMERA = 5
  TENDON = 6
  ACTUATOR = 7


class DisableBit(enum.IntFlag):
  CONSTRAINT = 1 << 0
  EQUALITY = 1 << 1
  FRICTIONLOSS = 1 << 2
  LIMIT = 1 << 3
  CONTACT = 1 << 4
  PASSIVE = 1 << 5
  GRAVITY = 1 << 6
  CLAMPCTRL = 1 << 7
  ACTUATION = 1 << 8
  REFSAFE = 1 << 9
  FILTERPARENT = 1 << 10


class EnableBit(enum.IntFlag):
  ENERGY = 1 << 0
  INVDISCRETE = 1 << 1


# Solver impedance clamping (engine-wide constants of the soft-constraint
# model; see the MJCF "solver parameters" spec).
MINIMP = 0.0001
MAXIMP = 0.9999
MINVAL = 1e-15
