"""Model compilation public API (port of dm_control_tpu/models)."""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from dm_control_tpu_torch.models import builder
from dm_control_tpu_torch.models import calibrate as calibrate_lib
from dm_control_tpu_torch.models import compiler
from dm_control_tpu_torch.models import constants
from dm_control_tpu_torch.models.types import Contact, Data, Model, Option
from dm_control_tpu_torch.models.types import data_from_numpy
from dm_control_tpu_torch.models.types import make_data
from dm_control_tpu_torch.models.types import model_from_numpy
from dm_control_tpu_torch.models.types import model_to_numpy

GeomType = constants.GeomType
JointType = constants.JointType
DisableBit = constants.DisableBit


def from_xml_string(xml_string: str,
                    assets: Optional[Dict] = None,
                    base_dir: Optional[str] = None,
                    dtype: torch.dtype = torch.float32,
                    device='cpu',
                    contact_budget: Optional[int] = None) -> Model:
  """Compile an MJCF string to a Model on `device`.

  The parameters are computed and calibrated in float64 on the CPU, then
  cast to `dtype` and moved to `device` once.
  """
  c = compiler.Compiler(xml_string, assets=assets, base_dir=base_dir)
  c.parse()
  m = builder.build(c, dtype=torch.float64, contact_budget=contact_budget)
  m = calibrate_lib.calibrate(m)
  arrays, meta = model_to_numpy(m)
  return model_from_numpy(arrays, meta, device=device, dtype=dtype)


def from_xml_path(path: str, assets: Optional[Dict] = None,
                  dtype: torch.dtype = torch.float32, device='cpu',
                  contact_budget: Optional[int] = None) -> Model:
  with open(path, 'r') as f:
    xml = f.read()
  return from_xml_string(xml, assets=assets,
                         base_dir=os.path.dirname(os.path.abspath(path)),
                         dtype=dtype, device=device,
                         contact_budget=contact_budget)
