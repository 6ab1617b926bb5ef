"""Suite model assets, read from the JAX package's asset directory.

Counterpart of dm_control_tpu/suite/common/__init__.py. The MJCF files are
read by path from dm_control_tpu/suite/assets; reading them imports
nothing of the JAX package.
"""

from __future__ import annotations

import os

ASSETS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..', '..',
    'dm_control_tpu', 'suite', 'assets'))


def read_assets() -> dict:
  """The include-resolvable `common/` assets, by both of their names."""
  assets = {}
  common_dir = os.path.join(ASSETS_DIR, 'common')
  for name in sorted(os.listdir(common_dir)):
    with open(os.path.join(common_dir, name), 'rb') as f:
      data = f.read()
    assets[f'./common/{name}'] = data
    assets[f'common/{name}'] = data
  return assets


def read_model(model_filename: str) -> str:
  """The MJCF source of one suite model."""
  with open(os.path.join(ASSETS_DIR, model_filename)) as f:
    return f.read()
