"""Utilities (port of dm_control_tpu/utils)."""
