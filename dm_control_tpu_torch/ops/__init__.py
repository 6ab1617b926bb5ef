"""Batched physics ops (port of dm_control_tpu/ops)."""
