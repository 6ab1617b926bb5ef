"""Task interface (port of dm_control_tpu/rl)."""
