"""Batched environments (port of dm_control_tpu/parallel)."""

from dm_control_tpu_torch.parallel.batch_env import BatchedEnvironment
