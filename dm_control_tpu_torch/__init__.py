"""dm_control_tpu_torch: the PyTorch and CUDA port of dm_control_tpu.

Imports torch, numpy and the standard library only. The JAX package
`dm_control_tpu` beside it is the reference each module is held against.
"""
