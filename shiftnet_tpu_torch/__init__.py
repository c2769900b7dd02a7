"""shiftnet_tpu_torch — the PyTorch/CUDA port of ``shiftnet_tpu``.

GShiftNet video restoration in PyTorch, for one NVIDIA H100.  Module names
mirror the JAX package's so counterparts are easy to find; the TPU's Pallas
kernels become hand-written CUDA kernels (``csrc/``, bound in ``ops/chw``).
The JAX package is the reference the port is tested against.
"""
