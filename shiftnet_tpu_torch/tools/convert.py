"""Weights carried across from the JAX package.

``state_from_jax`` takes a flax parameter tree of numpy arrays (for example
``jax.device_get`` of trained params) and returns the torch-keyed state that
``GShiftNet.load_state_dict(..., strict=True)`` accepts.  The key and layout
rewrite is ``shiftnet_tpu.tools.convert_torch.flax_to_torch_state``, which
imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from shiftnet_tpu.tools.convert_torch import flax_to_torch_state


def state_from_jax(params_np: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in flax_to_torch_state(params_np).items()}
