"""Weights carried across from the JAX package.

``state_from_jax`` takes a flax parameter tree of numpy arrays (for example
``jax.device_get`` of trained params) and returns the torch-keyed state that
``GShiftNet.load_state_dict(..., strict=True)`` accepts.  The key and layout
rewrite is the port's own copy of
``shiftnet_tpu/tools/convert_torch.py:28-91`` (``flax_path_to_torch_key``,
``_to_torch_array``, ``_flatten``, ``flax_to_torch_state``): the flax tree
mirrors the torch attribute paths, Sequential indices written ``__<i>``.

  flax ('stage1', 'decoder_level1_1', 'encoder_level1_2__0', 'body__0',
        'conv', 'kernel')
  -> torch 'stage1.decoder_level1_1.encoder_level1_2.0.body.0.weight'

Leaf rules: a conv ``kernel`` (HWIO) becomes ``weight`` (OIHW); the inner
``conv`` level of the flax Conv2d wrapper is dropped; CAB1/CAB2 ``beta``
goes from (1, 1, 1, C) to (1, C, 1, 1); everything else maps 1:1.
"""
from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch

_SEQ_IDX = re.compile(r'__(\d+)')


def flax_path_to_torch_key(path: tuple[str, ...]) -> str:
    """A flax param path (module names + leaf) -> its torch state_dict
    key."""
    parts = []
    n = len(path)
    for i, comp in enumerate(path):
        if comp == 'conv' and i == n - 2:
            continue  # the flax Conv2d wrapper level; torch has it inline
        parts.append(_SEQ_IDX.sub(r'.\1', comp))
    leaf = parts.pop()
    if leaf == 'kernel':
        leaf = 'weight'
    return '.'.join(parts + [leaf])


def _to_torch_array(path: tuple[str, ...], value: np.ndarray) -> np.ndarray:
    leaf = path[-1]
    if leaf == 'kernel':
        return np.transpose(value, (3, 2, 0, 1))  # HWIO -> OIHW
    if leaf == 'beta':
        return np.transpose(value, (0, 3, 1, 2))  # (1,1,1,C) -> (1,C,1,1)
    return value


def _flatten(tree: Any,
             prefix: tuple[str, ...] = ()) -> dict[tuple[str, ...], Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
    else:
        out[prefix] = tree
    return out


def flax_to_torch_state(params: dict) -> dict[str, np.ndarray]:
    """Flax param tree -> torch-keyed numpy state dict."""
    return {flax_path_to_torch_key(path): _to_torch_array(path, np.asarray(v))
            for path, v in _flatten(params).items()}


def state_from_jax(params_np: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in flax_to_torch_state(params_np).items()}
