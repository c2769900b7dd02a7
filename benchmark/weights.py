"""The weights of a run, made on the device from ``--seed`` in two large
draws (one uniform, one normal, over every parameter at once), in float32,
the type the model keeps its parameters in; each leaf then takes its
slice, scaled as the program's seeded init scales it (``init_state``):
conv weights U(+-1/sqrt(fan_in)), biases 0.01 N(0, 1), PReLU slopes 0.25,
LayerNorm 1 / 0, the gated blocks' beta 0.1 N(0, 1)."""
from __future__ import annotations

import math

import torch

from benchmark.generator import generator


def make_state(shapes: dict[str, tuple], seed: int,
               device) -> dict[str, torch.Tensor]:
    """{key: float32 tensor on ``device``} for the parameter ``shapes``
    (keyed as the program's ``state_dict``)."""
    n = sum(math.prod(s) for s in shapes.values())
    g = generator(seed, 'weights', device=device)
    uni = torch.rand(n, generator=g, device=device) * 2 - 1
    nor = torch.randn(n, generator=g, device=device)
    state, off = {}, 0
    for key, shape in shapes.items():
        k = math.prod(shape)
        u, z = uni[off:off + k].view(shape), nor[off:off + k].view(shape)
        off += k
        if key.endswith('.beta') or key == 'beta':
            v = 0.1 * z
        elif len(shape) == 4:
            v = u / math.sqrt(math.prod(shape[1:]))
        elif shape == (1,):
            v = torch.full(shape, 0.25, device=device)
        elif key.endswith('.bias') and '.norm.' in f'.{key}':
            v = torch.zeros(shape, device=device)
        elif key.endswith('.bias'):
            v = 0.01 * z
        elif key.endswith('.weight'):  # LayerNorm2d scale
            v = torch.ones(shape, device=device)
        else:
            raise ValueError(f'make_state: unhandled parameter {key} {shape}')
        state[key] = v.clone()
    return state
