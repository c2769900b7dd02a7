"""Parameter loading for the port: the torch-keyed ``.npz`` exports the JAX
package writes (``shiftnet_tpu/train/checkpoint.py:save_params_npz``), or
the reference's ``.pth`` checkpoints."""
from __future__ import annotations

import numpy as np
import torch

from shiftnet_tpu_torch.models.config import CONFIGS
from shiftnet_tpu_torch.train.checkpoint import load_params_npz

# The small variants build orb4/5 and rorb4/5 but run only orb1..3
# (gshift_deblur2.py:718-726).
UNUSED_SMALL_PREFIXES = ('orb4.', 'orb5.', 'rorb4.', 'rorb5.')


def load_reference_checkpoint(path: str) -> dict[str, np.ndarray]:
    """A reference ``.pth`` checkpoint (``{'params': state_dict}``, or
    ``{'state_dict': ...}``, or a bare state dict) as numpy arrays; the
    port's own copy of ``shiftnet_tpu/tools/convert_torch.py:122``."""
    blob = torch.load(path, map_location='cpu', weights_only=True)
    state = blob.get('params', blob.get('state_dict', blob))
    return {k: v.numpy() for k, v in state.items()}


def drop_unused_reference_keys(state: dict, variant: str) -> dict:
    """The reference state minus the keys of modules it registers but never
    calls, which the port does not register: ``lrelu`` without
    ``rconcat_act`` and ``stage1.act`` with ``final_fuse_concat``
    (gshift_deblur1.py:556, :744), and the small variants' extra orbs."""
    cfg = CONFIGS[variant]
    drop = set() if cfg.rconcat_act else {'lrelu.weight'}
    if cfg.final_fuse_concat:
        drop.add('stage1.act.weight')
    small = cfg.num_orbs < 5
    return {k: v for k, v in state.items()
            if k not in drop and not (small and k.startswith(
                UNUSED_SMALL_PREFIXES))}


def load_state(variant: str, path: str) -> dict[str, torch.Tensor]:
    """Torch-keyed float32 state for ``build_model(variant)``."""
    if not path.endswith('.pth'):
        return load_params_npz(path)
    state = drop_unused_reference_keys(load_reference_checkpoint(path),
                                       variant)
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in state.items()}
