"""Trainer checkpoints with auto-resume, and the torch-keyed weight export.

Counterpart of ``shiftnet_tpu/train/checkpoint.py``: one ``torch.save``
file per save (``ckpt_<step>.pt``) holding the model, the optimizer state
and the step, in place of the JAX package's orbax checkpoint; the newest
``max_to_keep`` are kept, and auto-resume restores the highest step
(reference ``train1.py:137-158``).  ``save_params_npz`` exports the weights
as the torch-keyed ``.npz`` that the JAX package's ``load_params_npz``
reads (``shiftnet_tpu/train/checkpoint.py:45-56``) and the port's
``tools/params_io.load_state`` loads.
"""
from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch

_CKPT = re.compile(r'^ckpt_(\d+)\.pt$')


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5,
                 create: bool = True):
        """``create``: make the directory (the rank that writes)."""
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        if create:
            os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f'ckpt_{step:08d}.pt')

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _CKPT.match(f)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict[str, Any]) -> None:
        """Write ``state`` for ``step`` (through a temporary file, so a
        save cut short leaves no checkpoint), then drop the oldest beyond
        ``max_to_keep``."""
        path = self._path(step)
        torch.save(state, path + '.tmp')
        os.replace(path + '.tmp', path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, step: int | None = None) -> dict[str, Any] | None:
        """The state saved at ``step`` (default: the latest), tensors on
        the CPU; None when there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._path(step), map_location='cpu',
                          weights_only=True)


def save_params_npz(path: str, state: dict[str, torch.Tensor]) -> None:
    """A model's ``state_dict`` as a torch-keyed float32 ``.npz``."""
    np.savez_compressed(path, **{k: v.detach().float().cpu().numpy()
                                 for k, v in state.items()})


def load_params_npz(path: str) -> dict[str, torch.Tensor]:
    """A torch-keyed ``.npz`` (either package's export) as float32
    tensors, for ``load_state_dict``."""
    with np.load(path) as data:
        return {k: torch.from_numpy(np.asarray(data[k], np.float32))
                for k in data.files}
