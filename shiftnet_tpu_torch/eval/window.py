"""Windowed inference planning of the deblur protocol
(``inference/test_deblur.py:111-127``).

The port's own copy of ``shiftnet_tpu/eval/window.py:28-90``
(``plan_deblur_chunks``, ``half_slices``, ``mod_crop``): the port imports
nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Chunk:
    in_start: int   # first input frame index
    in_stop: int    # one past last input frame
    out_start: int  # first predicted (global) frame index
    out_stop: int


def plan_deblur_chunks(n_frames: int, one_len: int,
                       halo: int = 2) -> list[Chunk]:
    """Chunks of ``one_len`` output frames with ``halo`` input frames on
    each side; tail frames beyond the last full chunk are dropped, as the
    reference does (``plan_deblur_chunks``)."""
    k_len = (n_frames - 2 * halo) // one_len
    chunks = []
    for k in range(k_len):
        s = k * one_len
        chunks.append(Chunk(s, s + one_len + 2 * halo,
                            s + halo, s + halo + one_len))
    return chunks


def half_slices(h: int, w: int):
    """[(input_slice, tile_crop, output_slice)] for two full-width
    half-height tiles with a 16-px-aligned overlap (``half_slices``)."""
    ph = 32 - (h // 2 % 16)
    h2 = h // 2
    return [
        ((slice(0, h2 + ph), slice(0, w)),
         (slice(0, -ph), slice(0, w)), (slice(0, h2), slice(0, w))),
        ((slice(h2 - ph, h), slice(0, w)),
         (slice(ph, None), slice(0, w)), (slice(h2, h), slice(0, w))),
    ]


def mod_crop(img: np.ndarray, mode: int = 4) -> np.ndarray:
    """Crop H, W down to multiples of ``mode`` (``test_deblur.py:125-127``;
    ``mod_crop``)."""
    h, w = img.shape[-3], img.shape[-2]
    return img[..., :h - h % mode, :w - w % mode, :]
