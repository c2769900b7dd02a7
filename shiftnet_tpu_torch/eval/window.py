"""Windowed inference planning of the deblur and denoise protocols
(``inference/test_deblur.py:111-127``, ``inference/test_denoise.py:115-173``).

The port's own copy of ``shiftnet_tpu/eval/window.py:28-90``
(``plan_deblur_chunks``, ``plan_denoise_chunks``, ``quadrant_pads``,
``quadrant_slices``, ``half_slices``, ``mod_crop``): the port imports nothing
of the JAX package.
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


def plan_denoise_chunks(n_frames: int, halo: int = 2) -> list[Chunk]:
    """The whole clip as one chunk of ``n_frames - 2 * halo`` outputs,
    halved while longer than 100; the last chunk takes the residual frames
    (``plan_denoise_chunks``)."""
    one_len = n_frames - 2 * halo
    if one_len > 100:
        one_len //= 2
    k_len = (n_frames - 2 * halo) // one_len
    residual = (n_frames - 2 * halo) % one_len
    chunks = []
    for k in range(k_len):
        s = k * one_len
        extra = residual if k == k_len - 1 else 0
        chunks.append(Chunk(s, s + one_len + extra + 2 * halo,
                            s + halo, s + halo + one_len + extra))
    return chunks


def quadrant_pads(h: int, w: int) -> tuple[int, int]:
    """Overlap pads of the quadrant tiles, which are (h/2 + pad_h, w/2 +
    pad_w), multiples of 16 (``quadrant_pads``)."""
    return 32 - (h // 2 % 16), 32 - (w // 2 % 16)


def quadrant_slices(h: int, w: int):
    """[(input_slice, tile_crop, output_slice)] for the reference's four
    overlapping quadrant tiles (``quadrant_slices``)."""
    ph, pw = quadrant_pads(h, w)
    h2, w2 = h // 2, w // 2
    return [
        ((slice(0, h2 + ph), slice(0, w2 + pw)),
         (slice(0, -ph), slice(0, -pw)), (slice(0, h2), slice(0, w2))),
        ((slice(0, h2 + ph), slice(w2 - pw, w)),
         (slice(0, -ph), slice(pw, None)), (slice(0, h2), slice(w2, w))),
        ((slice(h2 - ph, h), slice(0, w2 + pw)),
         (slice(ph, None), slice(0, -pw)), (slice(h2, h), slice(0, w2))),
        ((slice(h2 - ph, h), slice(w2 - pw, w)),
         (slice(ph, None), slice(pw, None)), (slice(h2, h), slice(w2, w))),
    ]


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
