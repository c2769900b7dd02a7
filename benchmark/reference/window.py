"""The window plans of the evaluation protocol (``inference/
test_deblur.py``, ``test_denoise.py``), copied for the reference: the
reference's own tile split, so that the program's is checked."""
from __future__ import annotations


def quadrant_pads(h: int, w: int) -> tuple[int, int]:
    """Overlap pads of the four quadrant tiles (h/2 + pad_h, w/2 + pad_w),
    multiples of 16."""
    return 32 - (h // 2 % 16), 32 - (w // 2 % 16)


def quadrant_slices(h: int, w: int):
    """[(input slices, tile crop, output slices)] of the four overlapping
    quadrant tiles."""
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
    """Two full-width half-height tiles with a 16-px-aligned overlap."""
    ph = 32 - (h // 2 % 16)
    h2 = h // 2
    return [
        ((slice(0, h2 + ph), slice(0, w)),
         (slice(0, -ph), slice(0, w)), (slice(0, h2), slice(0, w))),
        ((slice(h2 - ph, h), slice(0, w)),
         (slice(ph, None), slice(0, w)), (slice(h2, h), slice(0, w))),
    ]


def tiles(plan: str, h: int, w: int):
    """The tiles of a plan: 'full' (one), 'half' or 'quadrant'."""
    if plan == 'full':
        return [((slice(0, h), slice(0, w)), (slice(None), slice(None)),
                 (slice(0, h), slice(0, w)))]
    return {'half': half_slices, 'quadrant': quadrant_slices}[plan](h, w)


def plan_for(h: int, w: int) -> str:
    """The plan the protocol takes when memory allows the whole window:
    the quadrant tiles where H or W is not a multiple of 8 (the model's
    three stride-2 levels need one), else the full window."""
    return 'quadrant' if h % 8 or w % 8 else 'full'
