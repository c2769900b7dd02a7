"""model: the steps' model FLOPs (the plain reference's forward and
backward, recompute not counted) over the window's wall time times the
peak of the compute type, percent."""
from benchmark.readers import mfu


def read(ctx):
    return mfu(ctx, 'train')
