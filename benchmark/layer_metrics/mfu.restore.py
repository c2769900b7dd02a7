"""model: the windows' model FLOPs (the plain reference's forward at the
shapes run, tile by tile) over the window's wall time times the peak
of the compute type, percent."""
from benchmark.readers import mfu


def read(ctx):
    return mfu(ctx, 'restore')
