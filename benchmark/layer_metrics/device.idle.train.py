"""device: the share of the window's wall time in which neither a kernel
nor a copy ran on the card (the union of the trace's intervals), percent."""
from benchmark.readers import idle


def read(ctx):
    return idle(ctx, 'train')
