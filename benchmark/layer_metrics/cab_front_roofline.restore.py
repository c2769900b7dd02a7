"""kernels: the bound time of cab_front's calls over their device time,
percent."""
from benchmark.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, 'cab_front')
