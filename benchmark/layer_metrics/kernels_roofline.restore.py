"""kernels: the bound time of kernels's calls over their device time,
percent."""
from benchmark.readers import roofline_share


def read(ctx):
    return roofline_share(ctx)
