"""glue: device time of the kernels that are not the port's (plain torch
between the kernels: CA MLPs, concats, the ShiftCAB shift, pixel shuffle,
casts, the channel sums' reductions) over all device time, percent."""
from benchmark.trace import port_kernel


def read(ctx):
    if ctx.kind != 'restore' or not ctx.trace.device:
        return None
    glue = sum(o.end - o.start for o in ctx.trace.kernels()
               if not port_kernel(o.name))
    return 100.0 * glue / sum(o.end - o.start for o in ctx.trace.device)
