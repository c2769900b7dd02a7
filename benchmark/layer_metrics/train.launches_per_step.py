"""train step: CUDA kernel launches in one step (the trace's kernels over
the steps traced)."""


def read(ctx):
    if ctx.kind != 'train':
        return None
    n = len(ctx.trace.kernels())
    return n / ctx.units if n else None
