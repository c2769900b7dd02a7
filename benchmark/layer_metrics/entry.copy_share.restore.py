"""entry: the host<->device copies of the windows (memcpy HtoD and DtoH
device time) as a percent of the window's wall time."""


def read(ctx):
    if ctx.kind != 'restore':
        return None
    t = sum(o.end - o.start for o in ctx.trace.copies()
            if o.name.startswith(('Memcpy HtoD', 'Memcpy DtoH'))) / 1e9
    return 100.0 * t / ctx.window_s if t else None
