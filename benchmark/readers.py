"""Reductions that the per-layer readers (``layer_metrics/``) share; each
takes the traced run's context (``run.run_cell``) and returns a number or
None where there is nothing to read."""
from __future__ import annotations

from collections import defaultdict

from benchmark.harness import log
from benchmark.trace import port_kernel


def kernel_times(ctx) -> tuple[dict[str, float], dict[str, int]]:
    """Device seconds and launches of each port kernel in the window."""
    secs: dict[str, float] = defaultdict(float)
    n: dict[str, int] = defaultdict(int)
    for o in ctx.trace.kernels():
        k = port_kernel(o.name)
        if k:
            secs[k] += (o.end - o.start) / 1e9
            n[k] += 1
    return secs, n


def roofline_share(ctx, kernel: str | None = None) -> float | None:
    """Percent: the summed bound time of the port kernels' calls (one
    kernel's, or all of them) over their summed device time.  None where
    no such call ran, or where the trace's launches and the recorded calls
    disagree (then the time is not of these calls)."""
    if ctx.kind != 'restore':
        return None
    secs, n = kernel_times(ctx)
    calls = defaultdict(list)
    for c in ctx.calls:
        calls[c.kernel].append(c)
    names = [kernel] if kernel else sorted(set(calls) | set(n))
    if not names or any(not calls.get(k) for k in names):
        return None
    bad = [k for k in names if n.get(k, 0) != len(calls[k])]
    if bad:
        log(f'roofline: launches in the trace {dict(n)} and recorded calls '
            f'{ {k: len(v) for k, v in calls.items()} } disagree on {bad}')
        return None
    bound = sum(c.bound_s for k in names for c in calls[k])
    return 100.0 * bound / sum(secs[k] for k in names)


def mfu(ctx, kind: str) -> float | None:
    if ctx.kind != kind or not ctx.trace.device:
        return None
    return 100.0 * ctx.model_flops / (ctx.window_s * ctx.peak_flops)


def idle(ctx, kind: str) -> float | None:
    if ctx.kind != kind or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.window_s)


def peak_gb(ctx, kind: str) -> float | None:
    if ctx.kind != kind or not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / 1e9
