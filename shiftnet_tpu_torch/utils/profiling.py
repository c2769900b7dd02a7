"""Tracing and phase timers (counterpart of
``shiftnet_tpu/utils/profiling.py:11-39``): a ``torch.profiler`` trace in
place of the JAX package's ``jax.profiler`` one, and the same accumulating
wall-clock phase timer."""
from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(logdir: str | None):
    """Trace the host and, where there is one, the CUDA device with
    ``torch.profiler`` while the block runs, and write a Chrome trace
    (Perfetto, ``chrome://tracing``) into ``logdir``; a no-op without
    ``logdir``.  Usage: ``with trace('prof'): step()``."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f'trace_{time.strftime("%Y%m%d-%H%M%S")}_{os.getpid()}.json'))


class PhaseTimer:
    """Accumulating wall-clock phase timer (the reference logs pre, forward
    and post seconds per chunk, ``test_deblur.py:158-164``;
    ``shiftnet_tpu/utils/profiling.py:22``)."""

    def __init__(self):
        self.totals: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def summary(self) -> str:
        return ' '.join(f'{k}:{v:.3f}s' for k, v in self.totals.items())
