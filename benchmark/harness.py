"""What every cell's run shares: the set-up clock from process start, the
card's description, the measured window of whole units, the per-layer
readers, and the look for JAX in the process."""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

import torch

from benchmark import manifest
from benchmark.trace import Tracer, span

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'shiftnet_tpu')


def process_start() -> float:
    """The process's start on ``time.time()``'s clock (from ``/proc``;
    else now)."""
    try:
        with open('/proc/self/stat') as f:
            ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``shiftnet_tpu_torch`` is not
    ``shiftnet_tpu``)."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card() -> str:
    """The card's name, power limit, clocks and temperature, and the
    host's load."""
    try:
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit,power.draw,'
             'clocks.sm,clocks.max.sm,temperature.gpu',
             '--format=csv,noheader'],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = 'nvidia-smi unavailable'
    load = ', '.join(f'{v:.2f}' for v in os.getloadavg())
    return (f'card (name, power limit, draw, sm clock, max, C): {smi}; host '
            f'load {load} / {os.cpu_count()} cpus')


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Window:
    units: int
    wall_s: float


def window(unit, seconds: float, device, max_units: int | None = None,
           name: str = 'unit') -> Window:
    """Whole units back to back from a host clock start: unit(i) for i =
    0, 1, ... while fewer than ``seconds`` have passed when it begins (and
    fewer than ``max_units`` ran); the window ends once the last has, on
    the device too."""
    sync(device)
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds and (
            max_units is None or i < max_units):
        with span(name):
            unit(i)
        i += 1
    sync(device)
    return Window(i, time.perf_counter() - t0)


def traced_window(unit, seconds, device, max_units, name='unit'):
    """``window`` under the profiler; returns (Window, trace.Trace)."""
    with Tracer() as tr:
        with Tracer.window():
            w = window(unit, seconds, device, max_units, name)
    return w, tr.trace


def layer_metrics(cell: manifest.Cell, ctx, root) -> dict:
    """Each per-layer metric of the cell that its reader finds."""
    out = {}
    for m in cell.per_layer:
        v = manifest.reader(m['name'], root)(ctx)
        if v is None:
            log(f'per-layer {m["name"]}: nothing to read')
            continue
        out[m['name']] = {'value': float(v), 'unit': m['unit']}
    return out


def device_info(device, peak: int) -> dict:
    dev = torch.device(device)
    if dev.type == 'cuda':
        return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(dev),
                'count': 1, 'memory_peak_bytes': int(peak)}
    return {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
            'memory_peak_bytes': int(peak)}


def peak_bytes(device) -> int:
    if torch.device(device).type == 'cuda':
        return torch.cuda.max_memory_allocated(device)
    return 0


def reset_peak(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)


def free(device) -> None:
    import gc
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()
