"""Timing helpers of the port's measurement tools: the card's name and
power limit, CUDA-event medians, and seeded inputs made on the card.

Every tool that times something needs a CUDA device; ``require_cuda``
raises without one, so no number is ever taken on the CPU.
"""
from __future__ import annotations

import statistics
import subprocess
import time

import torch

REPS = 20    # timed runs of a median
WARMUP = 3   # untimed runs before them
# Launches of one probe case: one checked against the plain version, then
# the warm-up and the timed runs.
CASE_LAUNCHES = 1 + WARMUP + REPS
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
BF16_OPS_PER_S = 989e12      # dense bf16 tensor-core peak, the same


def host_state() -> str:
    """The host's load (``os.getloadavg()`` over ``os.cpu_count()``) and
    the card's SM clock, its maximum, power draw and temperature
    (``nvidia-smi``), to print beside a timing: what else the host runs,
    and what clock the card held."""
    import os
    load = ', '.join(f'{v:.2f}' for v in os.getloadavg())
    try:
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=clocks.sm,clocks.max.sm,power.draw,'
             'temperature.gpu', '--format=csv,noheader'],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = 'nvidia-smi unavailable'
    smi = smi.splitlines()[0] if smi else 'nvidia-smi unavailable'
    return f'load {load} / {os.cpu_count()} cpus; sm, max sm, W, C: {smi}'


def require_cuda(tool: str) -> None:
    if not torch.cuda.is_available():
        raise SystemExit(f'{tool}: needs a CUDA device; the probes measure '
                         'the card and have no CPU path')


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip().splitlines(
    )[0].strip()


_cycles_per_ms: float | None = None


def _sleep_ms(ms: float) -> None:
    """Keep the card busy for about ``ms`` (``torch.cuda._sleep`` spins a
    number of clock cycles; the rate is measured once)."""
    global _cycles_per_ms
    if _cycles_per_ms is None:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(1_000_000)
        b.record()
        torch.cuda.synchronize()
        _cycles_per_ms = 1e6 / a.elapsed_time(b)
    torch.cuda._sleep(int(_cycles_per_ms * ms))


def median_ms(fn, n: int = REPS, warmup: int = WARMUP) -> float:
    """Median device time of ``fn`` in ms over ``n`` runs, each between two
    CUDA events, after ``warmup`` untimed runs.

    Before each run the card is kept busy for twice the host time ``fn``
    took to enqueue its work in the last warm-up run, so the events time
    the work on the card and not the Python between its launches: a kernel
    of a few microseconds would otherwise read as the tens of microseconds
    its wrapper spends on the host."""
    host = 0.0
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        host = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        _sleep_ms(2e3 * host + 0.05)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bytes_ms(nbytes: float) -> float:
    """The least time in ms to move ``nbytes`` through device memory."""
    return 1e3 * nbytes / HBM_BYTES_PER_S


def ops_ms(ops: float) -> float:
    """The least time in ms for ``ops`` bf16 tensor-core operations."""
    return 1e3 * ops / BF16_OPS_PER_S


def randn_bf16(shape, seed: int) -> torch.Tensor:
    """Seeded standard normals in bf16, made on the card."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    return torch.randn(shape, generator=g, device='cuda').to(torch.bfloat16)


def rand_bf16(shape, seed: int) -> torch.Tensor:
    """Seeded U[0, 1) in bf16, made on the card (the JAX tools'
    ``jax.random.uniform``)."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    return torch.rand(shape, generator=g, device='cuda').to(torch.bfloat16)
