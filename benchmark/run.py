"""Run one cell of ``BENCHMARK.json`` once.

  python -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
      --trace <0|1>

Set-up (from process start: imports, the seeded weights made on the card,
the program's entry, the seeded inputs, one warm-up unit at the cell's own
shapes) is ``setup_s``.  The window then runs whole units back to back
for ``--seconds`` (the last unit begins before they run out).  With
``--trace 1`` the window runs under the profiler, at most the traffic's
``trace_units`` units, and the line carries the cell's per-layer metrics
and the trace's breakdown in place of its end-to-end metrics.  Every run
then frees the program's state and holds what the window produced to the
plain reference (``correct``), printing each number compared beside its
limit on standard error and, last, in the result line.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown``),
then ``compared``; a unit that raises ends the run with an error, so
``failed`` is 0 in every result.  Without a CUDA card, with fewer cards
than the cell asks for, or with JAX or the JAX package loaded in this
process, it exits with a code other than 0 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
import types

_T0 = time.time()

import torch  # noqa: E402

from benchmark import harness, manifest  # noqa: E402
from benchmark.kernel_calls import recording  # noqa: E402
from benchmark.roofline import PEAK_FLOPS  # noqa: E402


def _cell_kind(kind: str):
    """The class that runs a traffic kind's units and checks them."""
    if kind == 'restore':
        from benchmark.restore import Restore
        return Restore
    if kind == 'train':
        from benchmark.train import Train
        return Train
    raise ValueError(f'unknown traffic kind {kind!r}')


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, root=manifest.ROOT) -> dict:
    """One run of ``cell``; returns the result object."""
    with tempfile.TemporaryDirectory() as workdir:
        work = _cell_kind(cell.traffic['kind'])(cell, seed, device,
                                                workdir)
        harness.sync(device)
        setup_s = time.time() - t_start
        harness.log(f'setup_s {setup_s:.3f}; {harness.card()}')
        peak = harness.peak_bytes(device)
        if trace:
            harness.reset_peak(device)
            with recording() as calls:
                win, tr = harness.traced_window(
                    work.unit, seconds, device, cell.traffic['trace_units'],
                    work.span)
        else:
            win = harness.window(work.unit, seconds, device, name=work.span)
        win_peak = harness.peak_bytes(device)
        peak = max(peak, win_peak)
        harness.log(f'window: {win.units} units, {win.wall_s:.4f} s; '
                    f'{harness.card()}')
        work.release()
        harness.free(device)
        t0 = time.time()
        compared = work.check()
        harness.log(f'check took {time.time() - t0:.1f} s')
    limits = cell.limits
    if set(compared) != set(limits):
        raise KeyError(f'compared {sorted(compared)}, limits '
                       f'{sorted(limits)}')
    correct = all(compared[k] <= limits[k] for k in compared)
    result = {'correct': bool(correct), 'attempted': win.units, 'failed': 0}
    if trace:
        ctx = types.SimpleNamespace(
            kind=cell.traffic['kind'], trace=tr, calls=calls,
            units=win.units, window_s=tr.window_s,
            model_flops=work.flops(win.units),
            peak_flops=PEAK_FLOPS[work.dtype],
            peak_bytes=win_peak, device=device)
        result['metrics'] = harness.layer_metrics(cell, ctx, root)
        result['device'] = harness.device_info(device, peak)
        result['device'].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result['breakdown'] = {'device_ops': tr.top_device_ops(),
                               'idle_gaps': tr.idle_gaps()}
    else:
        measured = {'setup_s': setup_s, work.rate_metric:
                    win.units * work.frames_per_unit / win.wall_s}
        result['metrics'] = {m['name']: {'value': measured[m['name']],
                                         'unit': m['unit']}
                             for m in cell.end_to_end}
        result['device'] = harness.device_info(device, peak)
    result['compared'] = {k: {'value': v, 'limit': limits[k]}
                          for k, v in compared.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog='benchmark.run')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = min(_T0, harness.process_start())
    if not torch.cuda.is_available():
        harness.log('benchmark.run: no CUDA card; nothing measured')
        return 2
    cell = manifest.cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        harness.log(f'benchmark.run: {args.workload} needs {cell.chips} '
                    f'cards, this machine has {torch.cuda.device_count()}')
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      'cuda', t_start)
    for k, v in result['compared'].items():
        harness.log(f'compared {k} {v["value"]!r} limit {v["limit"]!r}')
    found = harness.forbidden_modules()
    if found:
        harness.log(f'benchmark.run: loaded {found}; the port must run '
                    'without JAX or the JAX package')
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
