"""The device trace of a traced window (``torch.profiler``, CPU and CUDA
activity), reduced to what the per-layer metrics read: the device's
operations (kernels, copies, memsets) inside the window, the host's
operations and the benchmark's own spans, the busy time (the union of the
device's intervals), and the idle gaps labelled by what the host was
doing.  Read from the profiler's raw event list, without building its
event tree."""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_ACTIVITIES = {'kernel', 'gpu_memcpy', 'gpu_memset'}
WINDOW = 'benchmark.window'
TOP = 10


@dataclasses.dataclass
class Op:
    name: str
    start: int   # ns, the profiler's clock
    end: int


@dataclasses.dataclass
class Trace:
    window: Op
    device: list[Op]     # kernels, copies and memsets, clipped to the window
    host: list[Op]       # the host's torch operations in the window
    spans: list[Op]      # the benchmark's spans (``span``)

    @property
    def window_s(self) -> float:
        return (self.window.end - self.window.start) / 1e9

    def kernels(self) -> list[Op]:
        return [o for o in self.device if not is_copy(o.name)]

    def copies(self) -> list[Op]:
        return [o for o in self.device if is_copy(o.name)]

    def busy_intervals(self) -> list[tuple[int, int]]:
        out: list[tuple[int, int]] = []
        for o in sorted(self.device, key=lambda o: o.start):
            if out and o.start <= out[-1][1]:
                if o.end > out[-1][1]:
                    out[-1] = (out[-1][0], o.end)
            else:
                out.append((o.start, o.end))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def device_s(self, ops=None) -> float:
        return sum(o.end - o.start for o in
                   (self.device if ops is None else ops)) / 1e9

    def top_device_ops(self, n: int = TOP) -> list[list]:
        by: dict[str, int] = defaultdict(int)
        for o in self.device:
            by[o.name[:160]] += o.end - o.start
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = TOP) -> list[list]:
        """Idle seconds by what the host was doing at each gap's middle:
        the innermost benchmark span, then the innermost torch operation
        (``python`` where none runs)."""
        gaps, t = [], self.window.start
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.window.end > t:
            gaps.append((t, self.window.end))
        host = sorted(self.host, key=lambda o: o.start)
        starts = [o.start for o in host]
        spans = sorted(self.spans, key=lambda o: o.start)
        by: dict[str, int] = defaultdict(int)
        for a, b in gaps:
            mid = (a + b) // 2
            by[f'{_innermost(spans, None, mid, 10_000)}:'
               f'{_innermost(host, starts, mid, 200) or "python"}'] += b - a
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _innermost(ops: list[Op], starts, t: int, depth: int) -> str | None:
    """The latest-starting op of ``ops`` (sorted by start) that covers t,
    looking back ``depth`` ops at most."""
    i = bisect.bisect_right(starts if starts is not None
                            else [o.start for o in ops], t)
    for j in range(i - 1, max(i - 1 - depth, -1), -1):
        if ops[j].end >= t:
            return ops[j].name
    return None


def is_copy(name: str) -> bool:
    return name.startswith(('Memcpy', 'Memset'))


@contextlib.contextmanager
def span(name: str):
    """A benchmark span: a range on the host's timeline of the trace."""
    with record_function(f'benchmark.{name}'):
        yield


class Tracer:
    """``with Tracer() as tr: with tr.window(): ...``; then ``tr.trace``."""

    def __init__(self):
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.trace: Trace | None = None

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = reduce(self.prof.profiler.kineto_results.events())
        return False

    @staticmethod
    def window():
        return record_function(WINDOW)


def _activity(e) -> str:
    act = getattr(e, 'activity_type', None)
    if act is not None:
        return str(act())
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        return 'gpu_user_annotation' if e.is_user_annotation() else 'kernel'
    return 'user_annotation' if e.is_user_annotation() else 'cpu_op'


def reduce(events) -> Trace:
    device, host, spans, window = [], [], [], None
    for e in events:
        act = _activity(e)
        start = e.start_ns()
        op = Op(e.name(), start, start + e.duration_ns())
        if act in DEVICE_ACTIVITIES:
            device.append(op)
        elif act == 'user_annotation':
            if op.name == WINDOW:
                window = op
            elif op.name.startswith('benchmark.'):
                spans.append(op)
        elif act == 'cpu_op':
            host.append(op)
    if window is None:
        raise RuntimeError('trace: no window span')
    a, b = window.start, window.end
    device = [Op(o.name, max(o.start, a), min(o.end, b)) for o in device
              if o.end > a and o.start < b]
    host = [o for o in host if o.end > a and o.start < b]
    return Trace(window, device, host, spans)


# The port's kernels in the trace: the tensor-core kernels launch
# <name>_mma_kernel, the others <name>_kernel, in namespace shiftnet (a
# copy of the name rule of the program's profile_forward tool).
PORT_KERNELS = ('cab_front', 'cab_back', 'conv', 'up_skip', 'shift_round',
                'naf_gate', 'naf_rep', 'naf_back', 'conv_cat')
_PORT_NAME = re.compile(r'shiftnet::(\w+?)(?:_mma)?_kernel\b')


def port_kernel(name: str) -> str | None:
    m = _PORT_NAME.search(name)
    return m.group(1) if m and m.group(1) in PORT_KERNELS else None
