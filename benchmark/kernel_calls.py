"""Records the port kernels' calls while a traced window runs: wrappers
put around the kernel entry points of ``ops/chw`` and ``ops/naf_chw`` that
note each call's kernel, compute type, operations and bytes
(``roofline.py``) from the shapes of its arguments, then call it.  The
program calls these entry points through their modules, so every call of
the forward goes through a wrapper."""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import inspect

from benchmark import roofline


@dataclasses.dataclass
class Call:
    kernel: str
    dtype: object
    ops: float
    nbytes: float

    @property
    def bound_s(self) -> float:
        return roofline.bound_s(self.ops, self.nbytes, self.dtype)


def _wrap(name: str, fn, count, calls: list):
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        a = dict(bound.arguments)
        first = next(iter(a.values()))
        x = first[0] if isinstance(first, (list, tuple)) else first
        if x.device.type == 'cuda':
            ops, nb = count(**a)
            calls.append(Call(name, x.dtype, ops, nb))
        return fn(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def recording():
    """Yields the list of ``Call`` that the kernels' calls on CUDA tensors
    append to while the context is open."""
    calls: list[Call] = []
    saved = []
    for name, (module, entry, count) in roofline.KERNELS.items():
        mod = importlib.import_module(f'shiftnet_tpu_torch.ops.{module}')
        fn = getattr(mod, entry)
        saved.append((mod, entry, fn))
        setattr(mod, entry, _wrap(name, fn, count, calls))
    try:
        yield calls
    finally:
        for mod, entry, fn in saved:
            setattr(mod, entry, fn)
