"""Start N ranks of one function, without torchrun.

``run(fn, n, *args)`` spawns ``n`` processes (``torch.multiprocessing``,
the ``spawn`` start method), each of which joins a process group through a
``file://`` rendezvous in a fresh temporary directory (so ranks of
different callers never share a port), calls ``fn(*args, **kwargs)`` and
saves what it returns.  ``run`` returns the ranks' results in rank order
and raises with the failing rank's traceback if any rank fails.  The tests and
``chip_smoke.py`` use it; ``fn`` must be importable (a module-level
function of the package), so the children import no test module.
"""
from __future__ import annotations

import os
import tempfile
import time
import traceback
from multiprocessing.connection import wait

import torch


def _child(rank: int, n: int, tmp: str, device: str, threads: int) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
    out = os.path.join(tmp, f'rank{rank}')
    try:
        torch.set_num_threads(threads)
        fn, args, kwargs = torch.load(os.path.join(tmp, 'call.pt'),
                                      weights_only=False)
        from shiftnet_tpu_torch.parallel import mesh
        mesh.init_distributed(device, init_method='file://' + os.path.join(
            tmp, 'rendezvous'))
        result = fn(*args, **kwargs)
        torch.save(result, out + '.pt.tmp')
        os.replace(out + '.pt.tmp', out + '.pt')
    except BaseException:
        with open(out + '.err', 'w') as f:
            f.write(traceback.format_exc())
        raise
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def run(fn, n: int, *args, device: str = 'cpu', threads: int = 1,
        timeout: float = 600.0, **kwargs) -> list:
    """``fn(*args, **kwargs)`` on ``n`` ranks; returns their results in
    rank order.
    ``device`` is each rank's (``cuda``: ``cuda:{rank % device_count}``;
    the backend is ``mesh.choose_backend``'s), ``threads`` sets torch's
    CPU threads a rank."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix='shiftnet_ranks_') as tmp:
        # the call goes through a file: passed as process arguments, each
        # tensor would be moved to shared memory one by one (seconds for a
        # model's weights)
        torch.save((fn, args, kwargs), os.path.join(tmp, 'call.pt'))
        ctx = mp.get_context('spawn')
        procs = [ctx.Process(target=_child, args=(
            r, n, tmp, device, threads), daemon=True)
            for r in range(n)]
        env = {'OMP_NUM_THREADS': str(threads)}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            for p in procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        try:  # until all end, one fails (the others would wait on it) or
            # the time is up
            deadline = time.monotonic() + timeout
            alive = procs
            while alive and time.monotonic() < deadline:
                wait([p.sentinel for p in alive],
                     deadline - time.monotonic())
                alive = [p for p in procs if p.is_alive()]
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        errs = []
        for r, p in enumerate(procs):
            err = os.path.join(tmp, f'rank{r}.err')
            if os.path.exists(err):
                with open(err) as f:
                    errs.append(f'rank {r}:\n{f.read()}')
            elif p.exitcode != 0:
                errs.append(f'rank {r}: exit code {p.exitcode}'
                            + (' (killed: timed out or another rank failed)'
                               if p.exitcode == -9 else ''))
        if errs:
            raise RuntimeError('a rank failed\n' + '\n'.join(errs))
        return [torch.load(os.path.join(tmp, f'rank{r}.pt'),
                           weights_only=False) for r in range(n)]
