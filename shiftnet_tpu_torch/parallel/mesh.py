"""Process groups for data and sequence parallelism.

Counterpart of ``shiftnet_tpu/parallel/mesh.py``.  The JAX package builds a
``('data', 'time')`` device mesh; here each rank is one process (torchrun,
or ``parallel/launch.py``), and the mesh is a ``data x time`` grid of ranks
with one process group per row and per column: rank ``d * time + t`` is in
time ring ``d`` and data group ``t``, the order of JAX's
``devices.reshape(data, time)``.

The backend: NCCL when every rank has a GPU of its own, gloo on the CPU and
when ranks share a GPU (NCCL refuses two ranks on one device).  The choice
is printed, and a caller can force either.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_primary() -> bool:
    """Rank 0 (or no process group): the rank that logs and writes."""
    return rank() == 0


def launched() -> bool:
    """Whether a launcher (torchrun, ``parallel/launch.py``) set the rank
    variables of this process."""
    return 'RANK' in os.environ and 'WORLD_SIZE' in os.environ


def rank_device(device: str | torch.device = 'cuda') -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` for a CUDA
    request (ranks beyond the card count share cards), else ``device``."""
    device = torch.device(device)
    if device.type != 'cuda' or device.index is not None:
        return device
    local = int(os.environ.get('LOCAL_RANK', 0))
    return torch.device('cuda', local % max(torch.cuda.device_count(), 1))


def choose_backend(device: torch.device, local_ranks: int) -> str:
    """NCCL where every one of the ``local_ranks`` ranks of this host has a
    GPU of its own, else gloo (the CPU, or ranks sharing a GPU)."""
    if device.type == 'cuda' and local_ranks <= torch.cuda.device_count():
        return 'nccl'
    return 'gloo'


def init_distributed(device: str | torch.device = 'cuda', *,
                     backend: str | None = None,
                     init_method: str = 'env://') -> torch.device:
    """Join the process group of a launched process and return its
    device; a no-op for a process no launcher started (and for one already
    in a group).  Reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` as torchrun sets them; ``backend`` forces one."""
    dev = rank_device(device)
    if not launched() or initialized():
        return dev
    world = int(os.environ['WORLD_SIZE'])
    local_ranks = int(os.environ.get('LOCAL_WORLD_SIZE', world))
    chosen = backend or choose_backend(dev, local_ranks)
    r = int(os.environ['RANK'])
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    kw = {'device_id': dev} if chosen == 'nccl' else {}
    dist.init_process_group(chosen, init_method=init_method, rank=r,
                            world_size=world, **kw)
    if r == 0:
        why = ('forced' if backend else
               'one GPU per rank' if chosen == 'nccl' else
               'ranks share a GPU' if dev.type == 'cuda' else 'CPU ranks')
        print(f'[dist] {world} ranks, backend {chosen} ({why}; '
              f'{local_ranks} ranks on this host, '
              f'{torch.cuda.device_count()} GPUs)', flush=True)
    return dev


@dataclasses.dataclass
class Mesh:
    """A ``data x time`` grid of ranks.  ``time_group`` is None where the
    ring has one rank (no exchange), ``data_group`` where the data axis
    has one; with no process group both are None."""
    data: int
    time: int
    data_rank: int
    time_rank: int
    data_group: object | None
    time_group: object | None

    @property
    def size(self) -> int:
        return self.data * self.time


def make_mesh(data: int | None = None, time: int = 1) -> Mesh:
    """The mesh of the current process group (``data=None``: world /
    time).  Every rank must call it, with the same arguments: each
    ``new_group`` is collective."""
    n = world_size()
    if data is None:
        if n % time:
            raise ValueError(f'{n} ranks do not split into time rings of '
                             f'{time}')
        data = n // time
    if data * time != n:
        raise ValueError(f'mesh {data} x {time} for {n} ranks')
    r = rank()
    d, t = divmod(r, time)
    data_group = time_group = None
    for i in range(data):  # the time rings, one per data index
        ranks = list(range(i * time, (i + 1) * time))
        g = dist.new_group(ranks) if initialized() and time > 1 else None
        if i == d:
            time_group = g
    for j in range(time):  # the data groups, one per time index
        ranks = list(range(j, n, time))
        g = dist.new_group(ranks) if initialized() and data > 1 else None
        if j == t:
            data_group = g
    return Mesh(data, time, d, t, data_group, time_group)
