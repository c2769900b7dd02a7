"""Threaded prefetching batch loader, and the device staging of its batches.

Counterpart of ``shiftnet_tpu/data/loader.py`` (the reference's
``PrefetchGenerator`` / ``CPUPrefetcher`` stack,
``basicsr/data/prefetch_dataloader.py``): background threads decode and
batch clips into a bounded queue.  ``staged_batches`` is the counterpart of
``shiftnet_tpu/train/trainer.py:31-44`` and ``DeviceStager`` of the
reference's ``CUDAPrefetcher`` (``prefetch_dataloader.py:90-133``): batch
N+1's host-to-device copy is issued on a side CUDA stream before batch N is
consumed.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


class PrefetchLoader:
    """Iterates epochs forever, yielding batched sample dicts of shape
    ``(batch, T, H, W, C)``.  Per-sample RNG is derived from (seed, epoch,
    index), so runs are reproducible whatever the thread scheduling."""

    def __init__(self, dataset, sampler, *, batch_size: int = 1,
                 num_threads: int = 2, queue_depth: int = 4, seed: int = 0,
                 start_batch: int = 0):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_threads = max(1, num_threads)
        self.seed = seed
        # Resume: skip the first ``start_batch`` global batches by index
        # arithmetic (no decode), so a resumed run sees exactly the batch
        # stream the uninterrupted run would.  May be set any time before
        # the first ``__iter__``.
        self.start_batch = int(start_batch)
        self._stop = threading.Event()
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._started = False

    def _sample(self, epoch: int, idx: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, int(idx)]))
        return self.dataset.load(int(idx), rng)

    def _put(self, batch) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(batch, timeout=1.0)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self):
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(self.num_threads) as pool:
            epoch = 0
            gb = 0  # global batch counter (for start_batch skipping)
            while not self._stop.is_set():
                indices = self.sampler.epoch_indices(epoch)
                nb = len(indices) // self.batch_size
                for b in range(max(0, self.start_batch - gb), nb):
                    chunk = indices[b * self.batch_size:
                                    (b + 1) * self.batch_size]
                    samples = list(pool.map(
                        lambda i: self._sample(epoch, i), chunk))
                    batch = {k: np.stack([s[k] for s in samples])
                             for k in samples[0]}
                    if not self._put(batch):
                        return
                gb += nb
                epoch += 1

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        if not self._started:
            self._thread.start()
            self._started = True
        # Poll with a timeout so a concurrent stop() can never leave the
        # consumer blocked on an empty queue after the producer exits.
        while not self._stop.is_set():
            try:
                yield self._q.get(timeout=1.0)
            except queue.Empty:
                continue

    def stop(self):
        self._stop.set()


def staged_batches(loader, put):
    """1-deep device-side prefetch: issue batch N+1's transfer (``put``)
    before batch N is consumed.  Yields ``(host_batch, staged_batch)`` for
    every loader batch, in order."""
    pending = None
    for batch in loader:
        staged = (batch, put(batch))
        if pending is not None:
            yield pending
        pending = staged
    if pending is not None:
        yield pending


class DeviceStager:
    """Host batches ``{k: (B, T, H, W, C) float32}`` to ``{k: (B, T, C, H,
    W)}`` contiguous tensors on ``device``.  On a CUDA device the copy (from
    pinned memory) and the layout change run on a side stream: ``put``
    issues them, ``ready`` makes the current stream wait for them before the
    batch is used."""

    def __init__(self, device: str | torch.device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == 'cuda' else None)

    @staticmethod
    def _layout(t: torch.Tensor) -> torch.Tensor:
        return t.permute(0, 1, 4, 2, 3).contiguous()

    def put(self, batch: dict[str, np.ndarray]):
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if self.stream is None:
            return {k: self._layout(v).to(self.device) for k, v in host.items()}
        with torch.cuda.stream(self.stream):
            out = {k: self._layout(v.pin_memory().to(self.device,
                                                     non_blocking=True))
                   for k, v in host.items()}
            event = self.stream.record_event()
        return out, event

    def ready(self, staged) -> dict[str, torch.Tensor]:
        if self.stream is None:
            return staged
        out, event = staged
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)
        for v in out.values():
            v.record_stream(current)
        return out
