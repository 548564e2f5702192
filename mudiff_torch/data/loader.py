"""Shuffled, prefetched batches on the device.

The port of ``mudiff_tpu/data/loader.py`` for one card.  The index order
is the JAX loader's: ``np.random.RandomState(seed + epoch).permutation``
when shuffling (else ``arange``), cut into batches, each sorted
(``np.sort``) before the gather; ``drop_last`` drops a partial tail,
``pad_last`` keeps it padded with its last slice.  Across processes
(``process_index`` / ``process_count``: a rank's data index and the data
size of the mesh) ``batch_size`` is the global batch, and each process
takes the strided subset ``idx[p::P]`` of the epoch's order, cut to the
common floor length so that every process runs the same number of
steps, and gathers its ``batch_size / P`` rows of each batch
(``mudiff_tpu/data/loader.py:82-109``).

A background thread gathers each batch straight into freshly allocated
pinned host tensors (the native gather writes into them) and keeps up to
``prefetch`` batches queued; the consumer copies each with
``non_blocking=True`` onto ``device`` on the current stream.  A pinned
buffer is never refilled: each batch gets its own, and the caching host
allocator does not hand a block out again before the copy that reads it
has finished.  On a CPU device the gathered tensors are the batch.

An error in the producer is raised in the consumer; an abandoned
iterator (closed, or garbage-collected) stops its thread, and ``close()``
returns once the thread has ended.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Tuple

import numpy as np
import torch

from mudiff_torch.data.datasets import SliceDataset
from mudiff_torch.sampler import serving_device

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _put_or_stop(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """``put`` that gives up once the consumer has gone, so a full queue
    never blocks the producer forever."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.2)
            return True
        except queue.Full:
            continue
    return False


class DeviceLoader:
    def __init__(
        self,
        dataset: SliceDataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        pad_last: bool = False,
        device=None,
        prefetch: int = 2,
        process_index: int = 0,
        process_count: int = 1,
    ) -> None:
        if batch_size % process_count:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{process_count} processes")
        self.dataset = dataset
        self.batch_size = batch_size
        self.process_index, self.process_count = process_index, process_count
        # the rows this process contributes to every global batch
        self.local_batch_size = batch_size // process_count
        self.shuffle = shuffle
        self.seed = seed
        # pad_last keeps the tail batch, padded to batch_size by repeating
        # its last slice (one shape for every batch); implies keeping it
        self.pad_last = pad_last
        self.drop_last = drop_last and not pad_last
        self.device = serving_device(device, "DeviceLoader")
        self.prefetch = max(1, prefetch)

    def _shard_len(self) -> int:
        return len(self.dataset) // self.process_count

    def __len__(self) -> int:
        n = self._shard_len()
        if self.drop_last:
            return n // self.local_batch_size
        return -(-n // self.local_batch_size)

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """This process's dataset indices of ``epoch``, in order."""
        n = len(self.dataset)
        if self.shuffle:
            idx = np.random.RandomState(self.seed + epoch).permutation(n)
        else:
            idx = np.arange(n)
        return idx[self.process_index::self.process_count][:self._shard_len()]

    def batch_indices(self, epoch: int):
        """The sorted dataset indices of this process's rows of each batch
        of ``epoch``, in order."""
        idx = self.epoch_indices(epoch)
        bs = self.local_batch_size
        for b in range(len(self)):
            sel = idx[b * bs:(b + 1) * bs]
            if self.pad_last and len(sel) < bs:
                sel = np.concatenate([sel, np.repeat(sel[-1:], bs - len(sel))])
            yield np.sort(sel)

    def _host_batch(self, sel: np.ndarray) -> Batch:
        h, w = self.dataset.image_shape
        pin = self.device.type == "cuda"
        bufs = [torch.empty((len(sel), h, w, 1), dtype=torch.float32, pin_memory=pin)
                for _ in range(4)]
        self.dataset.gather_batch(sel, out=[b.numpy() for b in bufs])
        return tuple(bufs)

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        """Iterate one epoch's batches, on ``device``."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                for sel in self.batch_indices(epoch):
                    if stop.is_set() or not _put_or_stop(q, self._host_batch(sel), stop):
                        return
                _put_or_stop(q, None, stop)
            except Exception as e:  # raised in the consumer
                _put_or_stop(q, e, stop)

        th = threading.Thread(target=producer, daemon=True, name="DeviceLoader")
        th.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield tuple(x.to(self.device, non_blocking=True) for x in item)
        finally:
            stop.set()
            th.join()
