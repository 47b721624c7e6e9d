"""Host-to-device batch pipeline.

Counterpart of ``convtasnet_tpu/data/loader.py``: a thread pool decodes
planned batches ahead of time on the host, and a queue keeps ``prefetch``
batches in flight as device tensors, so the device does not wait on audio
decode. For a CUDA device each array is copied into pinned host memory and
sent with ``non_blocking=True``; the producer thread and the training loop
both enqueue work on the device's default stream, so a batch's copies are
ordered before any kernel that reads it. On the CPU the arrays are wrapped
as they are. The epoch's batch order is shuffled
from ``np.random.default_rng((seed, epoch))``, as in the JAX loader.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np
import torch

from convtasnet_tpu_torch.data.dataset import Batch


class BatchLoader:
    """Iterable over ``(mixture, lengths, sources, weights)`` tensors on
    ``device`` with background prefetch.

    Args:
        dataset: a ``SeparationDataset`` or ``CachedDataset``.
        shuffle: shuffle the batch order each epoch (batches, not
            utterances, as the reference does).
        device: where the tensors go.
        prefetch: batches kept decoded and sent ahead.
        num_workers: decoding threads.
        seed: shuffling seed (the epoch number is mixed in).
        pad_to_multiple: time padding of full-utterance batches.
    """

    def __init__(self, dataset, shuffle: bool = False, device="cpu",
                 prefetch: int = 2, num_workers: int = 4, seed: int = 0,
                 pad_to_multiple: int = 1):
        self.dataset = dataset
        self.shuffle = shuffle
        self.device = torch.device(device)
        self.prefetch = max(1, prefetch)
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.pad_to_multiple = pad_to_multiple
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.dataset)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def order(self) -> np.ndarray:
        """The batch indices of the current epoch, in order."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        return order

    def _put(self, batch: Batch) -> Tuple[torch.Tensor, ...]:
        arrays = (batch.mixture, batch.lengths, batch.sources, batch.weights)
        tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if self.device.type == "cpu":
            return tuple(tensors)
        return tuple(t.pin_memory().to(self.device, non_blocking=True)
                     for t in tensors)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, ...]]:
        order = self.order()
        work_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    def submit(i):
                        return pool.submit(self.dataset.load_batch, int(i),
                                           self.pad_to_multiple)

                    ahead = self.prefetch + self.num_workers
                    futures = [submit(i) for i in order[:ahead]]
                    for k in range(len(order)):
                        if stop.is_set():
                            return
                        work_q.put(self._put(futures[k].result()))
                        if k + ahead < len(order):
                            futures.append(submit(order[k + ahead]))
                work_q.put(None)
            except BaseException as e:  # handed to the consumer
                work_q.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = work_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while thread.is_alive():   # drain so the producer can exit
                try:
                    work_q.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.1)
