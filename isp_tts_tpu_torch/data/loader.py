"""Data loader: shuffling, batching, drop-last, contiguous process shards
and a prefetch thread (counterpart of ``isp_tts_tpu/data/loader.py``).

The order is ``random.Random(seed + epoch)``'s shuffle, as there, so the
port and the JAX package draw the same batches for the same seed and
epoch. A dataset with ``get_batch`` (the batched front end) gets each
batch's indices in one call.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Callable, Iterator, Sequence


class DataLoader:
    def __init__(self, dataset: Sequence, collate_fn: Callable, batch_size: int,
                 shuffle: bool = False, drop_last: bool = True, seed: int = 0,
                 num_shards: int = 1, shard_index: int = 0, prefetch: int = 2):
        if batch_size % num_shards != 0:
            raise ValueError("batch_size must divide evenly across processes")
        self.prefetch = prefetch
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.local_batch_size = batch_size // num_shards
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.epoch = 0
        #: batches of the epoch to pass over unloaded (a resumed epoch)
        self.skip = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return max(n, 0)

    def batch_indices(self) -> Iterator[list[int]]:
        """This process's dataset indices of each batch of the epoch."""
        order = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idxs = order[start:start + self.batch_size]
            if len(idxs) < self.batch_size:
                if self.drop_last:
                    break
                # a short last batch is padded by cycling, so every shard
                # gets the same local batch size
                pad_to = -(-len(idxs) // self.num_shards) * self.num_shards
                idxs = idxs + [idxs[i % len(idxs)] for i in range(pad_to - len(idxs))]
            per = len(idxs) // self.num_shards
            yield idxs[self.shard_index * per:(self.shard_index + 1) * per]

    def _batches(self, skip: int = 0) -> Iterator[dict]:
        for i, local in enumerate(self.batch_indices()):
            if i < skip:
                continue
            if hasattr(self.dataset, "get_batch"):
                samples = self.dataset.get_batch(local)
            else:
                samples = [self.dataset[i] for i in local]
            yield self.collate_fn(samples)

    def __iter__(self) -> Iterator[dict]:
        skip = self.skip
        if not self.prefetch:
            yield from self._batches(skip)
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        abandoned = threading.Event()
        failure: list[BaseException] = []

        def put(item) -> bool:
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self._batches(skip):
                    if not put(batch):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
                failure.append(e)
            finally:
                put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if failure:
                        raise failure[0]
                    break
                yield item
        finally:
            abandoned.set()  # the consumer may stop early (eval_batches, max_steps)
            thread.join()
