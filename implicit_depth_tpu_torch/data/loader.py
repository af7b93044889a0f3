"""Threaded prefetching batch loader.

Copy of implicit_depth_tpu/data/loader.py with only its imports changed
(the port imports nothing of the JAX package).

Replaces torch DataLoader worker processes (train_bd.py:84-114): a thread
pool maps dataset.__getitem__, a bounded queue keeps `prefetch` collated
batches ready, and (optionally) batches are placed on device/sharded
while the TPU is busy with the previous step. Python threads suffice
because the heavy lifting (PIL decode, numpy) releases the GIL.

Determinism/resume: the shuffle order of epoch e is a pure function of
(seed, e) — RandomState(seed + e) — so a run resumed at step N with
`start_batch=N` sees exactly the batches an uninterrupted run would
(skipped batches are skipped at the INDEX level, nothing is loaded).

Backpressure observability: `stats()` reports batches produced, time the
consumer spent starved (queue empty) and time the producer spent blocked
(queue full) — logged by the train loop as data/* scalars.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np

from implicit_depth_tpu_torch.data.mvs_dataset import collate


class BatchLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
        drop_last: bool = True,
        device_put_fn: Optional[Callable] = None,
        epochs: Optional[int] = None,  # None = loop forever
        start_batch: int = 0,          # deterministic resume offset
        shard_id: int = 0,             # multi-host: this process's shard
        num_shards: int = 1,           # multi-host: process count
    ):
        assert batch_size % num_shards == 0, (
            f"global batch {batch_size} not divisible by {num_shards} shards")
        assert 0 <= shard_id < num_shards
        assert num_shards == 1 or drop_last, (
            "multi-host sharding requires drop_last=True: a partial final "
            "batch would hand later shards an empty/short slice and the "
            "ranks would diverge at the global-batch assembly")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.device_put_fn = device_put_fn
        self.epochs = epochs
        self.seed = seed
        self.start_batch = start_batch
        self.shard_id = shard_id
        self.num_shards = num_shards
        self._stop = threading.Event()
        self._produced = 0
        self._starved_s = 0.0
        self._blocked_s = 0.0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def stats(self) -> dict:
        """Producer/consumer backpressure counters since construction."""
        return {
            "batches_produced": self._produced,
            "consumer_starved_s": self._starved_s,
            "producer_blocked_s": self._blocked_s,
        }

    def _epoch_order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        # pure function of (seed, epoch): resumable, worker-count invariant
        return np.random.RandomState(self.seed + epoch).permutation(n)

    def _index_stream(self):
        epoch = 0
        n = len(self.dataset)
        skip = self.start_batch
        while self.epochs is None or epoch < self.epochs:
            order = self._epoch_order(epoch)
            stop = n - (n % self.batch_size) if self.drop_last else n
            per = self.batch_size // self.num_shards
            for s in range(0, stop, self.batch_size):
                if skip > 0:  # resume: skip at the index level, load nothing
                    skip -= 1
                    continue
                # multi-host: every process walks the SAME global batch
                # order but loads only its contiguous slice of each batch
                idxs = order[s : s + self.batch_size]
                yield idxs[self.shard_id * per : (self.shard_id + 1) * per]
            epoch += 1

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        SENTINEL = object()

        def produce():
            try:
                for idxs in self._index_stream():
                    if self._stop.is_set():
                        break
                    samples = list(pool.map(self.dataset.__getitem__, idxs))
                    batch = collate(samples)
                    if self.device_put_fn is not None:
                        batch = self.device_put_fn(batch)
                    t0 = time.perf_counter()
                    q.put(batch)
                    self._blocked_s += time.perf_counter() - t0
                    self._produced += 1
            finally:
                q.put(SENTINEL)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self._starved_s += time.perf_counter() - t0
                if item is SENTINEL:
                    break
                yield item
        finally:
            self._stop.set()
            pool.shutdown(wait=False)

    def stop(self):
        self._stop.set()
