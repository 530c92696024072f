"""Batched data loader with prefetch, host sharding, and worker processes.

Replaces torch DataLoader/DistributedSampler (reference:
volta/task_utils.py:330-341) and the tensorpack ZMQ prefetch pipeline
(reference: volta/datasets/concept_cap_dataset.py:202-222): per-host shards
take disjoint strided slices of the (optionally shuffled) index space,
mirroring the per-rank division.

Two execution modes:

* ``num_workers`` threads (default): decode overlaps the device step —
  sufficient when a single core can decode one batch faster than the device
  consumes it (the device is asynchronous, so the host core is idle during
  the step).
* ``num_procs`` forked worker processes: true CPU parallelism for
  multi-core TPU hosts, the process-level equivalent of the reference's
  PrefetchDataZMQ workers. Batches are collated in the worker and shipped
  whole; ordering is restored in the parent.

The port's copy of ``volta_tpu/data/loader.py``, which uses numpy and
the standard library only; the port keeps its own so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

import collections
import concurrent.futures as futures
import multiprocessing as mp
import queue as queue_mod
from typing import Any, Dict, Iterator

import numpy as np


def collate(samples) -> Dict[str, Any]:
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = np.stack(vals) if hasattr(vals[0], "shape") or \
            not np.isscalar(vals[0]) else np.asarray(vals)
    return out


def _load_chunk(dataset, chunk):
    batch = getattr(dataset, "get_batch", None)
    if batch is not None:
        return batch(np.asarray(chunk, np.int64))
    return collate([dataset[int(j)] for j in chunk])


def _proc_worker(dataset, task_q, result_q):
    while True:
        item = task_q.get()
        if item is None:
            return
        seq, chunk = item
        try:
            result_q.put((seq, _load_chunk(dataset, chunk)))
        except Exception as e:  # surface the error in the parent
            result_q.put((seq, e))


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False,
                 num_workers: int = 4, num_shards: int = 1,
                 shard_index: int = 0, prefetch: int = 4,
                 num_procs: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(0, num_workers)
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        self.num_procs = max(0, num_procs)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx[self.shard_index:: self.num_shards]

    def __len__(self):
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self, idx: np.ndarray):
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i: i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.num_procs > 0:
            yield from self._iter_procs()
            return
        idx = self._indices()
        if self.num_workers == 0:
            for chunk in self._batches(idx):
                yield _load_chunk(self.dataset, chunk)
            return

        def load(chunk):
            return _load_chunk(self.dataset, chunk)

        with futures.ThreadPoolExecutor(self.num_workers) as pool:
            pending = collections.deque()
            batches = self._batches(idx)
            try:
                for _ in range(self.prefetch):
                    pending.append(pool.submit(load, next(batches)))
            except StopIteration:
                batches = iter(())
            while pending:
                out = pending.popleft().result()
                try:
                    pending.append(pool.submit(load, next(batches)))
                except StopIteration:
                    pass
                yield out

    def _iter_procs(self) -> Iterator[Dict[str, Any]]:
        """Fork worker processes for this epoch; the dataset (with its
        current epoch state) is inherited by fork, so no pickling of LMDB
        handles is needed. Results are re-ordered by sequence number."""
        ctx = mp.get_context("fork")
        task_q = ctx.Queue()
        result_q = ctx.Queue(maxsize=max(self.prefetch, self.num_procs) * 2)
        procs = [ctx.Process(target=_proc_worker,
                             args=(self.dataset, task_q, result_q),
                             daemon=True)
                 for _ in range(self.num_procs)]
        for p in procs:
            p.start()
        try:
            chunks = list(self._batches(self._indices()))
            for seq, chunk in enumerate(chunks):
                task_q.put((seq, chunk))
            for _ in range(self.num_procs):
                task_q.put(None)
            buffered: Dict[int, Any] = {}
            next_seq = 0
            while next_seq < len(chunks):
                while next_seq not in buffered:
                    seq, payload = result_q.get()
                    if isinstance(payload, Exception):
                        raise payload
                    buffered[seq] = payload
                yield buffered.pop(next_seq)
                next_seq += 1
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(timeout=5)
