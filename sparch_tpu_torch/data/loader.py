"""NumPy data loader with background prefetch and multi-process item
loading (counterpart of sparch_tpu/data/loader.py, which it repeats line
for line).

Batches come from a seeded shuffle (``seed + epoch``, a new order each
pass), a custom collate function and two overlap mechanisms:

- ``prefetch``: a background thread keeps N finished batches ahead of the
  consumer, overlapping host preprocessing with the card's work;
- ``workers``: a persistent process pool loads the items of each batch in
  parallel.

``batch_transform`` runs on each collated batch on the producer side (the
prefetch thread, or the pool path's consumer loop): the epoch loop
(``train/loop.py``) makes torch tensors there and pins them, so the copy
to the card can be asynchronous.

Datasets used with ``workers > 0`` must be picklable (the spiking dataset
reopens its HDF5 handle lazily per process) and may expose
``reseed_augment(seed)``. The pool starts with ``forkserver``: a process
that has touched CUDA is never forked.
"""
from __future__ import annotations

import collections
import multiprocessing
import os
import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

__all__ = ["DataLoader"]

_WORKER_DATASET = None


def _worker_init(dataset, base_seed):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    reseed = getattr(dataset, "reseed_augment", None)
    if reseed is not None:
        # distinct augmentation streams per worker process
        reseed(base_seed + os.getpid())


def _worker_get(index):
    return _WORKER_DATASET[int(index)]


class DataLoader:
    """Iterates a dataset in (optionally shuffled) batches.

    ``dataset`` implements ``__len__`` and ``__getitem__``; ``collate_fn``
    maps a list of items to a batch. Each ``__iter__`` pass reshuffles
    (when enabled) from ``seed`` plus an internal epoch counter.

    ``num_shards``/``shard_index``: every shard derives the same shuffled
    order from the shared seed and takes a disjoint contiguous slice of
    each global batch, so the global batch across shards is the unsharded
    order; sharding always drops a ragged last batch.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        prefetch: int = 2,
        workers: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
        mp_context: str = "forkserver",
        batch_transform: Optional[Callable] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.batch_transform = batch_transform
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.workers = workers
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.mp_context = mp_context
        if batch_size % num_shards:
            raise ValueError(
                f"batch_size {batch_size} not divisible by {num_shards} shards"
            )
        self._epoch = 0
        self._pool = None

    def _drop_last(self) -> bool:
        # a ragged final batch would give the shards unequal (possibly
        # empty) slices
        return self.drop_last or self.num_shards > 1

    def __len__(self) -> int:
        n = len(self.dataset)
        if self._drop_last():
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> Iterator[Sequence[int]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        end = (
            (n // self.batch_size) * self.batch_size
            if self._drop_last() else n
        )
        per_shard = self.batch_size // self.num_shards
        for i in range(0, end, self.batch_size):
            batch = order[i : i + self.batch_size]
            if self.num_shards == 1:
                yield batch
                continue
            lo = self.shard_index * per_shard
            yield batch[lo : lo + per_shard]

    # per-batch wait bound: a crashed worker pool otherwise blocks get()
    # forever
    _GET_TIMEOUT_S = 600.0

    def _ensure_pool(self):
        if self._pool is None:
            ctx = multiprocessing.get_context(self.mp_context)
            self._pool = ctx.Pool(
                self.workers,
                initializer=_worker_init,
                initargs=(self.dataset, self.seed),
            )
            # load one item so that a child's start-up failure surfaces
            # now instead of as a hang later
            try:
                self._pool.map_async(_worker_get, [0], chunksize=1).get(60.0)
            except Exception as e:
                self.close()
                raise RuntimeError(
                    "data-loader worker pool failed to start (workers "
                    f"require an importable __main__ for the "
                    f"'{self.mp_context}' start method; use workers=0 from "
                    "REPL-like parents)"
                ) from e
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):  # pragma: no cover - interpreter-shutdown dependent
        try:
            self.close()
        except Exception:
            pass

    def _iter_pool(self):
        """Pool path: up to ``prefetch`` batches of items in flight across
        the workers; collation happens on the consumer thread."""
        pool = self._ensure_pool()
        chunk = max(1, self.batch_size // (self.workers * 2))
        pending = collections.deque()
        batch_iter = self._batches()

        def submit():
            idxs = next(batch_iter, None)
            if idxs is None:
                return False
            pending.append(
                pool.map_async(
                    _worker_get, [int(i) for i in idxs], chunksize=chunk
                )
            )
            return True

        for _ in range(max(1, self.prefetch)):
            if not submit():
                break
        while pending:
            items = pending.popleft().get(self._GET_TIMEOUT_S)
            submit()
            yield self._finish(self.collate_fn(items))

    def _finish(self, batch):
        if self.batch_transform is not None:
            return self.batch_transform(batch)
        return batch

    def __iter__(self):
        self._epoch += 1
        if self.workers > 0:
            yield from self._iter_pool()
            return
        if self.prefetch <= 0:
            for idxs in self._batches():
                yield self._finish(
                    self.collate_fn([self.dataset[int(i)] for i in idxs])
                )
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that gives up when the consumer abandoned the
            # epoch, so the thread and its pinned batches do not leak
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for idxs in self._batches():
                    batch = self._finish(
                        self.collate_fn(
                            [self.dataset[int(i)] for i in idxs]
                        )
                    )
                    if not put(batch):
                        return
            except BaseException as e:  # surface errors to the consumer
                put(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
            t.join()
        finally:
            stop.set()
