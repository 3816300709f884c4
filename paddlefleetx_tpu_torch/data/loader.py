"""The port's data loader: sampler-driven batch fetch ahead of the
consumer (the counterpart of the JAX package's ``data/loader.py``).

Two paths, as in the JAX package:

- ``num_workers <= 1``: one background THREAD (timeline track
  ``data-loader``) keeps a bounded queue of collated numpy batches
  ready while the card runs the previous step. Its ``put`` polls a
  stop event, so a consumer that breaks early never leaves it parked
  on a full queue.
- ``num_workers > 1``: a pool of WORKER PROCESSES from a
  ``forkserver`` context fetches and collates batches in parallel.
  Batches come out in strict sampler order whatever finishes first,
  each task seeds the host RNGs (``random``, ``np.random``) from the
  loader's seed, the epoch and the batch ordinal, and a worker's
  exception is raised again in the consumer. ``(dataset, collate_fn)``
  must pickle; where it does not, the loader takes the thread path
  with a warning, as the JAX loader does.

Neither path touches CUDA: the producers collate numpy only, and the
engine stages each batch on the card (``Engine._prefetch_iter``).
"""

from __future__ import annotations

import collections
import multiprocessing
import pickle
import queue
import threading
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np

from ..observability import timeline
from ..utils.log import logger


def _identity_collate(batch):
    # module-level (picklable): a lambda default would knock every
    # collate-free loader off the process-pool path
    return batch


def _worker_init(state_blob):
    # per-pool state travels through the initializer, so two loaders
    # (train and eval) cannot cross-feed each other
    global _INHERITED
    _INHERITED = pickle.loads(state_blob)


def _worker_fetch(seed, indices):
    """Fetch one batch in a worker, with the host RNGs seeded per task:
    the same stream whichever worker runs it."""
    import random
    dataset, collate_fn = _INHERITED
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    return collate_fn([dataset[i] for i in indices])


class DataLoader:
    """Batches of ``dataset`` in the order of ``batch_sampler``,
    collated by ``collate_fn`` ahead of the consumer: ``prefetch_depth``
    batches (per worker with ``num_workers > 1``; one on the thread
    path with ``num_workers`` 0, as in the JAX loader).

    Args:
        dataset: indexable samples.
        batch_sampler: iterable of index lists (``set_epoch`` is the
            caller's).
        collate_fn (Callable): samples -> batch (numpy).
        num_workers (int): <= 1 the producer thread, > 1 the process
            pool.
        prefetch_depth (int): batches fetched ahead.
        seed (int): the workers' base seed (None: drawn from
            ``np.random``).
    """

    def __init__(self, dataset, batch_sampler,
                 collate_fn: Optional[Callable] = None,
                 num_workers: int = 1, prefetch_depth: int = 2,
                 seed: Optional[int] = None, **_):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn or _identity_collate
        self.num_workers = max(0, int(num_workers))
        self.prefetch_depth = max(1, prefetch_depth if num_workers else 1)
        self.seed = seed
        self._epoch = 0

    # -- the producer thread (num_workers <= 1) --------------------------

    @staticmethod
    def _put(q: "queue.Queue", stop: threading.Event, item) -> bool:
        """Put with stop-polling, so an abandoned consumer never leaves
        the producer parked on a full queue."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, q: "queue.Queue", stop: threading.Event) -> None:
        tl = timeline.track("data-loader")
        try:
            for indices in self.batch_sampler:
                if stop.is_set():
                    return
                t0 = tl.begin()
                item = ("batch", self.collate_fn(
                    [self.dataset[i] for i in indices]))
                tl.add("load", t0)
                t0 = tl.begin()
                ok = self._put(q, stop, item)
                tl.add("wait", t0)
                if not ok:
                    return
        except BaseException as e:  # noqa: BLE001 -- raised in the consumer
            self._put(q, stop, ("error", e))
        finally:
            self._put(q, stop, ("done", None))

    def _iter_threaded(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()
        worker = threading.Thread(target=self._produce, args=(q, stop),
                                  name="data-loader", daemon=True)
        worker.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "batch":
                    yield payload
                elif kind == "error":
                    raise payload
                else:
                    break
        finally:
            stop.set()

    # -- the process pool (num_workers > 1) ------------------------------

    def _iter_processes(self) -> Iterator:
        try:
            ctx = multiprocessing.get_context("forkserver")
        except ValueError as e:  # a platform without forkserver
            logger.warning("num_workers=%d needs a forkserver context; "
                           "taking the threaded loader (%s)",
                           self.num_workers, e)
            yield from self._iter_threaded()
            return
        try:
            blob = pickle.dumps((self.dataset, self.collate_fn))
        except (pickle.PicklingError, TypeError, AttributeError) as e:
            logger.warning(
                "num_workers=%d needs a picklable (dataset, collate_fn); "
                "taking the threaded loader (%s)", self.num_workers, e)
            yield from self._iter_threaded()
            return
        pool = ProcessPoolExecutor(max_workers=self.num_workers,
                                   mp_context=ctx,
                                   initializer=_worker_init,
                                   initargs=(blob,))
        base = self.seed if self.seed is not None else \
            int(np.random.randint(0, 2 ** 31))
        base = base + 100003 * self._epoch
        self._epoch += 1
        window = self.prefetch_depth * self.num_workers
        pending: "collections.deque" = collections.deque()
        sampler_iter = iter(self.batch_sampler)
        try:
            exhausted = False
            ordinal = 0
            while True:
                while not exhausted and len(pending) < window:
                    try:
                        indices = next(sampler_iter)
                    except StopIteration:
                        exhausted = True
                        break
                    pending.append(pool.submit(_worker_fetch,
                                               base + ordinal,
                                               list(indices)))
                    ordinal += 1
                if not pending:
                    break
                # strict sampler order: the oldest future is the next
                # batch; .result() raises a worker's exception here
                yield pending.popleft().result()
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    def __iter__(self) -> Iterator:
        if self.num_workers > 1:
            return self._iter_processes()
        return self._iter_threaded()

    def __len__(self) -> int:
        return len(self.batch_sampler)
