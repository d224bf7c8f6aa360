"""Threaded host input pipeline with device prefetch.

The port's own copy of `dig_tpu/data/pipeline.py`; it stands where the
reference has torch's `DataLoader(num_workers=10, pin_memory=True)`
(run_mae_pretraining_moco.py:365-372).  This loader is kept, and not
`torch.utils.data.DataLoader`, because it fans out per sample in a fixed
order: with the same seed and one worker it yields the JAX package's
batches byte for byte, which the parity tests stand on.  Decode and
augmentation are CPU-bound but mostly GIL-releasing (cv2, numpy), so the
default thread pool suffices; `worker_type="process"` switches to
process workers for hosts where Python-level augmentation serializes on
the GIL: those start from a ``forkserver`` (never a fork of this process,
which may hold threads and the card) and receive the dataset pickled; the
datasets pickle their constructor arguments and reopen their LMDB readers
in the child.  Batches are assembled as contiguous numpy arrays;
`device_prefetch` with `pinned_to_device` keeps a few of them in flight to
the card through pinned memory, so the only host-to-device copies of a
step happen here and overlap the previous step.

Deviations from the JAX package: it forks its process workers from the
loading process, this loader starts them from a forkserver; a process
worker reseeds its streams from its ordinal (0 .. num_workers - 1, in the
order the workers start), not from its PID, so a run with process workers
draws from the same set of streams every time.  Which worker serves which
sample is still decided by arrival, as with threads.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

import numpy as np


def _spawn_child(base: np.random.Generator) -> np.random.Generator:
    """`base.spawn(1)[0]`; on a numpy before 1.25, which has no
    `Generator.spawn`, the same child through the seed sequence."""
    if hasattr(base, "spawn"):
        return base.spawn(1)[0]
    bit = base.bit_generator
    seq = getattr(bit, "seed_seq", None) or bit._seed_seq
    return np.random.Generator(type(bit)(seq.spawn(1)[0]))


class ThreadLocalRng:
    """numpy Generator facade that hands each thread its own independent
    child stream (``Generator.spawn``).  numpy Generators are not
    thread-safe; with the loader's per-sample fan-out, augmentation code
    holding one shared Generator would race.  Single-threaded use sees
    exactly one child stream, so seeded runs stay reproducible."""

    def __init__(self, base: np.random.Generator):
        self._base = base
        self._lock = threading.Lock()
        self._tl = threading.local()

    def _rng(self) -> np.random.Generator:
        g = getattr(self._tl, "g", None)
        if g is None:
            with self._lock:
                g = _spawn_child(self._base)
            self._tl.g = g
        return g

    def reseed(self, seed: int) -> None:
        """Replace the base stream and drop any cached thread-local
        children.  Used by process workers as they start: every worker
        receives the parent's RNG state bit-for-bit, so without a
        per-worker reseed all workers would produce IDENTICAL
        augmentation streams (the reference guards the same hazard with
        `seed_worker`, utils/utils.py)."""
        with self._lock:
            self._base = np.random.default_rng(seed)
            self._tl = threading.local()

    def __getstate__(self):
        return {"base": self._base}

    def __setstate__(self, state):
        self.__init__(state["base"])

    def __getattr__(self, name):
        return getattr(self._rng(), name)


def reseed_dataset_rngs(dataset, seed: int) -> None:
    """Best-effort walk reseeding every ThreadLocalRng a dataset (or a
    ConcatDataset of them) holds.  Augment objects share the dataset's
    `rng` reference, so reseeding the dataset covers them too."""
    rng = getattr(dataset, "rng", None)
    if isinstance(rng, ThreadLocalRng):
        rng.reseed(seed)
    for i, child in enumerate(getattr(dataset, "datasets", []) or []):
        reseed_dataset_rngs(child, seed * 1000003 + i)


# ---------------------------------------------------------------------------
# Process workers (forkserver).  Each worker is forked from a server process
# that was started fresh, never from this one: a fork of a process that runs
# threads, or has initialised CUDA, may inherit a lock that is held forever.
# The dataset reaches the worker pickled (as its constructor arguments; the
# LMDB reader is reopened there), with the shared start counter; each worker
# reseeds its RNGs from its ordinal (see ThreadLocalRng.reseed).  A worker
# runs numpy and cv2 only: it never touches the model or the card.  Use when
# host augmentation is pure-Python (GIL-bound) or the host has cores to
# spare; the default thread pool is cheaper when the per-sample work releases
# the GIL (cv2/numpy).
# ---------------------------------------------------------------------------

_proc_dataset = None


def _proc_init(dataset, base_seed: int, ordinals) -> None:
    """`ordinals` is a shared counter: each worker takes the next value as
    it starts and reseeds the dataset's streams from base_seed + ordinal."""
    global _proc_dataset
    _proc_dataset = dataset
    with ordinals.get_lock():
        ordinal = ordinals.value
        ordinals.value += 1
    reseed_dataset_rngs(dataset, base_seed + ordinal)
    try:  # cv2 workers must not spawn their own thread pools (1 core each)
        import cv2

        cv2.setNumThreads(0)
    except ImportError:
        pass


def _proc_getitem(i: int):
    return _proc_dataset[i]


def stop_worker_processes(timeout: float = 30.0) -> list:
    """Stop every process that process workers started, for a program that
    must leave none behind when it exits: wait up to `timeout` s for the
    workers of finished or abandoned iterators (terminating any still
    alive then), then stop the forkserver and the resource tracker.  Left
    alone, the forkserver outlives its program by the seconds its own
    interpreter takes to shut down.  Call it once no loader is being read;
    a later process-worker loader starts a new server.  Returns the names
    of the workers that had to be terminated."""
    import multiprocessing as mp
    from multiprocessing import forkserver, resource_tracker

    deadline = time.monotonic() + timeout
    terminated = []
    for p in mp.active_children():
        p.join(max(0.0, deadline - time.monotonic()))
        if p.is_alive():
            terminated.append(p.name)
            p.terminate()
            p.join(5.0)
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()
    return terminated


def _stack(samples):
    """Collate a list of per-sample tuples/dicts into batched numpy arrays."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(np.stack([s[i] for s in samples]) for i in range(len(first)))
    return np.stack(samples)


def pinned_to_device(arrays: dict, device) -> dict:
    """A dict of numpy arrays -> tensors on `device`.  For a CUDA device
    each array goes through pinned host memory and an asynchronous copy
    (`non_blocking=True`) on the current stream, so the call returns before
    the copy has run; a step launched later on that stream sees the data."""
    import torch

    device = torch.device(device)
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def device_prefetch(iterator, to_device: Callable, depth: int = 2):
    """Keep `depth` batches in flight to the device, so that the copy of
    batch N+1 is queued while batch N computes (the reference relies on
    pinned-memory non_blocking copies for this;
    engine_for_pretraining_moco.py:77-80).  `to_device` is e.g.
    `pinned_to_device` over the batch's arrays."""
    import collections

    queue_ = collections.deque()
    for item in iterator:
        queue_.append(to_device(item))
        if len(queue_) >= depth:
            yield queue_.popleft()
    while queue_:
        yield queue_.popleft()


def make_train_loader(dataset, *, local_batch: int, rank: int, world: int,
                      seed: int, num_workers: int,
                      batch_wise_shuffle: bool = False,
                      worker_type: str = "thread"):
    """The training sampler/loader wiring shared by both CLIs: either a
    per-host `ShardedSampler` + fixed batch size, or — with
    ``batch_wise_shuffle`` — the `MultiSourceBatchSampler` that draws every
    batch from ONE source LMDB (the sampler the reference ships but never
    wires; dist_multisrc_batch_sampler.py:14-154).

    Every rank gets the same number of batches, each of exactly
    `local_batch` rows (the sharded sampler pads the epoch to a multiple of
    the world size and the loader drops a last partial batch; the
    multi-source sampler yields whole global batches only): the
    data-parallel losses are means over a rank's rows, and the mean of the
    ranks' means is the global batch's only when the ranks' batches are
    equal."""
    from dig_tpu_torch.data.samplers import MultiSourceBatchSampler, ShardedSampler

    if batch_wise_shuffle:
        sampler = MultiSourceBatchSampler(
            getattr(dataset, "cumulative_sizes", [len(dataset)]),
            batch_size=local_batch, rank=rank, world=world, seed=seed)
        return DataLoader(dataset, sampler, batch_size=None,
                          num_workers=num_workers, worker_type=worker_type,
                          seed=seed)
    sampler = ShardedSampler(len(dataset), rank=rank, world=world, seed=seed)
    return DataLoader(dataset, sampler, batch_size=local_batch,
                      num_workers=num_workers, worker_type=worker_type,
                      seed=seed, drop_last=True)


class DataLoader:
    """Minimal threaded loader: sampler -> fetch pool -> prefetch queue.

    `sampler` yields either ints (then `batch_size` groups them) or lists
    of ints (batch samplers).  Iteration order is deterministic given the
    sampler; worker threads only parallelize the per-sample work.
    """

    def __init__(
        self,
        dataset,
        sampler: Iterable,
        batch_size: Optional[int] = None,
        num_workers: int = 8,
        prefetch: int = 4,
        drop_last: bool = True,
        collate: Callable = _stack,
        to_device: Optional[Callable] = None,
        worker_type: str = "thread",
        seed: int = 0,
    ):
        assert worker_type in ("thread", "process"), worker_type
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.collate = collate
        self.to_device = to_device
        self.worker_type = worker_type
        self.seed = seed

    def _batches(self) -> Iterator[list]:
        if self.batch_size is None:
            yield from self.sampler
            return
        cur = []
        for idx in self.sampler:
            cur.append(idx)
            if len(cur) == self.batch_size:
                yield cur
                cur = []
        if cur and not self.drop_last:
            yield cur

    def __len__(self):
        try:
            n = len(self.sampler)
        except TypeError:
            return 0
        if self.batch_size is None:
            return n
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that re-checks stop: the consumer may abandon
            # iteration (break/exception) with the queue full, and a plain
            # put() would park this thread — and its worker pool — forever
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    pass
            return False

        def make_pool():
            if self.worker_type == "process":
                import multiprocessing as mp
                from concurrent.futures import ProcessPoolExecutor

                ctx = mp.get_context("forkserver")
                # the server imports the dataset's module (torch included)
                # once, before it forks any worker: a worker starts with it
                # loaded instead of importing it anew (seconds each)
                ctx.set_forkserver_preload([type(self.dataset).__module__])
                return ProcessPoolExecutor(
                    self.num_workers, mp_context=ctx, initializer=_proc_init,
                    initargs=(self.dataset, self.seed, ctx.Value("i", 0))), _proc_getitem
            return (ThreadPoolExecutor(self.num_workers),
                    self.dataset.__getitem__)

        def produce():
            pool, fetch = make_pool()
            pending = []

            def drain(futs) -> bool:
                return put(("ok", self.collate([f.result() for f in futs])))

            try:
                for batch_idx in self._batches():
                    if stop.is_set():
                        break
                    # fan out per SAMPLE, not per batch: decode/aug of one
                    # batch spreads over all workers (cv2/numpy release
                    # the GIL), so batch latency is ~1/num_workers of the
                    # serial cost on multi-core hosts
                    pending.append([pool.submit(fetch, i) for i in batch_idx])
                    while len(pending) >= self.prefetch:
                        if not drain(pending.pop(0)):
                            break
                for futs in pending:
                    if stop.is_set():
                        break
                    drain(futs)
                put(("end", None))
            except Exception as e:  # propagate into the consumer
                put(("err", e))
            finally:
                # abandoned: drop the queued work and do not wait for the
                # samples in flight
                pool.shutdown(wait=not stop.is_set(), cancel_futures=True)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                kind, payload = out_q.get()
                if kind == "end":
                    break
                if kind == "err":
                    raise payload
                if self.to_device is not None:
                    payload = self.to_device(payload)
                yield payload
        finally:
            stop.set()
