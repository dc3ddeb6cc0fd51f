"""Host-side prefetch for the input pipeline.

Port of ``ParallelEpoch`` and ``ProcessEpoch`` of
``vcagan/data/prefetch.py:73-304``.  The reference overlaps decode with
compute through DataLoader worker processes (reference: train.py:139-146).
``ParallelEpoch`` (the default): one producer thread runs the dataset's
epoch (decode and collate, fanned out over the dataset's own thread pool;
numpy, scipy and cv2 release the GIL) and keeps ``depth`` batches ready.
``ProcessEpoch``: the epoch runs in a forked worker process, which hands
each batch over in shared memory.  One thread (or the worker) makes every
numpy draw of the epoch, so the batches are the same whatever the pool's
size, and the JAX package's for the same seed.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from typing import Iterable, Iterator, Optional

import numpy as np
import torch


def prefetch_iterator(iterable: Iterable, depth: int = 2) -> Iterator:
    """Wrap an iterator; a background thread keeps ``depth`` items ready.

    The producer stops when the consumer abandons the generator (break,
    exception, garbage collection): every ``put`` is a short-timeout poll
    against a stop event that the generator's ``finally`` sets, so no
    thread is left blocked on a full queue.  The ``finally`` then waits for
    the producer to end (at most the item it is making): a thread left
    inside a native call, pinning memory or decoding, can abort the process
    when the interpreter exits under it."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    errors = []
    stop = threading.Event()

    def put(item) -> bool:
        """Blocking put that gives up once the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterable:
                if not put(item):
                    return
        except BaseException as e:  # raised again in the consumer
            errors.append(e)
        finally:
            put(end)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if errors:
                    raise errors[0]
                return
            yield item
    finally:
        stop.set()
        thread.join()


def _as_tensors(raw: dict, pin: bool) -> dict:
    """numpy arrays -> CPU tensors (pinned, for an asynchronous copy);
    0-dim values (``n_valid``) stay as they are."""
    out = {}
    for k, v in raw.items():
        if isinstance(v, np.ndarray) and v.ndim > 0:
            t = torch.from_numpy(np.ascontiguousarray(v))
            v = t.pin_memory() if pin else t
        out[k] = v
    return out


class ParallelEpoch:
    """One epoch of ``dataset`` in batches of ``batch_size``, collated
    ``depth`` batches ahead of the training loop.

    With ``device`` the batches arrive as tensors on it: the producer
    thread pins each batch's arrays, and the consumer's thread issues the
    copies with ``non_blocking=True`` on its current stream, where they are
    ordered before every kernel that it queues after them, the input
    pipeline's first.  The copies leave the host at once; the pinned
    buffers are kept until their copy has run (PyTorch's pinned-memory
    allocator records the copy on the stream).

    ``collate_s`` gets the producer's seconds for each batch (collate and
    pin) as it makes them.  ``process_slice``: the rank's slice of each
    global batch of ``batch_size`` (``dataset.epoch(..., process_slice=)``)."""

    def __init__(self, dataset, batch_size: int, depth: int = 2,
                 device: Optional[torch.device] = None, process_slice: Optional[slice] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.depth = depth
        self.device = None if device is None else torch.device(device)
        self.process_slice = process_slice
        self.collate_s: list[float] = []

    def _host_batches(self) -> Iterator[dict]:
        batches = _epoch(self.dataset, self.batch_size, self.process_slice)
        pin = self.device is not None and self.device.type == "cuda"
        while True:
            t0 = time.perf_counter()
            raw = next(batches, None)
            if raw is None:
                return
            if self.device is not None:
                raw = _as_tensors(raw, pin)
            self.collate_s.append(time.perf_counter() - t0)
            yield raw

    def __iter__(self) -> Iterator[dict]:
        with contextlib.closing(prefetch_iterator(self._host_batches(), self.depth)) as items:
            for raw in items:
                if self.device is not None:
                    raw = {k: v.to(self.device, non_blocking=True) if torch.is_tensor(v) else v
                           for k, v in raw.items()}
                yield raw


def _epoch(dataset, batch_size: int, process_slice: Optional[slice]) -> Iterator[dict]:
    """``dataset.epoch(batch_size)``, with the rank's ``process_slice``
    where there is one."""
    if process_slice is None:
        return dataset.epoch(batch_size)
    return dataset.epoch(batch_size, process_slice=process_slice)


def _shm_collate_worker(dataset, batch_size: int, process_slice: Optional[slice],
                        ready_q) -> None:
    """Body of the forked collate worker: run one epoch of ``dataset`` and
    publish each batch in a new ``SharedMemory`` block.

    The parent has a CUDA context; the worker touches no tensor and calls
    no CUDA API: the datasets' epochs are numpy, scipy and cv2 only.  Each
    message: the block's name, a (key, dtype, shape, offset) list, the
    batch's collate seconds and the dataset rng's state after the batch's
    draws; then ("__end__", final rng state), or ("__error__", repr) on
    any exception, flushed before ``os._exit``.  The parent owns the
    blocks (it copies each batch out and unlinks it), so the worker
    unregisters them from its resource tracker."""
    from multiprocessing import resource_tracker, shared_memory

    try:
        # a forked ThreadPoolExecutor is a husk (its threads do not survive
        # the fork): the dataset's decode pool is rebuilt here
        pool = getattr(dataset, "_pool", None)
        if pool is not None:
            from concurrent.futures import ThreadPoolExecutor

            dataset._pool = ThreadPoolExecutor(max_workers=pool._max_workers)
        batches = _epoch(dataset, batch_size, process_slice)
        while True:
            t0 = time.perf_counter()
            raw = next(batches, None)
            if raw is None:
                break
            items = [(k, np.asarray(v, order="C")) for k, v in raw.items()]
            shm = shared_memory.SharedMemory(create=True,
                                             size=max(sum(a.nbytes for _, a in items), 1))
            try:
                resource_tracker.unregister(shm._name, "shared_memory")
            except Exception:
                pass
            meta, off = [], 0
            for k, a in items:
                shm.buf[off:off + a.nbytes] = a.tobytes()
                meta.append((k, a.dtype.str, a.shape, off))
                off += a.nbytes
            name = shm.name
            shm.close()
            ready_q.put((name, meta, time.perf_counter() - t0, dataset.rng.bit_generator.state))
        ready_q.put(("__end__", dataset.rng.bit_generator.state))
        ready_q.close()
        ready_q.join_thread()
    except BaseException as e:  # raised again in the parent
        try:
            ready_q.put(("__error__", repr(e)))
            # flush the queue's feeder thread before os._exit ends it, or the
            # sentinel never reaches the parent
            ready_q.close()
            ready_q.join_thread()
        except Exception:
            pass
    finally:
        os._exit(0)  # no atexit: the parent's state (CUDA, threads) is not the worker's


class ProcessEpoch:
    """One epoch of ``dataset`` decoded and collated in a forked worker
    process (``_shm_collate_worker``), ``depth`` batches ahead, the upload
    done here.  The same protocol as the JAX package's ``ProcessEpoch``
    (``vcagan/data/prefetch.py:126-304``): fork, one shared-memory block a
    batch with its meta through a bounded queue, an error sentinel, the
    published blocks unlinked when the consumer abandons the epoch.

    A producer thread here takes each batch off the queue and copies it out
    of its block (into pinned memory for a CUDA ``device``) and unlinks the
    block; the consumer's thread issues the copies with
    ``non_blocking=True`` on its current stream, as ``ParallelEpoch``
    does.  ``collate_s`` gets each batch's seconds: the worker's collate
    plus the copy out (and pin).

    The dataset's rng: the worker advances its copy of ``dataset.rng``, so
    this process's copy is set to the worker's state after each batch it
    takes, and to the final state at the epoch's end.  So the next epoch
    draws a fresh shuffle and windows, and the batches equal
    ``ParallelEpoch``'s byte for byte, epoch for epoch.  (The JAX package's
    ``ProcessEpoch`` never advances the parent's rng: every epoch repeats
    the first one's draws.)  What the worker renders or caches (synthetic
    clips rendered on first use) stays in the worker: clips that this
    process has not rendered are rendered again each epoch.
    ``process_slice`` as ``ParallelEpoch``'s (the worker yields the slice)."""

    def __init__(self, dataset, batch_size: int, depth: int = 2,
                 device: Optional[torch.device] = None, process_slice: Optional[slice] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.depth = depth
        self.device = None if device is None else torch.device(device)
        self.process_slice = process_slice
        self.collate_s: list[float] = []

    def _copy_out(self, name: str, meta) -> dict:
        """The batch in block ``name`` as arrays (pinned tensors for a CUDA
        device) of this process's own; the block is unlinked."""
        from multiprocessing import shared_memory

        pin = self.device is not None and self.device.type == "cuda"
        shm = shared_memory.SharedMemory(name=name)
        try:
            raw = {}
            for k, dt, shape, off in meta:
                dtype = np.dtype(dt)
                count = int(np.prod(shape, dtype=np.int64))
                view = np.frombuffer(shm.buf, dtype=dtype, count=count, offset=off).reshape(shape)
                if not shape:  # n_valid: a numpy scalar, as the dataset yields it
                    raw[k] = np.array(view)[()]
                elif self.device is not None:
                    t = torch.empty(shape, dtype=torch.from_numpy(view[:0]).dtype, pin_memory=pin)
                    t.numpy()[...] = view
                    raw[k] = t
                else:
                    raw[k] = np.array(view)
                del view
        finally:
            shm.close()
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
        return raw

    def _host_batches(self, child, ready_q) -> Iterator[dict]:
        from multiprocessing import shared_memory

        rng = self.dataset.rng  # set where the worker's stands
        try:
            while True:
                try:
                    msg = ready_q.get(timeout=1.0)
                except queue.Empty:
                    if not child.is_alive():
                        raise RuntimeError("collate worker died without a sentinel "
                                           f"(exit code {child.exitcode})")
                    continue
                if msg[0] == "__end__":
                    rng.bit_generator.state = msg[1]
                    return
                if msg[0] == "__error__":
                    raise RuntimeError(f"collate worker failed: {msg[1]}")
                name, meta, collate_s, state = msg
                t0 = time.perf_counter()
                raw = self._copy_out(name, meta)
                rng.bit_generator.state = state
                self.collate_s.append(collate_s + time.perf_counter() - t0)
                yield raw
        finally:
            if child.is_alive():
                child.terminate()
            # unlink what the worker published before it ended
            try:
                while True:
                    msg = ready_q.get_nowait()
                    if msg[0] not in ("__end__", "__error__"):
                        try:
                            shared_memory.SharedMemory(name=msg[0]).unlink()
                        except FileNotFoundError:
                            pass
            except (queue.Empty, OSError, ValueError):
                pass
            child.join(timeout=5)
            ready_q.close()

    def __iter__(self) -> Iterator[dict]:
        import multiprocessing as mp

        ctx = mp.get_context("fork")
        ready_q = ctx.Queue(maxsize=self.depth)
        child = ctx.Process(target=_shm_collate_worker,
                            args=(self.dataset, self.batch_size, self.process_slice, ready_q),
                            daemon=True)
        child.start()
        with contextlib.closing(prefetch_iterator(self._host_batches(child, ready_q), 1)) as items:
            for raw in items:
                if self.device is not None:
                    raw = {k: v.to(self.device, non_blocking=True) if torch.is_tensor(v) else v
                           for k, v in raw.items()}
                yield raw
