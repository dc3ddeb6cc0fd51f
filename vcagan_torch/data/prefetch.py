"""Host-side prefetch for the input pipeline.

Port of ``ParallelEpoch`` of ``vcagan/data/prefetch.py:73-124``.  The
reference overlaps decode with compute through DataLoader worker processes
(reference: train.py:139-146).  Here one producer thread runs the
dataset's epoch (decode and collate, fanned out over the dataset's own
thread pool; numpy, scipy and cv2 release the GIL) and keeps ``depth``
batches ready.  One thread makes every numpy draw of the epoch, so the
batches are the same whatever the pool's size, and the JAX package's for
the same seed.
"""

from __future__ import annotations

import contextlib
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
    pin) as it makes them."""

    def __init__(self, dataset, batch_size: int, depth: int = 2,
                 device: Optional[torch.device] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.depth = depth
        self.device = None if device is None else torch.device(device)
        self.collate_s: list[float] = []

    def _host_batches(self) -> Iterator[dict]:
        batches = self.dataset.epoch(self.batch_size)
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
