"""Spans and counters inside the program, held in memory until read.

A span names an interval of the program's work at a layer boundary
(``span("serve.v_front")``); a counter counts work done there
(``count("attention.launches", 2)``).

Tracing is off by default.  Off, ``span`` checks one module flag and
returns a shared no-op context: nothing is allocated, recorded or opened.
``enable()`` turns it on: each span then opens the profiler range
``vcagan.<name>`` (``torch.profiler.record_function``, so under a profiler
session it lies on the same timeline as the card's kernels) and keeps its
host interval (``time.perf_counter_ns``), its parent span, the id of the
call it belongs to (a span opened with no span open starts a new call: one
serving call, one train step) and, with ``device_events`` on a machine with
CUDA, a pair of timing CUDA events on the current stream.
``enable(device_events=False)`` opens the ranges and records no event, so a
profiled stretch gets its labels without added device work.

Counters count whether tracing is on or off.  ``read()`` returns the spans
and the counters and clears both; it waits for the device where spans hold
events, so call it after the timed work.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

PREFIX = "vcagan."

_on = False
_events = False
_NOOP = contextlib.nullcontext()
_records: list = []
_counters: Dict[str, int] = {}
_calls = itertools.count(1)
_local = threading.local()


class SpanRecord(NamedTuple):
    """One span as ``read`` returns it: ``parent`` is the index of the
    enclosing span in the same list (None for a call's outermost span),
    ``call`` the id its call shares, ``device_ms`` None without events."""

    name: str
    call: int
    parent: Optional[int]
    start_ns: int
    end_ns: int
    device_ms: Optional[float]


class _Span:
    __slots__ = ("name", "call", "parent", "range", "start_ns", "end_ns", "begin", "end")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.call = self.parent.call if self.parent else next(_calls)
        stack.append(self)
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        self.end_ns = self.begin = self.end = None
        if _events:
            self.begin = torch.cuda.Event(enable_timing=True)
            self.begin.record()
        self.start_ns = time.perf_counter_ns()
        _records.append(self)
        return self

    def __exit__(self, *exc) -> None:
        if self.begin is not None:
            self.end = torch.cuda.Event(enable_timing=True)
            self.end.record()
        self.end_ns = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _local.stack.pop()


def span(name: str):
    """A context that traces ``name`` where tracing is on; the shared no-op
    context where it is off."""
    if not _on:
        return _NOOP
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, whether tracing is on or off."""
    _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of the counters, left as they are."""
    return dict(_counters)


def enable(device_events: bool = True) -> None:
    """Turn spans on; ``device_events``: time each on the card too."""
    global _on, _events
    _on, _events = True, device_events and torch.cuda.is_available()


def disable() -> None:
    global _on, _events
    _on, _events = False, False


@contextlib.contextmanager
def enabled(device_events: bool = True) -> Iterator[None]:
    """Spans on inside the block, and as they were after it."""
    global _on, _events
    was = _on, _events
    enable(device_events)
    try:
        yield
    finally:
        _on, _events = was


def read() -> Dict[str, object]:
    """``{"spans": [SpanRecord], "counters": {name: n}}``, the spans closed
    so far in the order they opened; clears both."""
    global _records, _counters
    records, counts = _records, _counters
    _records, _counters = [], {}
    closed = [r for r in records if r.end_ns is not None]
    if any(r.end is not None for r in closed):
        torch.cuda.synchronize()
    index = {id(r): i for i, r in enumerate(closed)}
    spans: List[SpanRecord] = [
        SpanRecord(r.name, r.call, index.get(id(r.parent)), r.start_ns, r.end_ns,
                   r.begin.elapsed_time(r.end) if r.end is not None else None)
        for r in closed]
    return {"spans": spans, "counters": counts}
