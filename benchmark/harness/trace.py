"""Spans and the device trace of a traced run.

``Spans`` times named intervals on the device: a pair of CUDA events
around each call (host clock off the card), recorded by forward hooks on a
module, by a wrapped function, or by marks at a call's points.  Nothing is
read until the window has closed.  ``DeviceTrace`` runs one
``torch.profiler`` session over a steady sub-window and reduces it to the
device's busy seconds, its longest operations and its idle gaps by the
host range (``record_function("bench.<what>")``) they fell in.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List

import torch


class _HostEvent:
    def __init__(self):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end: "_HostEvent") -> float:
        return (end.t - self.t) * 1e3


class Spans:
    """Named device intervals in ms.  ``enabled=False`` records nothing."""

    def __init__(self, device: torch.device, enabled: bool = True):
        self.cuda = device.type == "cuda"
        self.enabled = enabled
        self.pairs: Dict[str, List[tuple]] = collections.defaultdict(list)
        self.open: Dict[str, List] = collections.defaultdict(list)

    def event(self):
        ev = torch.cuda.Event(enable_timing=True) if self.cuda else _HostEvent()
        ev.record()
        return ev

    def begin(self, name: str) -> None:
        if self.enabled:
            self.open[name].append(self.event())

    def end(self, name: str) -> None:
        if self.enabled:
            self.pairs[name].append((self.open[name].pop(), self.event()))

    def between(self, name: str, start, end) -> None:
        """A span between two events already recorded (``event()``)."""
        if self.enabled:
            self.pairs[name].append((start, end))

    def around(self, module: torch.nn.Module, name: str) -> None:
        module.register_forward_pre_hook(lambda *_: self.begin(name))
        module.register_forward_hook(lambda *_: self.end(name))

    def wrap(self, fn: Callable, name: str, on_call: Callable | None = None) -> Callable:
        def wrapped(*args, **kwargs):
            if on_call is not None and self.enabled:
                on_call(*args, **kwargs)
            self.begin(name)
            out = fn(*args, **kwargs)
            self.end(name)
            return out
        return wrapped

    def ms(self) -> Dict[str, List[float]]:
        """Every span's ms by name (waits for the device)."""
        if self.cuda:
            torch.cuda.synchronize()
        return {name: [a.elapsed_time(b) for a, b in pairs] for name, pairs in self.pairs.items()}


def wrap_attention(spans: Spans, counters: dict) -> None:
    """Spans named "attention" around each call of the program's masked
    cross-attention, as ``vcagan_torch.nn.attention`` calls it, each call's
    shapes and lengths kept in ``counters["attention.calls"]`` (read by
    ``work.attention_calls_least_s`` once the window has closed)."""
    import vcagan_torch.nn.attention as attention_module

    calls = counters.setdefault("attention.calls", [])
    attention_module.masked_cross_attention = spans.wrap(
        attention_module.masked_cross_attention, "attention",
        on_call=lambda q, k, v, lengths: calls.append((q.shape, k.shape[1], lengths)))


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class DeviceTrace:
    """One ``torch.profiler`` session: ``start``, ``stop`` (again a no-op),
    and once the measured window has closed, ``summary`` (which takes
    seconds: it is kept out of the window)."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.window = None
        self.running = False

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof.start()
        self.window = torch.profiler.record_function("bench.window")
        self.window.__enter__()
        self.running = True

    def stop(self) -> None:
        if self.running:
            torch.cuda.synchronize()
            self.window.__exit__(None, None, None)
            self.prof.stop()
            self.running = False

    def summary(self) -> dict | None:
        """busy_s, window_s, the ten device operations that took most time,
        and the idle gaps summed by the host range they began in; None if
        the session never started."""
        if self.window is None:
            return None
        self.stop()
        events = self.prof.events()
        cuda = torch.autograd.DeviceType.CUDA
        window = next(e for e in events if e.name == "bench.window")
        w0, w1 = window.time_range.start, window.time_range.end
        device = [e for e in events if e.device_type == cuda and not e.name.startswith("bench.")]
        busy = [[max(e.time_range.start, w0), min(e.time_range.end, w1)] for e in device]
        busy = _union([iv for iv in busy if iv[1] > iv[0]])
        by_op = collections.Counter()
        for e in device:
            by_op[e.name] += (e.time_range.end - e.time_range.start) / 1e6
        ranges = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                         if e.device_type != cuda and e.name.startswith("bench.")
                         and e.name != "bench.window"), key=lambda r: r[0])
        gaps = collections.Counter()
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            inside = [r for r in ranges if r[0] <= a < r[1]]
            label = min(inside, key=lambda r: r[1] - r[0])[2] if inside else "bench.none"
            gaps[label] += (b - a) / 1e6
        return {
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "window_s": (w1 - w0) / 1e6,
            "device_ops": [[n, s] for n, s in by_op.most_common(10)],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(10)],
        }
