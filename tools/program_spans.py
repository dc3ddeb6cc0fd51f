#!/usr/bin/env python3
"""The port's own spans and ranges (``vcagan_torch.tracing``) in a benchmark
cell, beside the benchmark's hook spans, on the card.

    python3 tools/program_spans.py --workload grid-serve-bf16 --seed 1
    python3 tools/program_spans.py --workload grid-train-bf16 --seed 1 --small  # CPU rehearsal

From the root of the repository.  The cell's set-up runs as
``benchmark/run.py`` runs it (``ServeRun`` / ``TrainRun``: weights, warm-up
or the three checked steps); then, in turns, stretches of two kinds, each
from an empty queue:

- profiled: one ``torch.profiler`` session over ``--profiled`` batches or
  steps, no spans, as the benchmark's profiled stretch; tracing off, then
  its ranges only (``enable(device_events=False)``), then ranges and off
  again.  Each gives the device's busy and window seconds (the mirrors of
  host ranges on the device timeline left out), the idle gaps labelled by
  the innermost ``bench.*`` or ``vcagan.*`` host range open where each
  began, and ``program_idle_s``, the idle time while any ``vcagan.*`` range
  is open;
- spans: the benchmark's hooks on (the cell's ``instrument``) over
  ``--spanned`` batches or steps, the program's spans off, on (with CUDA
  events), on, off: the host seconds of each, and with spans on each
  span's mean device ms a call, next to the hook span of the same interval.

Prints one JSON line (and writes it to ``--out`` where given).
Nothing here is a benchmark metric; it reads what a benchmark that reads
the program's spans would read.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import spec, trace  # noqa: E402
from vcagan_torch import tracing  # noqa: E402

PROGRAM, BENCH = tracing.PREFIX, "bench."
# hook span -> the program's spans that time the same interval (summed a call)
SERVE_PAIRS = {"v_front": ("serve.v_front",), "decoder": ("serve.decoder",),
               "vocoder": ("serve.vocoder",), "fused_block": ("fused_block",),
               "attention": ("attention",)}
TRAIN_PAIRS = {"input": ("train.input",), "gen_forward": ("train.gen_forward",),
               "d_phase": ("train.d_loss", "train.d_backward", "train.d_update"),
               "g_phase": ("train.g_loss", "train.g_backward", "train.g_update"),
               "attention": ("attention",)}
SERVE_PARTS = ("serve.v_front", "serve.decoder", "serve.postnet", "serve.vocoder")
TRAIN_PARTS = tuple(f"train.{p}" for p in ("gen_forward", "d_loss", "d_backward", "d_update",
                                           "g_loss", "g_backward", "g_update"))


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _overlap(intervals, a, b):
    return sum(max(0, min(b, y) - max(a, x)) for x, y in intervals)


def summarise(prof) -> dict:
    """The profiled stretch: busy and window seconds, the ten longest device
    operations, the idle gaps by the innermost host range open where they
    began (``bench.*`` and ``vcagan.*``), and the idle seconds while a
    ``vcagan.*`` range is open.  ``annotations``: device events that mirror a
    host range (the profiler's ``gpu_user_annotation``), which are not work."""
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    window = next(e for e in events if e.name == "bench.window")
    w0, w1 = window.time_range.start, window.time_range.end

    def ranged(name):
        return name.startswith(BENCH) or name.startswith(PROGRAM)

    device = [e for e in events if e.device_type == cuda and not ranged(e.name)]
    mirrors = [e for e in events if e.device_type == cuda and e.name.startswith(PROGRAM)]
    busy = _union([max(e.time_range.start, w0), min(e.time_range.end, w1)] for e in device
                  if min(e.time_range.end, w1) > max(e.time_range.start, w0))
    with_mirrors = _union([max(e.time_range.start, w0), min(e.time_range.end, w1)]
                          for e in device + mirrors
                          if min(e.time_range.end, w1) > max(e.time_range.start, w0))
    ranges = [(e.time_range.start, e.time_range.end, e.name) for e in events
              if e.device_type != cuda and ranged(e.name) and e.name != "bench.window"]
    program = _union([a, b] for a, b, n in ranges if n.startswith(PROGRAM))
    gaps = collections.Counter()
    program_idle = 0.0
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        inside = [r for r in ranges if r[0] <= a < r[1]]
        label = min(inside, key=lambda r: r[1] - r[0])[2] if inside else "bench.none"
        gaps[label] += (b - a) / 1e6
        program_idle += _overlap(program, a, b) / 1e6
    by_op = collections.Counter()
    for e in device:
        by_op[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    kernels = collections.Counter()
    for e in device:
        for k in ("in_block_attention_kernel", "fused_block_kernel"):
            if k in e.name:
                kernels[k] += 1
    busy_s, window_s = sum(b - a for a, b in busy) / 1e6, (w1 - w0) / 1e6
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "idle_pct": 100.0 * (1.0 - busy_s / window_s),
        "program_idle_pct": 100.0 * program_idle / window_s,
        "busy_s_with_mirrors": sum(b - a for a, b in with_mirrors) / 1e6,
        "annotations": len(mirrors),
        "program_idle_s": program_idle,
        "library_kernels": dict(kernels),
        "device_ops": [[n, s] for n, s in by_op.most_common(10)],
        "idle_gaps": [[n, s] for n, s in gaps.most_common(12)],
    }


def profiled(fn, ranges: bool, cuda: bool) -> dict | None:
    """``fn`` under one profiler session (none off the card), tracing's
    ranges on or off."""
    if not cuda:
        with tracing.enabled(device_events=False) if ranges else contextlib.nullcontext():
            fn()
        return None
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with tracing.enabled(device_events=False) if ranges else contextlib.nullcontext():
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        with torch.profiler.record_function("bench.window"):
            fn()
            torch.cuda.synchronize()
        prof.stop()
    tracing.read()  # the ranges' host intervals, not read here
    return summarise(prof)


def by_call(spans) -> dict:
    """The program's spans of a stretch: ``{name: [device ms a call]}``
    (summed over a call's spans of that name), and the host ms of the calls'
    outermost spans."""
    calls = collections.defaultdict(lambda: collections.defaultdict(float))
    host = collections.defaultdict(list)
    for s in spans:
        if s.device_ms is not None:
            calls[s.call][s.name] += s.device_ms
        if s.parent is None:
            host[s.name].append((s.end_ns - s.start_ns) / 1e6)
    names = {n for c in calls.values() for n in c}
    return ({n: [c[n] for c in calls.values() if n in c] for n in names},
            {n: statistics.mean(v) for n, v in host.items()})


def mean(xs):
    return statistics.mean(xs) if xs else None


def agreement(hook_ms: dict, prog: dict, pairs: dict, counts: dict) -> dict:
    """Each hook span's mean ms a call against the program's spans of the
    same interval (``counts``: the calls of each a batch or step)."""
    out = {}
    for hook, names in pairs.items():
        h = mean(hook_ms.get(hook, []))
        per_call = [sum(x) for x in zip(*(prog.get(n, []) for n in names))]
        p = mean(per_call)
        if h is None or p is None:
            out[hook] = None
            continue
        p /= counts.get(hook, 1)
        out[hook] = {"hook_ms": h, "program_ms": p, "gap": (p - h) / h}
    return out


class Serve:
    def __init__(self, cell, seed, device):
        from benchmark.kinds import serve
        self.seed, self.device = seed, device
        self.run = serve.ServeRun(cell, device)
        self.run.warm_up(seed)
        self.traffic = serve.Traffic(cell.traffic, seed)
        self.depth = cell.traffic["depth"]
        cuda = device.type == "cuda"
        most = cell.traffic["batch"] * 160 * (4 * max(cell.traffic["buckets"]) - 1)
        self.slots = [torch.empty(most, pin_memory=cuda) for _ in range(self.depth)]
        self.next = 0
        self.pairs, self.counts = SERVE_PAIRS, {"attention": 2, "fused_block": 5}
        self.whole, self.parts = "serve", SERVE_PARTS

    def stretch(self, n: int) -> float:
        """``n`` batches, ``depth`` ahead, as the window dispatches them;
        host seconds from the first dispatch to the last waveform."""
        inflight = collections.deque()
        end, t0 = self.next + n, time.perf_counter()
        while self.next < end or inflight:
            while len(inflight) < self.depth and self.next < end:
                with torch.profiler.record_function("bench.dispatch"):
                    out = self.run.system(*self.run.inputs(self.traffic, self.seed, self.next))
                    wav = out["wav"]
                    host = self.slots[self.next % self.depth][:wav.numel()].view(wav.shape)
                    host.copy_(wav, non_blocking=True)
                    ev = torch.cuda.Event() if self.device.type == "cuda" else None
                    if ev is not None:
                        ev.record()
                inflight.append(ev)
                self.next += 1
            ev = inflight.popleft()
            with torch.profiler.record_function("bench.wait"):
                if ev is not None:
                    ev.synchronize()
        return time.perf_counter() - t0

    def instrument(self, spans):
        self.run.system.instrument(spans, {})


class Train:
    def __init__(self, cell, seed, device):
        from benchmark.kinds import train
        self.kind, self.device = train, device
        self.run = train.TrainRun(cell, seed, device)
        self.run.check_steps()
        self.ahead = cell.traffic.get("ahead", 1)
        self.next = 0
        self.pairs, self.counts = TRAIN_PAIRS, {"attention": 2}
        self.whole, self.parts = "train.step", TRAIN_PARTS
        self.spans = None

    def stretch(self, n: int) -> float:
        r = self.run
        pending, t0 = collections.deque(), time.perf_counter()
        for _ in range(n):
            raw = r.raws[(self.kind.CHECKED_STEPS + self.next) % len(r.raws)]
            with torch.profiler.record_function("bench.step"):
                metrics = r.system.step(raw, r.generator, self.spans)
            if self.spans is not None:
                m = r.marks
                self.spans.between("gen_forward", m["step_start"], m["gen_forward"])
                self.spans.between("d_phase", m["gen_forward"], m["d_update"])
                self.spans.between("g_phase", m["d_update"], m["g_update"])
            pending.append(metrics)
            while len(pending) > self.ahead:
                with torch.profiler.record_function("bench.read_metrics"):
                    float(pending.popleft()["gen_loss"])
            self.next += 1
        float(metrics["gen_loss"])
        return time.perf_counter() - t0

    def instrument(self, spans):
        self.run.system.instrument(spans, {})
        self.run.spans = self.spans = spans
        spans.enabled = True


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--profiled", type=int, default=0, help="batches or steps a profiled "
                   "stretch (default: the traffic's trace_batches / trace_steps)")
    p.add_argument("--spanned", type=int, default=16, help="batches or steps a spans stretch")
    p.add_argument("--small", action="store_true", help="the CPU tests' tiny cell, on the CPU")
    p.add_argument("--out", help="a file to write the JSON line to as well")
    args = p.parse_args(argv)
    if args.small:
        sys.path.insert(0, os.path.join(ROOT, "benchmark", "tests"))
        from helpers_bench import small_cell
        cell, device = small_cell(args.workload), torch.device("cpu")
    else:
        cell = spec.load_cell(spec.load_benchmark(), args.workload)
        device = torch.device("cuda", 0)
    cuda = device.type == "cuda"
    if cuda:
        from benchmark.reference import model
        model.plain_numerics()
    kind = cell.traffic["kind"]
    t0 = time.perf_counter()
    subject = (Serve if kind == "serve" else Train)(cell, args.seed, device)
    setup_s = time.perf_counter() - t0
    n = args.profiled or cell.traffic.get("trace_batches" if kind == "serve" else "trace_steps")

    subject.stretch(2)  # the queue's steady state once before the stretches
    profiles = {"off": [], "ranges": []}
    for ranges in (False, True, True, False):
        s = profiled(lambda: subject.stretch(n), ranges, cuda)
        if s is not None:
            profiles["ranges" if ranges else "off"].append(s)

    spans = trace.Spans(device, enabled=True)
    subject.instrument(spans)
    host = {"off": [], "on": []}
    readings = []
    for on in (False, True, True, False):
        spans.pairs.clear()
        tracing.read()
        if on:
            tracing.enable(device_events=True)
        host["on" if on else "off"].append(subject.stretch(args.spanned) / args.spanned)
        tracing.disable()
        got = tracing.read()
        if on:
            prog, host_ms = by_call(got["spans"])
            hooks = spans.ms()
            parts = [sum(x) for x in zip(*(prog.get(name, []) for name in subject.parts))]
            whole = prog.get(subject.whole, [])
            readings.append({
                "agreement": agreement(hooks, prog, subject.pairs, subject.counts),
                "mean_ms": {name: mean(v) for name, v in sorted(prog.items())},
                "parts_over_whole": (sum(parts) / sum(whole)) if whole and parts else None,
                "host_ms": host_ms, "counters": got["counters"]})
    out = {"workload": cell.name, "seed": args.seed, "device": (
        torch.cuda.get_device_name(0) if cuda else "cpu"), "setup_s": setup_s,
        "card": _card() if cuda else None, "profiled": n, "spanned": args.spanned,
        "profiles": profiles, "spans_stretch_host_s": host, "readings": readings}
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


if __name__ == "__main__":
    sys.exit(main())
