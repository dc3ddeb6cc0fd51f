#!/usr/bin/env python3
"""Where a train step's device kernels are launched: each kernel of a profiled
stretch tied to the aten op that launched it, that op's operand shapes, the
autograd node and aten ops above it, and the program range (``vcagan.*``)
open on the host when it was called.

    python3 tools/conv_sites.py --workload grid-train-bf16 --seed 1
    python3 tools/conv_sites.py --workload grid-train-bf16 --small   # CPU rehearsal

From the root of the repository.  The cell's set-up runs as
``benchmark/run.py`` runs it (``TrainRun``: weights, the three checked
steps); two steps settle the queue, then ``--steps`` steps run under one
``torch.profiler`` session with ``record_shapes`` and the program's ranges
on (``tracing.enable(device_events=False)``).

Prints one JSON line (and writes it to ``--out`` where given): the device ms
a step of the kernels whose names hold one of ``--match`` (cuDNN's SIMT
convolutions by default), split by whether ``aten::_convolution_double_backward``
is among the launching op's ancestors, and by program range; the same
split of all kernels; the device's busy ms a step (the union of its
kernels' intervals), beside the sum of their durations; how many
double-backward ops a step runs; and the largest groups of (kernel,
range, autograd node, aten chain, shapes) by device ms a step.  On the CPU
there are no kernels: the op counts alone are read.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for path in (ROOT, HERE):
    if path not in sys.path:
        sys.path.insert(0, path)

import torch  # noqa: E402

from benchmark.harness import spec  # noqa: E402
from program_spans import Train, _card, _union  # noqa: E402
from vcagan_torch import tracing  # noqa: E402

DOUBLE = "aten::_convolution_double_backward"
SIMT = ("implicit_convolve_sgemm", "precomputed_convolve_sgemm")
ENGINE = "autograd::engine::evaluate_function: "


def _ancestors(e):
    while e.cpu_parent is not None:
        e = e.cpu_parent
        yield e


def _range_at(ranges, t_us: float) -> str:
    """The innermost program range whose host interval holds ``t_us``."""
    inside = [r for r in ranges if r[0] <= t_us < r[1]]
    return min(inside, key=lambda r: r[1] - r[0])[2] if inside else "none"


def sites(prof, steps: int, match=SIMT, top: int = 40) -> dict:
    events = prof.events()
    ranges = [(e.time_range.start, e.time_range.end, e.name[len(tracing.PREFIX):])
              for e in events if e.name.startswith(tracing.PREFIX)
              and e.device_type == torch.autograd.DeviceType.CPU
              and e.name != tracing.PREFIX + "train.step"]
    groups = collections.defaultdict(lambda: [0.0, 0])
    matched = collections.defaultdict(float)
    under = collections.defaultdict(float)
    total = 0.0
    doubles = sum(1 for e in events if e.name == DOUBLE)
    for e in events:
        if not e.kernels:
            continue
        up = list(_ancestors(e))
        node = next((a.name[len(ENGINE):] for a in up if a.name.startswith(ENGINE)), "forward")
        chain = [a.name for a in reversed(up) if a.name.startswith("aten::")] + [e.name]
        double = DOUBLE in chain
        where = _range_at(ranges, e.time_range.start)
        for k in e.kernels:
            ms = k.duration / 1e3 / steps
            total += ms
            under["double_backward" if double else "elsewhere"] += ms
            name = k.name.split("(")[0][:96]
            g = groups[(name, where, node, " > ".join(chain), str(e.input_shapes))]
            g[0] += ms
            g[1] += 1
            if any(m in k.name for m in match):
                matched[("double_backward" if double else "elsewhere", where)] += ms
    by_kind = collections.defaultdict(float)
    for (kind, _), ms in matched.items():
        by_kind[kind] += ms
    cuda = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(tracing.PREFIX)]
    return {
        "device_ms_per_step": total,
        "device_events_ms_per_step": sum(e.time_range.elapsed_us() for e in cuda) / 1e3 / steps,
        "device_busy_ms_per_step": sum(b - a for a, b in _union(
            [e.time_range.start, e.time_range.end] for e in cuda)) / 1e3 / steps,
        "ms_per_step_by_double_backward": dict(under),
        "match": list(match),
        "matched_ms_per_step": dict(by_kind),
        "matched_by_range": [[k, w, ms] for (k, w), ms in sorted(matched.items(),
                                                                   key=lambda x: -x[1])],
        "double_backward_ops_per_step": doubles / steps,
        "groups": [{"kernel": n, "range": w, "node": node, "chain": chain, "shapes": shapes,
                    "ms_per_step": ms, "launches_per_step": c / steps}
                   for (n, w, node, chain, shapes), (ms, c) in
                   sorted(groups.items(), key=lambda x: -x[1][0])[:top]],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="grid-train-bf16")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--steps", type=int, default=1, help="steps under the profiler")
    p.add_argument("--match", default=",".join(SIMT),
                   help="comma-separated substrings of the kernel names to total")
    p.add_argument("--top", type=int, default=40, help="groups to print")
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
    if cell.traffic["kind"] != "train":
        raise SystemExit(f"{cell.name} is not a training cell")
    subject = Train(cell, args.seed, device)
    subject.stretch(2)
    tracing.read()  # the counters from here on
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with tracing.enabled(device_events=False), torch.profiler.profile(
            activities=acts, record_shapes=True) as prof:
        subject.stretch(args.steps)
        if cuda:
            torch.cuda.synchronize()
    counters = tracing.read()["counters"]
    out = {"workload": cell.name, "seed": args.seed, "steps": args.steps,
           "device": torch.cuda.get_device_name(0) if cuda else "cpu",
           "card": _card() if cuda else None, "torch": torch.__version__,
           "counters_per_step": {k: v / args.steps for k, v in sorted(counters.items())},
           **sites(prof, args.steps, tuple(args.match.split(",")), args.top)}
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
