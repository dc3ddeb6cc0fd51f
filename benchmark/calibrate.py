"""Readings that the limits of a cell's comparison are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--half-seeds 4,5,6] [--seconds 4]

In one process on the card: the program at the cell's size on each of
``--seeds`` (serving: a short window at the cell's load, then the
comparison; training: set-up's three steps and the window's steps up to
the one compared, then the comparison), then the control, the plain
reference computed in fp8 put in the program's place, on each of
``--control-seeds``; for a training cell also the program with every loss
taken over half of each batch (the forward whole, the means and so the
gradients over the first half: ``losses_over_half``) on ``--half-seeds``
and with a step that leaves its state unchanged on ``--unchanged-seeds``;
for a serving cell also the program with Griffin-Lim in bf16 (its own
``gl_dtype`` path, the control of the waveform's number) on
``--vocoder-seeds``; for a training cell the program in float32 on
``--fp32-seeds`` (a second witness of what bf16 alone moves).
Prints one JSON line a reading, then each number's largest program reading
and least control and fault readings.  The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def serve_readings(cell, seeds, control_seeds, vocoder_seeds, seconds, device):
    from benchmark.kinds import serve

    out = []
    for system, chosen in (("program", seeds), ("control", control_seeds),
                           ("vocoder_bf16", vocoder_seeds)):
        if not chosen:
            continue
        run_cell = cell
        if system == "vocoder_bf16":
            run_cell = copy.deepcopy(cell)
            run_cell.config["serve"]["gl_dtype"] = "bfloat16"
        r = serve.ServeRun(run_cell, device, control=system == "control")
        r.warm_up(chosen[0])
        for seed in chosen:
            w = r.window(seed, seconds, False)
            out.append((system, seed, r.check(seed, w)))
            print(json.dumps({"system": system, "seed": seed, "batches": w["done"],
                              "values": out[-1][2]}), flush=True)
        r.system.free()
    return out


@contextlib.contextmanager
def losses_over_half():
    """The program's train step with every loss a mean over the first half
    of the batch: the forward, its shapes and its outputs as they are, the
    losses and so the gradients of half the batch (GAN losses, R1, the sync
    critic's terms, the L1 reconstruction)."""
    import torch

    import vcagan_torch.train.step as step_module
    from vcagan_torch.nn.discriminator import SyncDiscriminator

    names = ("gan_loss", "r1_penalty", "_l1")
    saved = {n: getattr(step_module, n) for n in names}
    sync_forward = SyncDiscriminator.forward

    def half(x):
        return x[:max(1, x.shape[0] // 2)]

    def r1_penalty(logits, x):
        (grad,) = torch.autograd.grad(half(logits).sum(), x, create_graph=True)
        return half(grad).flatten(1).square().sum(1).mean()

    def sync(self, *args, **kwargs):
        out = sync_forward(self, *args, **kwargs)
        h = half(out)
        return torch.cat([h] * (out.shape[0] // h.shape[0]))

    step_module.gan_loss = lambda logits, real: saved["gan_loss"](half(logits), real)
    step_module.r1_penalty = r1_penalty
    step_module._l1 = lambda a, b: saved["_l1"](half(a), half(b))
    SyncDiscriminator.forward = sync
    try:
        yield
    finally:
        for n in names:
            setattr(step_module, n, saved[n])
        SyncDiscriminator.forward = sync_forward


def train_readings(cell, seeds, control_seeds, half_seeds, unchanged_seeds, fp32_seeds, device):
    from vcagan_torch.train.state import Optimizer

    from benchmark.kinds import train

    fp32 = copy.deepcopy(cell)
    fp32.config["model"]["use_bfloat16"] = False
    update = Optimizer.update
    out = []
    for system, chosen in (("program", seeds), ("control", control_seeds), ("half", half_seeds),
                           ("unchanged", unchanged_seeds), ("program_fp32", fp32_seeds)):
        for seed in chosen:
            r = train.TrainRun(fp32 if system == "program_fp32" else cell, seed, device,
                               "control" if system == "control" else "program")
            if system == "unchanged":  # a step that returns its state unchanged
                Optimizer.update = lambda self, grads, state, params: None
            try:
                with losses_over_half() if system == "half" else contextlib.nullcontext():
                    got = r.check_steps()
                    w = r.window(0.0, False)  # no time: the steps up to the compared one
            finally:
                Optimizer.update = update
            r.free()
            ref = train.Reference(cell.config, cell.traffic, r.initial, device)
            want = train.checked_steps(ref, r.raws, seed, device, r.initial)
            values = train.compare(got, want)
            values.update(train.compare_step(w["snapshot"].read(),
                                             w["snapshot"].repeat(ref, r.raws, device)))
            ref.free()
            out.append((system, seed, values))
            print(json.dumps({"system": system, "seed": seed, "values": values,
                              "window_step": train.window_step(seed),
                              "worst": train.worst_leaves(got, want)}), flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_seeds, default=[])
    parser.add_argument("--control-seeds", type=_seeds, default=[])
    parser.add_argument("--half-seeds", type=_seeds, default=[])
    parser.add_argument("--vocoder-seeds", type=_seeds, default=[])
    parser.add_argument("--fp32-seeds", type=_seeds, default=[])
    parser.add_argument("--unchanged-seeds", type=_seeds, default=[])
    parser.add_argument("--seconds", type=float, default=4.0)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import torch

    from benchmark.harness import spec
    from benchmark.reference import model

    bench = spec.load_benchmark(ROOT)
    cell = spec.load_cell(bench, args.workload)
    device = torch.device("cuda", 0)
    model.plain_numerics()
    if cell.traffic["kind"] == "serve":
        out = serve_readings(cell, args.seeds, args.control_seeds, args.vocoder_seeds,
                             args.seconds, device)
    else:
        out = train_readings(cell, args.seeds, args.control_seeds, args.half_seeds,
                             args.unchanged_seeds, args.fp32_seeds, device)
    summary = {}
    for system, _, values in out:
        for name, value in values.items():
            row = summary.setdefault(name, {})
            pick = max if system.startswith("program") else min
            row[system] = value if system not in row else pick(row[system], value)
    print(json.dumps({"cell": cell.name, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
