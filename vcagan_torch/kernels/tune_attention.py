"""Time the attention's key splits past 512 keys on the card, beside the model.

    python3 -m vcagan_torch.kernels.tune_attention [--shape B T S ...]
        [--splits 1 2 3 4 ...]

Past ``S_MAX`` keys ``attention_plan`` picks the split count by a model of
microseconds (``LongAttentionPlan.cost_us``: waves of blocks a share of
key blocks long, plus the combine's bytes) among the counts that give at
least one block an SM.  This script shows how good the pick is: for each
shape (the long rows of PERF.md, or ``--shape``; lengths as chip_smoke's
phase 12 has them: 0 and S among them) and each split count it launches
the kernel (held to the plain version first, so a plan that computes
something else raises), times it by CUDA-graph replay and prints the time
beside the model's, the planner's pick and the fastest marked.  Needs one
CUDA card; prints the card's name and power limit with the times.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess

import numpy as np
import torch

from vcagan_torch.kernels import masked_attention as attn
from vcagan_torch.runtime import use_full_fp32

LONG_SHAPES = ((4, 750, 750), (4, 1500, 750), (8, 1026, 513), (2, 1280, 640), (1, 4096, 4096))
TOL = 1e-5  # atol and rtol against the plain version, as chip_smoke's ATTN_TOL


def _inputs(b, t, s, d, seed):
    """q, k, v of N(0, 1); lengths 0 and S, the rest drawn from 1 ... S."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device="cuda")
               for shape in ((b, t, d), (b, s, d), (b, s, d)))
    lengths = [s] if b == 1 else [0, s, *np.random.default_rng(seed).integers(1, s + 1, b - 2)]
    return q, k, v, torch.as_tensor(lengths, dtype=torch.int32, device="cuda")


def _graph_ms(fn, calls=10, samples=10) -> float:
    """Device time of one call: ``calls`` calls in a CUDA graph, replayed
    ``samples`` times between CUDA events; the median over ``calls``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def tune(b, t, s, d, splits, card) -> None:
    q, k, v, lens = _inputs(b, t, s, d, seed=s)
    pick = attn.attention_plan(t, s, d, b)
    want = attn.masked_attention_reference(q, k, v, lens)
    rows = []
    for n in splits or range(1, pick.key_blocks_all + 1):
        plan = attn.LongAttentionPlan(t, s, d, b, n)
        got = attn.masked_attention_cuda(q, k, v, lens, plan=plan)
        if not torch.allclose(got, want, rtol=TOL, atol=TOL):
            raise RuntimeError(f"{plan}: max abs err {(got - want).abs().max().item():.3e}")
        rows.append((_graph_ms(lambda: attn.masked_attention_cuda(q, k, v, lens, plan=plan)),
                     plan))
    best = min(ms for ms, _ in rows)
    print(f"B={b} T={t} S={s} D={d} lengths {lens.tolist()[:4]} [{card}]: the planner picks "
          f"{pick.splits} split(s)")
    for ms, p in rows:
        mark = ("*" if ms == best else " ") + ("<" if p.splits == pick.splits else " ")
        print(f"  splits {p.splits:3d} blocks {p.blocks:5d} model {p.cost_us():8.1f} us  "
              f"{ms:8.4f} ms {mark}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", nargs=3, type=int, action="append", metavar=("B", "T", "S"))
    ap.add_argument("--splits", nargs="+", type=int, help="split counts (default: all)")
    ap.add_argument("--d", type=int, default=256)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("tune_attention needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    use_full_fp32()  # the plain version's products in full fp32
    for b, t, s in opts.shape or LONG_SHAPES:
        tune(b, t, s, opts.d, opts.splits, card)


if __name__ == "__main__":
    main()
