"""Time every plan the attention's planner can choose on the card, beside its model.

    python3 -m vcagan_torch.kernels.tune_attention [--short] [--shape B T S ...]
        [--d D]

``attention_plan`` picks an instance and its key splits by a model of
microseconds.  This script shows how good the pick is: for each shape (the
five rows past 512 keys of PERF.md, or with ``--short`` the rows up to 512
keys that the serving, training and evaluation paths and the width checks
run, or ``--shape``) it launches every plan of ``candidate_plans`` (held to
the plain version first, so a plan that computes something else raises),
times each by CUDA-graph replay and prints the time beside the model's,
the planner's pick (``<``) and the fastest (``*``) marked, with the plain
version, sdpa and the bound beside.  Lengths: the rows' own (full, or
drawn from the range their batches have), else 0 and S among them.  Needs
one CUDA card; prints the card's name and power limit with the times.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from vcagan_torch.kernels import masked_attention as attn
from vcagan_torch.runtime import use_full_fp32

LONG_SHAPES = ((4, 750, 750), (4, 1500, 750), (8, 1026, 513), (2, 1280, 640), (1, 4096, 4096))
# Up to 512 keys: (name, B, T, S, D, lengths), lengths None for all S, or a
# (lowest, highest) range the batch's lengths are drawn from (the ranges of
# chip_smoke's LRS batches), or a list.
SHORT_SHAPES = (
    ("serving att1", 48, 75, 75, 256, None),
    ("serving att2", 48, 150, 75, 256, None),
    ("GRID train att1", 88, 40, 40, 256, None),
    ("GRID train att2", 88, 80, 40, 256, None),
    ("LRS2 train att1", 16, 50, 50, 256, (32, 50)),
    ("LRS2 train att2", 16, 100, 50, 256, (32, 50)),
    ("LRS2 val att1", 16, 120, 120, 256, (30, 87)),
    ("LRS2 val att2", 16, 240, 120, 256, (30, 87)),
    ("GRID test att1", 100, 75, 75, 256, None),
    ("GRID test att2", 100, 150, 75, 256, None),
    ("LRS test att1", 8, 160, 160, 256, (122, 152)),
    ("LRS test att2", 8, 320, 160, 256, (122, 152)),
    ("LRS max", 4, 640, 160, 256, None),
    *((f"D={d} S={s}", 3, 75, s, d, [0, s, s // 2 + 1]) for d in (4, 12, 100) for s in (21, 75)),
    ("B=70000", 70_000, 2, 3, 8, (-1, 4)),
)
TOL = 1e-5  # atol and rtol against the plain version, as chip_smoke's ATTN_TOL
HBM_BYTES_PER_S = 3.35e12
ATTN_FLOP_PER_S = 495e12 / 3  # 3xTF32 on the TF32 tensor cores


def _inputs(b, t, s, d, lengths, seed):
    """q, k, v of N(0, 1) and the lengths (see SHORT_SHAPES); for the long
    shapes 0 and S among them, the rest drawn from 1 ... S."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device="cuda")
               for shape in ((b, t, d), (b, s, d), (b, s, d)))
    rng = np.random.default_rng(seed)
    if lengths is None:
        lengths = [s] * b
    elif isinstance(lengths, tuple):
        lengths = rng.integers(lengths[0], lengths[1] + 1, b).tolist()
    elif lengths == "long":
        lengths = [s] if b == 1 else [0, s, *rng.integers(1, s + 1, b - 2)]
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


def _bound_ms(b, t, s, d, lengths) -> float:
    """max(bytes / HBM rate, flops / 3xTF32 rate) of the keys below each
    length: q, lengths and out in full, k and v in their walked rows."""
    valid = sum(min(max(int(n), 0), s) for n in lengths)
    nbytes, flops = 4 * (2 * b * t * d + 2 * valid * d + b), 4 * t * valid * d
    return max(nbytes / HBM_BYTES_PER_S, flops / ATTN_FLOP_PER_S) * 1e3


def tune(name, b, t, s, d, lengths, card) -> list[tuple[float, object]]:
    """Times every candidate plan of one shape; prints and returns them."""
    q, k, v, lens = _inputs(b, t, s, d, lengths, seed=s + t)
    pick = attn.attention_plan(t, s, d, b)
    want = attn.masked_attention_reference(q, k, v, lens)
    rows = []
    for plan in attn.candidate_plans(t, s, d, b):
        got = attn.masked_attention_cuda(q, k, v, lens, plan=plan)
        if not torch.allclose(got, want, rtol=TOL, atol=TOL):
            raise RuntimeError(f"{plan}: max abs err {(got - want).abs().max().item():.3e}")
        rows.append((_graph_ms(lambda: attn.masked_attention_cuda(q, k, v, lens, plan=plan)),
                     plan))
    plain = _graph_ms(lambda: attn.masked_attention_reference(q, k, v, lens))
    mask = torch.arange(s, device="cuda")[None, :] < lens[:, None].long()
    sdpa = _graph_ms(lambda: F.scaled_dot_product_attention(
        q[:, None], k[:, None], v[:, None], attn_mask=mask[:, None, None, :])[:, 0])
    best = min(ms for ms, _ in rows)
    ls = lens.tolist()
    print(f"{name}: B={b} T={t} S={s} D={d} lengths {min(ls)}-{max(ls)} [{card}]: plain "
          f"{plain:.4f} ms, sdpa {sdpa:.4f} ms, bound {_bound_ms(b, t, s, d, ls):.4f} ms; "
          f"the planner picks {pick.describe()}")
    for ms, p in rows:
        mark = ("*" if ms == best else " ") + ("<" if p == pick else " ")
        print(f"  {p.describe():90s} model {p.cost_us():8.1f} us  {ms:8.4f} ms {mark}")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--short", action="store_true", help="the rows up to 512 keys")
    ap.add_argument("--shape", nargs=3, type=int, action="append", metavar=("B", "T", "S"))
    ap.add_argument("--d", type=int, default=256)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("tune_attention needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    use_full_fp32()  # the plain version's products in full fp32
    if opts.shape:
        shapes = [(f"{b}x{t}x{s}", b, t, s, opts.d, "long") for b, t, s in opts.shape]
    elif opts.short:
        shapes = SHORT_SHAPES
    else:
        shapes = [(f"{b}x{t}x{s}", b, t, s, opts.d, "long") for b, t, s in LONG_SHAPES]
    for shape in shapes:
        tune(*shape, card)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
