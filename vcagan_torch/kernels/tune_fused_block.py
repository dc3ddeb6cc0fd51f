"""Time the fused block's tilings on the card, beside the plan's cost model.

    python3 -m vcagan_torch.kernels.tune_fused_block [--top 12] [--n 3600]
        [--dtype fp32 bf16] [--shape H W C ...]

``plan_fused_block`` picks a tiling by a model of clock cycles
(``_block_cost``) that was fitted by hand.  This script shows how good the
pick is: for each of the trunk's shapes (or ``--shape``) and each type it
takes the ``--top`` cheapest candidates by the model, launches the kernel
with each (held to the plain version first, so a tiling that computes
something else raises), and prints the times in the model's order, the
fastest marked.  A line whose time is far from its neighbours' says where
the model is off.  Needs one CUDA card; prints the card's name and power
limit with the times.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess

import torch

from vcagan_torch.kernels import fused_block as fb
from vcagan_torch.runtime import use_full_fp32

TRUNK_SHAPES = ((28, 28, 64), (14, 14, 128), (7, 7, 256), (4, 4, 512))
DTYPES = {"fp32": (torch.float32, 1e-4), "bf16": (torch.bfloat16, 0.05)}  # type, tolerance


def _inputs(n, h, w, c, dtype):
    """Outputs of order 1: weights of variance 1/(9C)."""
    g = torch.Generator(device="cuda").manual_seed(7)
    rand = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    x = rand(n, h, w, c).to(dtype)
    w1, w2 = (rand(3, 3, c, c) / (9 * c) ** 0.5 for _ in range(2))
    return x, w1, 0.1 * rand(c), 0.25 * rand(c), w2, 0.1 * rand(c), 0.25 * rand(c)


def _time_ms(fn, samples=5, calls=4) -> float:
    """Median over ``samples`` of the CUDA-event time of ``calls`` calls."""
    fn()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def tune(n, h, w, c, form, top, card) -> None:
    dtype, tol = DTYPES[form]
    x, w1, b1, a1, w2, b2, a2 = args = _inputs(n, h, w, c, dtype)
    packed = (x, fb.pack_weights(w1, dtype), b1, a1, fb.pack_weights(w2, dtype), b2, a2)
    want = fb.fused_block_reference(*args).float()
    plans = sorted(fb.candidate_plans(n, h, w, c, dtype), key=lambda p: p.cost)[:top]
    rows = []
    for plan in plans:
        got = fb.fused_block_cuda(*packed, plan=plan).float()
        if not torch.allclose(got, want, rtol=tol, atol=tol):
            raise RuntimeError(f"{plan}: max abs err {(got - want).abs().max().item():.3e}")
        rows.append((_time_ms(lambda: fb.fused_block_cuda(*packed, plan=plan)), plan))
    best = min(ms for ms, _ in rows)
    print(f"N={n} {h}x{w}x{c} {form} [{card}]: the planner's pick takes {rows[0][0]:.3f} ms, "
          f"the fastest of the {len(rows)} cheapest by the model {best:.3f} ms")
    for ms, p in rows:
        print(f"  model {p.cost / rows[0][1].cost:5.3f}  {ms:7.3f} ms{' *' if ms == best else '  '} "
              f"rows {p.r} images {p.g} warps_m {p.warps_m} wn {p.wn} ks {p.ks} stages {p.stages} "
              f"smem {p.smem}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=12, help="candidates a shape and type")
    ap.add_argument("--n", type=int, default=3600, help="images (the serving path: 48 x 75)")
    ap.add_argument("--dtype", nargs="+", choices=list(DTYPES), default=list(DTYPES))
    ap.add_argument("--shape", nargs=3, type=int, action="append", metavar=("H", "W", "C"))
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("tune_fused_block needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    use_full_fp32()  # the plain version's convolutions in full fp32
    for h, w, c in opts.shape or TRUNK_SHAPES:
        for form in opts.dtype:
            tune(opts.n, h, w, c, form, opts.top, card)


if __name__ == "__main__":
    main()
