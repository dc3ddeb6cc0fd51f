#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``vcagan_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. print the card's name and power limit (nvidia-smi); require CUDA;
  2. build the kernel from ``vcagan_torch/csrc`` and print the build time
     and ptxas report;
  3. hold each kernel to its plain PyTorch version on the card at the
     serving path's shapes and at edge cases; time kernel, plain version
     and, as a yardstick only, one PyTorch library call;
  4. run the serving path (trained weights from data/soak_serving_q8.npz,
     B=2, T=75, 112x112) on the card and on the CPU with the same noise and
     Griffin-Lim phase, and compare;
  5. serve B=48 x 75 frames at full width, fp32, 2 warm-ups then 8 batches
     with one sync; count the kernel launches of that run; then time the
     stages of one more forward with CUDA events;
then print the per-kernel JSON line and, last, the device JSON line.
Needs one card; JAX is not used.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from vcagan_torch.io.weights import load_serving_npz  # noqa: E402
from vcagan_torch.kernels import _build  # noqa: E402
from vcagan_torch.kernels import masked_attention as attn  # noqa: E402
from vcagan_torch.runtime import use_full_fp32  # noqa: E402
from vcagan_torch.serve import Synthesizer  # noqa: E402

SERVING_NPZ = os.path.join(ROOT, "data", "soak_serving_q8.npz")
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# fp32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
ATTN_TOL = 1e-5  # atol and rtol: fp32 on both sides, D=256-term sums
PATH_TOL = 1e-3  # atol and rtol for phon/sent/mel3/spec, card vs CPU
WAV_REL_L2 = 1e-2  # waveform after 60 Griffin-Lim rounds, card vs CPU


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, samples: int = 20, calls: int = 20, warmup: int = 3) -> float:
    """Device time of one call: median over ``samples`` of the CUDA-event
    time of ``calls`` back-to-back calls, divided by ``calls`` (so the host's
    per-call work overlaps the queued launches instead of being timed)."""
    for _ in range(warmup):
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


def attention_inputs(b, t, s, d, lengths, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device="cuda")
               for shape in ((b, t, d), (b, s, d), (b, s, d)))
    return q, k, v, torch.as_tensor(lengths, dtype=torch.int32, device="cuda")


def attention_work(b, t, s, d):
    """(bytes, flops) the function needs: q,k,v,lengths read once, out
    written once; two products of 2*B*T*S*D flops each (the B*T*S softmax
    exponentials are not counted)."""
    return 4 * (2 * b * t * d + 2 * b * s * d + b), 4 * b * t * s * d


def key_mask(k, lengths):
    return torch.arange(k.shape[1], device=k.device)[None, :] < lengths[:, None].long()


def sdpa(q, k, v, mask):
    return F.scaled_dot_product_attention(
        q[:, None], k[:, None], v[:, None], attn_mask=mask[:, None, None, :]
    )[:, 0]


def phase_kernel_vs_plain():
    """Returns the per-forward totals at the serving shapes."""
    rng = np.random.default_rng(0)
    cases = [
        ("att1 path", 48, 75, 75, 256, rng.integers(1, 76, 48)),
        ("att2 path", 48, 150, 75, 256, rng.integers(1, 76, 48)),
        ("LRS max", 4, 640, 160, 256, [160, 100, 1, 37]),
        ("ragged", 3, 77, 21, 256, [1, 2, 3]),
        ("edges", 4, 33, 21, 256, [0, 7, 21, 40]),  # 0, < S, = S, > S
    ]
    worst = 0.0
    for i, (name, b, t, s, d, lengths) in enumerate(cases):
        q, k, v, lens = attention_inputs(b, t, s, d, lengths, seed=i)
        got = attn.masked_attention_cuda(q, k, v, lens)
        torch.cuda.synchronize()
        want = attn.masked_attention_reference(q, k, v, lens)
        err = (got - want).abs().max().item()
        # The plain version can agree bit for bit (same FMA orders), so the
        # kernel is also held to a float64 evaluation of the same function.
        want64 = attn.masked_attention_reference(q.double(), k.double(), v.double(), lens)
        err64 = (got.double() - want64).abs().max().item()
        worst = max(worst, err)
        check(torch.isfinite(got).all().item(), f"{name}: non-finite kernel output")
        check(torch.allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL),
              f"{name} {b, t, s, d}: kernel vs plain max abs err {err:.3e}")
        check(err64 < ATTN_TOL, f"{name} {b, t, s, d}: kernel vs float64 max abs err {err64:.3e}")
        print(f"attention {name:10s} B={b} T={t} S={s} D={d}: max_abs_err {err:.3e} "
              f"(vs float64 {err64:.3e}) ok")

    # Times at the serving path's inputs: full lengths (bench-style clips of
    # 75 frames), so no key is masked and the work is the whole product.
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, flops=0)
    for name, b, t, s, d in (("att1", 48, 75, 75, 256), ("att2", 48, 150, 75, 256)):
        q, k, v, lens = attention_inputs(b, t, s, d, [s] * b, seed=7)
        ms = time_ms(lambda: attn.masked_attention_cuda(q, k, v, lens))
        plain = time_ms(lambda: attn.masked_attention_reference(q, k, v, lens))
        mask = key_mask(k, lens)
        lib = time_ms(lambda: sdpa(q, k, v, mask))
        nbytes, flops = attention_work(b, t, s, d)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3
        print(f"attention {name} time B={b} T={t} S={s} D={d}: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bound:.4f} ms "
              f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bytes", nbytes), ("flops", flops)):
            totals[key] += val
    return totals, worst


def phase_path_card_vs_cpu(states):
    b, t = 2, 75
    rng = np.random.default_rng(1)
    video = rng.standard_normal((b, t, 112, 112, 1)).astype(np.float32)
    lengths = np.asarray([t, 60], np.int32)
    noise = rng.standard_normal((b, 20, t, 128)).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (b, 4 * t, 321)).astype(np.float32)

    on_card = Synthesizer(device="cuda").load_state_dicts(states)
    before = attn.LAUNCHES
    got = on_card(video, lengths, noise=noise, init_phase=phase)
    torch.cuda.synchronize()
    check(attn.LAUNCHES - before == 2, f"{attn.LAUNCHES - before} attention launches, not 2")
    want = Synthesizer(device="cpu").load_state_dicts(states)(
        video, lengths, noise=noise, init_phase=phase
    )
    check(got["wav"].shape == (b, 160 * (4 * t - 1)), f"wav shape {tuple(got['wav'].shape)}")
    for name in ("phon", "sent", "mel3", "spec"):
        g, w = got[name].cpu(), want[name]
        check(torch.isfinite(g).all().item(), f"{name}: non-finite on the card")
        err = (g - w).abs().max().item()
        print(f"path {name}: card vs CPU max abs err {err:.3e} (max |CPU| "
              f"{w.abs().max().item():.3e})")
        check(torch.allclose(g, w, rtol=PATH_TOL, atol=PATH_TOL), f"{name} differs: {err:.3e}")
    g, w = got["wav"].cpu(), want["wav"]
    rel = (torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)).item()
    print(f"path wav: card vs CPU relative L2 {rel:.3e}")
    check(rel < WAV_REL_L2, f"wav relative L2 {rel:.3e}")
    return on_card


def phase_serve(synth, card):
    b, t, batches = 48, 75, 8
    video = torch.from_numpy(
        np.random.default_rng(2).standard_normal((b, t, 112, 112, 1)).astype(np.float32)
    ).cuda()
    lengths = torch.full((b,), t, dtype=torch.int32, device="cuda")
    for _ in range(2):
        synth(video, lengths)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    attn.LAUNCHES = 0
    t0 = time.perf_counter()
    outs = [synth(video, lengths) for _ in range(batches)]
    sums = torch.stack([o["wav"].abs().sum() for o in outs]).cpu()  # the one sync
    elapsed = time.perf_counter() - t0
    launches = attn.LAUNCHES

    wav = outs[-1]["wav"]
    check(wav.shape == (b, 160 * (4 * t - 1)), f"wav shape {tuple(wav.shape)}")
    check(bool(torch.isfinite(sums).all()) and bool(torch.isfinite(wav).all()), "non-finite wav")
    check(launches == 2 * batches, f"{launches} attention launches in {batches} forwards")
    mel_fps = batches * b * 4 * t / elapsed
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"serve B={b} T={t} fp32: {mel_fps:.1f} mel-frames/s ({elapsed:.3f} s for "
          f"{batches} batches), peak {peak_gb:.2f} GB, {launches / batches:g} attention "
          f"launches per forward [{card}]")
    stage_breakdown(synth, video, lengths, card)
    return launches


@torch.inference_mode()
def stage_breakdown(synth, video, lengths, card):
    """Device time of each stage of one forward (the composition of
    ``Synthesizer.__call__``), from CUDA events between the stages."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    events[0].record()
    phon, sent = synth.v_front(video)
    events[1].record()
    mels = synth.gen(sent, phon, lengths, generator=synth.generator)
    events[2].record()
    spec = synth.post(mels[2]).transpose(1, 2)
    events[3].record()
    synth.pipe.inverse_spec(spec, generator=synth.generator)
    events[4].record()
    torch.cuda.synchronize()
    names = ("visual_front", "decoder", "postnet", "griffin_lim+deemphasis")
    ms = [events[i].elapsed_time(events[i + 1]) for i in range(4)]
    total = sum(ms)
    print(f"stages of one B={video.shape[0]} forward [{card}]: " + ", ".join(
        f"{n} {m:.2f} ms ({100 * m / total:.1f}%)" for n, m in zip(names, ms)
    ) + f"; total {total:.2f} ms")


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    check(torch.cuda.is_available(), "CUDA is not available")
    use_full_fp32()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.load("masked_attention")
    print(f"build: {time.perf_counter() - t0:.1f} s for masked_attention")
    with open(_build.log_path("masked_attention")) as f:
        for line in f:
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  masked_attention: {line.strip()}")

    totals, worst = phase_kernel_vs_plain()
    states = load_serving_npz(SERVING_NPZ)
    synth = phase_path_card_vs_cpu(states)
    launches = phase_serve(synth, card)

    kernel = {
        "name": "masked_cross_attention",
        "route": "cuda",
        "source": "vcagan_torch/csrc/masked_attention.cu",
        "replaces": "vcagan/kernels/masked_attention.py:85",
        "launches": launches,
        "max_abs_err": worst,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": max(totals["bytes"] / HBM_BYTES_PER_S,
                        totals["flops"] / FP32_FLOP_PER_S) * 1e3,
        "bound_by": ("bytes" if totals["bytes"] / HBM_BYTES_PER_S
                     >= totals["flops"] / FP32_FLOP_PER_S else "operations"),
        "library_ms": totals["library_ms"],
    }
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
