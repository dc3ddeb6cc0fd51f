"""Serving traffic: batches of lip clips through the synthesizer, a closed
loop with ``depth`` batches dispatched ahead.

The traffic file gives ``batch`` clips a batch, ``image`` pixels a side,
the clip ``lengths`` (``{"fixed": T}``, or ``{"lognormal": {"median",
"sigma", "min", "max"}}``), the ``buckets`` a clip's frames are padded to
(the batch takes the first bucket that holds it, in the order clips
arrive), ``depth`` and ``check_per_shape``, the batches of each shape kept
for the comparison.  Lengths come in blocks of ``block`` clips that hold
the same lengths (the distribution's quantiles) in an order drawn from the
seed, so every seed serves the same mix.  A batch's video, decoder noise
and initial phases are drawn on the card from the seed and its index.

The window: dispatch a batch (its waveform copied to a pinned host buffer
made at set-up), then wait for the oldest one's waveform on the host and
record its latency from its dispatch; stop dispatching when ``seconds``
have passed and wait for what is in flight.  Throughput counts the true
(unpadded) mel frames of every batch completed, over the whole window.

Correctness: a reservoir drawn from the seed keeps ``check_per_shape``
completed batches of each shape with everything the call returned; after
the window the plain float32 reference runs on the same inputs and draws
and the worst clip's relative L2 of each output is compared with the
cell's limits (over each clip's true frames; the waveform against the
reference vocoder run on the program's spectrogram, ``compare``).
"""

from __future__ import annotations

import collections
import gc
import math
import os
import random
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import result, spec, trace, work
from benchmark.harness.traffic import batch_seed, block_lengths, model_config
from benchmark.reference import dsp, model, serve as ref_serve, weights

MEL_PER_FRAME = 4


class Traffic:
    """The batches of a run: ``batch(i)`` -> (frames a clip, true lengths)."""

    def __init__(self, t: dict, seed: int):
        self.t = t
        self.size = t["batch"]
        self.buckets = sorted(t["buckets"])
        self.rng = np.random.default_rng([seed % 2 ** 63, 1])
        self.batches: List[tuple] = []
        self.queues: Dict[int, List[int]] = collections.defaultdict(list)
        self.lengths = block_lengths(t["lengths"], t.get("block", self.size))

    def bucket(self, n: int) -> int:
        return next(b for b in self.buckets if n <= b)

    def batch(self, i: int) -> tuple:
        while len(self.batches) <= i:
            for n in self.rng.permutation(self.lengths):
                queue = self.queues[self.bucket(int(n))]
                queue.append(int(n))
                if len(queue) == self.size:
                    self.batches.append((self.bucket(int(n)), tuple(queue)))
                    queue.clear()
        return self.batches[i]

    def inputs(self, seed: int, i: int, device, image: int, noise_dim: int, bins: int):
        """video (B, T, H, W, 1) zero past each length, lengths (B,) int32,
        noise (B, bins, T, noise_dim), initial phases (B, 4T, 321)."""
        frames, lengths = self.batch(i)
        g = torch.Generator(device).manual_seed(batch_seed(seed, i))
        b = len(lengths)
        lens = torch.tensor(lengths, dtype=torch.int32).to(device, non_blocking=True)
        video = torch.randn((b, frames, image, image, 1), generator=g, device=device)
        video *= (torch.arange(frames, device=device)[None, :] < lens[:, None])[:, :, None, None, None]
        noise = torch.randn((b, bins, frames, noise_dim), generator=g, device=device)
        phase = (2.0 * torch.rand((b, MEL_PER_FRAME * frames, 321), generator=g, device=device)
                 - 1.0) * math.pi
        return video, lens, noise, phase


class Program:
    """The system under test: the port's ``Synthesizer`` with the cell's
    serving variant, the trained weights loaded."""

    def __init__(self, config: dict, states, device):
        from vcagan_torch.configs import ModelConfig
        from vcagan_torch.serve import Synthesizer

        s = config["serve"]
        gl = None if s["gl_dtype"] is None else getattr(torch, s["gl_dtype"])
        self.synth = Synthesizer(model_config(ModelConfig, config), device=device,
                                 fold_bn=s["fold_bn"], fused_blocks=s["fused_blocks"],
                                 gl_dtype=gl).load_state_dicts(states)

    def __call__(self, video, lengths, noise, phase):
        return self.synth(video, lengths, noise=noise, init_phase=phase)

    def instrument(self, spans: trace.Spans, counters: dict) -> None:
        """Spans around the visual front, the decoder, the vocoder, each fused
        block and each attention call, with the least time of the latter two
        at the shapes they are called with."""
        synth = self.synth
        spans.around(synth.v_front, "v_front")
        spans.around(synth.gen, "decoder")
        synth.pipe.inverse_spec = spans.wrap(synth.pipe.inverse_spec, "vocoder")
        for block in synth.v_front.modules():
            if getattr(block, "fused", False) and hasattr(block, "w1_packed"):
                spans.around(block, "fused_block")
                block.register_forward_pre_hook(
                    lambda m, args: counters.__setitem__(
                        "fused_block.least_s", counters.get("fused_block.least_s", 0.0)
                        + work.fused_block_least_s(args[0].shape[0], *args[0].shape[2:4],
                                                   args[0].shape[1], m.dtype)))
        trace.wrap_attention(spans, counters)

    def free(self) -> None:
        del self.synth


class Control:
    """The plain reference in fp8, put in the program's place."""

    def __init__(self, config: dict, states, device):
        self.mods = reference_modules(config, states, device, model.Quant("fp8"))

    def __call__(self, video, lengths, noise, phase):
        return ref_serve.forward(self.mods, video, lengths.long(), noise, phase)

    def instrument(self, spans, counters) -> None:
        pass

    def free(self) -> None:
        del self.mods


def reference_modules(config: dict, states, device, quant=None):
    return model.load(model.GENERATOR_SIDE, model.Widths.of(config["model"]), states, device,
                      quant, training=False)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.to(b.device, torch.float64), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))


def compare(got: dict, want: dict, vocoded: torch.Tensor, lengths) -> Dict[str, float]:
    """The worst clip's relative L2 of each output against the reference's,
    over its true frames.  The waveform is judged against ``vocoded``, the
    reference vocoder's waveform from the program's own spectrogram (whose
    agreement ``spec_rel`` judges), by STFT magnitudes: 60 Griffin-Lim rounds
    carry any gap in the spectrogram into the phases, so the reference's own
    waveform would judge the spectrogram twice."""
    worst = collections.defaultdict(float)
    for j, n in enumerate(lengths):
        m = MEL_PER_FRAME * n
        samples = dsp.HOP * (m - 1)
        values = {
            "phon_rel": rel(got["phon"][j, :n], want["phon"][j, :n]),
            "sent_rel": rel(got["sent"][j, :n], want["sent"][j, :n]),
            "mel_rel": max(rel(got[k][j][:, :n * s], want[k][j][:, :n * s])
                           for k, s in (("mel1", 1), ("mel2", 2), ("mel3", 4))),
            "spec_rel": rel(got["spec"][j, :m], want["spec"][j, :m]),
            "wav_rel": rel(dsp.stft(got["wav"][j:j + 1, :samples].float().to(vocoded.device)).abs(),
                           dsp.stft(vocoded[j:j + 1, :samples]).abs()),
        }
        for name, value in values.items():
            worst[name] = max(worst[name], value)
    return dict(worst)


class ServeRun:
    def __init__(self, cell, device, control: bool = False, states=None):
        self.cell, self.device = cell, device
        self.t = cell.traffic
        model_cfg = cell.config["model"]
        self.widths = model.Widths.of(model_cfg)
        self.states = states or weights.serving_states(
            os.path.join(spec.ROOT, cell.config["serve"]["weights"]))
        self.system = (Control if control else Program)(cell.config, self.states, device)

    def inputs(self, traffic, seed, i):
        return traffic.inputs(seed, i, self.device, self.t["image"], self.widths.noise_dim,
                              self.widths.mel_base_bins)

    def warm_up(self, seed: int) -> None:
        """Two calls at each bucket the cell serves, each with a sync."""
        for bucket in self.t["buckets"]:
            traffic = Traffic(dict(self.t, lengths={"fixed": bucket}), seed)
            for i in range(2):
                out = self.system(*self.inputs(traffic, seed, i))
                float(out["wav"].abs().sum())

    def window(self, seed: int, seconds: float, traced: bool) -> dict:
        """The measured loop.  A traced run splits it in three stretches:
        the first half of the window with nothing added (``clean``: the
        batches completed there and their time, which ``serve_mfu`` reads),
        then ``trace_batches`` batches under the profiler with no spans, then
        to the end the spans (hooks, events, the attention wrapped)."""
        cuda = self.device.type == "cuda"
        traffic = Traffic(self.t, seed)
        depth = self.t["depth"]
        spans = trace.Spans(self.device, enabled=traced)
        counters: dict = {}
        most = self.t["batch"] * dsp.HOP * (MEL_PER_FRAME * max(self.t["buckets"]) - 1)
        slots = [torch.empty(most, pin_memory=cuda) for _ in range(depth)]
        picker = random.Random(batch_seed(seed, 2 ** 32))
        kept: Dict[int, list] = collections.defaultdict(list)
        seen: Dict[int, int] = collections.defaultdict(int)
        profile = trace.DeviceTrace() if traced and cuda else None
        stage = "clean" if traced else "plain"
        clean_until = profiled_until = None
        inflight = collections.deque()
        latencies, done_at, frames, done, i = [], [], 0, 0, 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            while len(inflight) < depth and time.perf_counter() < deadline:
                if stage == "clean" and time.perf_counter() >= t0 + seconds / 2:
                    clean_until, stage = i, "profile"
                    if profile is not None:
                        profile.start()
                        profiled_until = i + self.t["trace_batches"]
                if stage == "profile" and (profile is None or not profile.running):
                    self.system.instrument(spans, counters)
                    stage = "spans"
                t_disp = time.perf_counter()
                with torch.profiler.record_function("bench.dispatch"):
                    out = self.system(*self.inputs(traffic, seed, i))
                    wav = out["wav"]
                    host = slots[i % depth][:wav.numel()].view(wav.shape)
                    host.copy_(wav, non_blocking=True)
                    ev = spans.event()
                inflight.append((i, t_disp, ev, out, host))
                i += 1
            if not inflight:
                break
            j, t_disp, ev, out, host = inflight.popleft()
            with torch.profiler.record_function("bench.wait"):
                if cuda:
                    ev.synchronize()
            done_at.append(time.perf_counter())
            latencies.append(done_at[-1] - t_disp)
            if profile is not None and j + 1 == profiled_until:
                profile.stop()
            frames_b, lengths = traffic.batch(j)
            frames += MEL_PER_FRAME * sum(lengths)
            done += 1
            seen[frames_b] += 1
            slot = kept[frames_b]
            k = self.t["check_per_shape"]
            if len(slot) < k or picker.random() < k / seen[frames_b]:
                out = dict(out, wav=host.clone())
                if len(slot) < k:
                    slot.append((j, out))
                else:
                    slot[picker.randrange(k)] = (j, out)
        window_s = time.perf_counter() - t0
        if profile is not None:
            counters["trace"] = profile.summary()
        if clean_until is not None and clean_until >= 3:
            # batches 1 .. clean_until - 2: each completed before the stretch
            # after it began (the profiler's start waits for the device)
            counters["clean"] = (1, clean_until - 1, done_at[clean_until - 2] - done_at[0])
        shapes = collections.Counter(traffic.batch(j)[0] for j in range(done))
        return dict(window_s=window_s, latencies=latencies, frames=frames, done=done,
                    clips=done * self.t["batch"], kept=kept, shapes=shapes, spans=spans,
                    counters=counters, traffic=traffic)

    def check(self, seed: int, w: dict) -> Dict[str, float]:
        """Run the plain float32 reference on the kept batches' inputs and
        compare."""
        mods = reference_modules(self.cell.config, self.states, self.device)
        worst: Dict[str, float] = {}
        for shape, items in sorted(w["kept"].items()):
            for j, got in items:
                video, lens, noise, phase = self.inputs(w["traffic"], seed, j)
                want = ref_serve.forward(mods, video, lens.long(), noise, phase)
                vocoded = dsp.vocode(got["spec"].float(), phase)
                for name, value in compare(got, want, vocoded, w["traffic"].batch(j)[1]).items():
                    worst[name] = max(worst.get(name, 0.0), value)
                del want
        return worst

    def layer_data(self, w: dict) -> dict:
        """The spans and counters the per-layer readers read."""
        counters = dict(w["counters"])
        counters["attention.least_s"] = work.attention_calls_least_s(
            counters.pop("attention.calls", []))
        clean = counters.pop("clean", None)
        if clean is not None:
            first, end, seconds = clean
            shapes = collections.Counter(w["traffic"].batch(j)[0] for j in range(first, end))
            counters["clean_s"] = seconds
            counters["clean_flops"] = sum(n * self.batch_flops(f) for f, n in shapes.items())
        return {"spans": w["spans"].ms(), "counters": counters, "trace": counters.pop("trace", None)}

    def batch_flops(self, frames: int) -> float:
        """One batch's model FLOPs at ``frames``: the reference's products
        and convolutions counted on meta tensors, and Griffin-Lim's FFT
        form."""
        b, img = self.t["batch"], self.t["image"]
        mods = model.build(model.GENERATOR_SIDE, self.widths)
        video = torch.empty((b, frames, img, img, 1), device="meta")
        lens = torch.empty((b,), dtype=torch.long, device="meta")
        noise = torch.empty((b, self.widths.mel_base_bins, frames, self.widths.noise_dim),
                            device="meta")

        def forward():
            phon, sent = mods["v_front"](video)
            mels = mods["gen"](sent, phon, lens, noise)
            mods["post"](mels[2])

        return work.counted_flops(forward) + work.griffin_lim_fft_flops(b, MEL_PER_FRAME * frames)


def run(cell, seed: int, seconds: float, traced: bool, device, started: float) -> result.Outcome:
    """One run of a serving cell: set-up, the window, then the comparison."""
    if device.type == "cuda":
        model.plain_numerics()
    r = ServeRun(cell, device)
    r.warm_up(seed)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - started
    w = r.window(seed, seconds, traced)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    r.system.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    data = r.layer_data(w) if traced else {}
    if traced:
        data["counters"]["memory_peak_bytes"] = peak
    values = r.check(seed, w)
    lat = sorted(w["latencies"])
    e2e = {
        "setup_s": setup_s,
        "serve_mel_frames_per_s": w["frames"] / w["window_s"],
        "serve_batch_p95_ms": 1e3 * statistics.quantiles(lat, n=100, method="inclusive")[94]
        if len(lat) > 1 else 1e3 * lat[0],
    }
    return result.Outcome(e2e=e2e, data=data, checks=result.checks_against(values, cell.limits),
                          attempted=w["clips"], failed=0, memory_peak_bytes=peak, device={})
