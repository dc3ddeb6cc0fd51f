"""Training traffic: the port's device input pipeline and train step over a
pool of raw batches held on the card.

The traffic file gives ``batch`` clips of ``window`` frames, the
``dataset`` whose raw format and pipeline the pool takes ("grid": host-
cropped ``raw_size``^2 grey frames; "lrs": full ``raw_size``^2 grey frames
with a lip centre a frame), the clip ``lengths`` (as the serving traffic's;
a clip shorter than the window is padded and masked), ``pool`` raw batches
made from the seed, ``ahead``, the steps queued on the card beyond the one
whose losses are read (default 1), and ``trace_steps``, the steps of the
profiled stretch of a traced run.  Every raw batch differs: frames uint8
noise, audio a few amplitude-modulated partials with noise, conditioned as
the host does.

Set-up makes the weights of all seven modules from the seed on the card
(``reference.weights.seeded_states``), builds the program's modules on
them, its optimizers and its step, and drives that step through the pool's
first ``CHECKED_STEPS`` batches (the pipeline, then the step, one
generator for both): those steps are also the warm-up.  The window then
goes on with the same objects, reading step N's metrics after step
N+``ahead`` is queued, so that a stall of the host does not drain the card,
until ``seconds`` have passed; then it queues nothing more and waits for
every step sent.  Throughput counts the clips of every step, over the whole
window up to that wait's end.

Correctness: after the window the plain float32 reference takes the same
initial weights, raw batches and generator seed through the same three
steps; compared are each step's two losses, the first step's generated
mels, the first gradient (from each optimizer's first moment after one
step) and the parameters' change after three steps (``compare``).  One
step of the window, drawn from the seed, is compared too: before it the
program's state (parameters, buffers, both optimizers' moments and counts)
and the generator's state are copied on the card, and the reference takes
that step from the copy on the same raw batch (``compare_step``).
"""

from __future__ import annotations

import collections
import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import result, trace, work
from benchmark.harness.traffic import batch_seed, block_lengths, model_config
from benchmark.reference import model, pipeline as ref_pipeline, train as ref_train, weights

CHECKED_STEPS = 3
WINDOW_DRAW = 16  # the window step compared is one of its first this many
ALL = model.GENERATOR_SIDE + model.DISCRIMINATOR_SIDE
B1 = ref_train.B1
LEAF_FLOOR = 1e-3  # leaves whose reference gradient is under this share of the median leaf's


def raw_batch(t: dict, seed: int, index: int, device, lengths: np.ndarray) -> dict:
    """One raw batch in the pipeline's input format, made on ``device``."""
    b, w = t["batch"], t["window"]
    g = torch.Generator(device).manual_seed(batch_seed(seed, index))
    size = t["raw_size"]
    hop, n_fft = 160, 640
    vid_len = torch.as_tensor(np.minimum(lengths, w), dtype=torch.int32).to(device)
    video = torch.randint(0, 256, (b, w, size, size, 1), generator=g, device=device,
                          dtype=torch.uint8)
    video *= (torch.arange(w, device=device)[None] < vid_len[:, None]).to(torch.uint8)[
        :, :, None, None, None]
    n = 4 * w * hop + n_fft
    tt = torch.arange(n, device=device) / 16000.0
    f0 = 100.0 + 300.0 * torch.rand((b, 1), generator=g, device=device)
    wav = 0.02 * torch.randn((b, n), generator=g, device=device)
    for k in (1, 3, 7):
        am = 0.5 + 0.5 * torch.sin(2 * math.pi * (2 + 3 * torch.rand((b, 1), generator=g, device=device)) * tt)
        wav = wav + am * torch.sin(2 * math.pi * k * f0 * tt + 6 * torch.rand((b, 1), generator=g, device=device))
    wav = 0.9 * wav / wav.abs().amax(dim=1, keepdim=True)
    cond = torch.clamp(torch.cat([wav[:, :1], wav[:, 1:] - 0.97 * wav[:, :-1]], dim=1), -1.0, 1.0)
    samples = (vid_len.long() * 4 * hop + n_fft // 2)[:, None]
    cond = cond * (torch.arange(n, device=device)[None] < samples)
    raw = {"video_raw": video, "aud_cond": cond, "vid_len": vid_len,
           "mel_len": 4 * vid_len}
    if t["dataset"] == "lrs":
        wander = torch.randint(-3, 4, (b, w, 2), generator=g, device=device, dtype=torch.int32)
        base = torch.tensor([size // 2, int(size * 0.68)], dtype=torch.int32, device=device)
        raw["centers"] = base + wander
    return raw


def pool(t: dict, seed: int, device) -> List[dict]:
    """``pool`` raw batches; clip lengths as the serving traffic draws them."""
    lengths = block_lengths(t["lengths"], t["pool"] * t["batch"])
    order = np.random.default_rng([seed % 2 ** 63, 2]).permutation(lengths)
    return [raw_batch(t, seed, i, device, order[i * t["batch"]:(i + 1) * t["batch"]])
            for i in range(t["pool"])]


def train_spec(config: dict) -> ref_train.TrainSpec:
    c = config["train"]
    return ref_train.TrainSpec(lr=c["lr"], weight_decay=c["weight_decay"], amsgrad=c["amsgrad"],
                               recon_weight=c["recon_weight"], sync_dis_weight=c["sync_dis_weight"],
                               recon_on_denormalized=c["recon_on_denormalized"])


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack(torch._foreach_norm([tensors[n].float() for n in names])).tolist()
    return dict(zip(names, norms))


def worst_gap(got: Dict[str, float], want: Dict[str, float], leaves) -> float:
    """max over ``leaves`` of |got - want| / max(want, the median leaf's want)."""
    median = float(np.median([want[n] for n in leaves]))
    return max(abs(got[n] - want[n]) / max(want[n], median) for n in leaves)


class Program:
    """The port's modules, optimizers, step and input pipeline."""

    def __init__(self, config: dict, t: dict, states, device, marks=None):
        from vcagan_torch.configs import AudioConfig, DataConfig, ModelConfig, TrainConfig
        from vcagan_torch.data.device_pipeline import make_device_pipeline
        from vcagan_torch.data.lrs import make_lrs_device_pipeline
        from vcagan_torch.nn.discriminator import Discriminator, SyncDiscriminator
        from vcagan_torch.nn.generator import Decoder, Postnet
        from vcagan_torch.nn.visual_front import VisualFront
        from vcagan_torch.train import VCAGANModules, create_train_state, make_train_step

        m = model_config(ModelConfig, config)
        c = config["train"]
        with torch.device("meta"):
            mods = VCAGANModules(VisualFront(m), Decoder(m), Postnet(m, n_mels=80),
                                 Discriminator("1", m), Discriminator("2", m),
                                 Discriminator("3", m), SyncDiscriminator(m))
        for name, module in mods.named():
            module.load_state_dict(states[name], strict=True, assign=True)
        cfg = TrainConfig(batch_size=t["batch"], lr=c["lr"], weight_decay=c["weight_decay"],
                          amsgrad=c["amsgrad"], lr_milestones=tuple(c["lr_milestones"]),
                          lr_gamma=c["lr_gamma"], recon_weight=c["recon_weight"],
                          sync_dis_weight=c["sync_dis_weight"],
                          recon_on_denormalized=c["recon_on_denormalized"],
                          remat=c["remat"], d_phase=c["d_phase"])
        self.modules, self.on_phase = mods, marks
        self.state, g_tx, d_tx = create_train_state(mods, cfg, c["steps_per_epoch"], device)
        self.step_fn = make_train_step(mods, g_tx, d_tx, cfg, remat=cfg.remat,
                                       d_phase=cfg.d_phase, on_phase=marks)
        audio = AudioConfig(f_max=c["f_max"])
        if t["dataset"] == "grid":
            self.pipeline = make_device_pipeline(audio, DataConfig(window_size=t["window"]),
                                                 augment=True, device=device)
        else:
            self.pipeline = make_lrs_device_pipeline(audio, augment=True, device=device)

    def step(self, raw: dict, generator: torch.Generator, spans=None):
        if spans is not None:
            spans.begin("input")
        batch = self.pipeline(raw, generator)
        if spans is not None:
            spans.end("input")
            self.on_phase("step_start")
        self.state, metrics = self.step_fn(self.state, batch, generator)
        return {"dis_loss": metrics["dis_loss"], "gen_loss": metrics["gen_loss"]}

    def modules_by_name(self) -> Dict[str, torch.nn.Module]:
        return dict(self.modules.named())

    def params(self) -> Dict[str, torch.Tensor]:
        return {f"{n}.{k}": p for n, mod in self.modules.named() for k, p in mod.named_parameters()}

    def first_moments(self) -> Dict[str, torch.Tensor]:
        """Each leaf's optimizer first moment, by name."""
        out = {}
        for side, opt in ((model.GENERATOR_SIDE, self.state.g_opt_state),
                          (model.DISCRIMINATOR_SIDE, self.state.d_opt_state)):
            names = [f"{n}.{k}" for n in side for k, _ in getattr(self.modules, n).named_parameters()]
            out.update(zip(names, opt.mu))
        return out

    def optimizers(self) -> dict:
        """Each side's optimizer state: ``count``, ``mu``, ``nu``, ``nu_max``."""
        return {"g": self.state.g_opt_state, "d": self.state.d_opt_state}

    def instrument(self, spans: trace.Spans, counters: dict) -> None:
        trace.wrap_attention(spans, counters)

    def free(self) -> None:
        del self.state, self.step_fn, self.modules, self.pipeline


class Reference:
    """The plain reference's modules, optimizers, step and pipeline;
    ``quant`` fp8 makes it the control."""

    def __init__(self, config: dict, t: dict, states, device, quant=None):
        widths = model.Widths.of(config["model"])
        self.mods = model.load(ALL, widths, states, device, quant, training=True)
        self.step_fn = ref_train.TrainStep(self.mods, train_spec(config), widths)
        self.pipeline = ref_pipeline.PIPELINES[t["dataset"]]

    def step(self, raw, generator, spans=None):
        return self.step_fn(self.pipeline(raw, generator), generator)

    def modules_by_name(self) -> Dict[str, torch.nn.Module]:
        return self.mods

    def params(self) -> Dict[str, torch.Tensor]:
        return {f"{n}.{k}": p for n in ALL for k, p in self.mods[n].named_parameters()}

    def first_moments(self) -> Dict[str, torch.Tensor]:
        out = {}
        for side, opt in ((model.GENERATOR_SIDE, self.step_fn.g_opt),
                          (model.DISCRIMINATOR_SIDE, self.step_fn.d_opt)):
            names = [f"{n}.{k}" for n in side for k, _ in self.mods[n].named_parameters()]
            out.update(zip(names, opt.mu))
        return out

    def optimizers(self) -> dict:
        return {"g": self.step_fn.g_opt, "d": self.step_fn.d_opt}

    def instrument(self, spans, counters) -> None:
        pass

    def free(self) -> None:
        del self.mods, self.step_fn


def checked_steps(system, raws, seed: int, device, initial) -> dict:
    """Drive ``system`` through the first ``CHECKED_STEPS`` raw batches and
    read what the comparison compares: the losses of each step, the first
    gradient's norm by leaf and the norm of each leaf's change."""
    gen = torch.Generator(device).manual_seed(batch_seed(seed, 2 ** 33))
    losses, grads, first, mels = [], None, None, []
    hook = system.modules_by_name()["gen"].register_forward_hook(
        lambda module, args, out: mels.append([m.detach().float().cpu() for m in out]))
    for s in range(CHECKED_STEPS):
        losses.append(system.step(raws[s], gen))
        if s == 0:
            hook.remove()
            moments = system.first_moments()
            grads = {n: v / (1.0 - B1) for n, v in leaf_norms(moments).items()}
            first = {n: v.detach().to("cpu", copy=True) for n, v in moments.items()}
    params = system.params()
    flat = {f"{n}.{k}": v for n, sd in initial.items() for k, v in sd.items()}
    change = leaf_norms({n: p.detach() - flat[n].to(device) for n, p in params.items()})
    return {"losses": [{k: float(v) for k, v in step.items()} for step in losses],
            "grads": grads, "first": first, "change": change, "mels": mels[0], "generator": gen}


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def compare(got: dict, want: dict) -> Dict[str, float]:
    """The worst relative gap of the three steps' losses; the first step's
    generated mels (the three scales' worst relative L2); the worst leaf's
    gap of norms of the first gradient and of the change after three steps;
    and the median leaf's relative L2 distance of the first gradient
    (``grad_diff_rel``: the norms alone do not tell fp8 from bf16, see
    PERF.md).  Leaves whose reference gradient is under ``LEAF_FLOOR`` of
    the median leaf's (nought but for rounding) are left out."""
    floor = LEAF_FLOOR * float(np.median(list(want["grads"].values())))
    leaves = [n for n, g in want["grads"].items() if g >= floor]
    loss = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(got["losses"], want["losses"])
               for k in w)
    diff = sorted(rel(got["first"][n], want["first"][n]) for n in leaves)
    mel = max((rel(g, w) if g.shape == w.shape else math.inf)
              for g, w in zip(got["mels"], want["mels"]))
    return {"loss_rel": loss, "mel_rel": mel,
            "grad_rel": worst_gap(got["grads"], want["grads"], leaves),
            "change_rel": worst_gap(got["change"], want["change"], leaves),
            "grad_diff_rel": diff[len(diff) // 2]}


def worst_leaves(got: dict, want: dict, top: int = 3) -> Dict[str, list]:
    """For each norm compared, the leaves that read the largest gaps, with
    the program's and the reference's norms (for calibration)."""
    floor = LEAF_FLOOR * float(np.median(list(want["grads"].values())))
    leaves = [n for n, g in want["grads"].items() if g >= floor]
    out = {}
    for key in ("grads", "change"):
        median = float(np.median([want[key][n] for n in leaves]))
        gaps = sorted(leaves, key=lambda n: -abs(got[key][n] - want[key][n]) / max(want[key][n], median))
        out[key] = [[n, got[key][n], want[key][n]] for n in gaps[:top]]
    out["median"] = float(np.median([want["grads"][n] for n in leaves]))
    return out


def side_leaves(mods: Dict[str, torch.nn.Module]) -> Dict[str, List[str]]:
    """Each optimizer's leaves by name, in the order its state lists them."""
    return {side: [f"{n}.{k}" for n in names for k, _ in mods[n].named_parameters()]
            for side, names in (("g", model.GENERATOR_SIDE), ("d", model.DISCRIMINATOR_SIDE))}


class StepSnapshot:
    """One step of ``system`` taken from a copy of its state: ``before``
    copies (on the card) every module's parameters and buffers, both
    optimizers' counts and moments, and the generator's state, and keeps
    the step's generated mels; ``after`` copies the parameters and first
    moments the step left and keeps its losses.  Copies are queued on the
    card's stream, so they read the state between the two steps."""

    def __init__(self, raw_index: int):
        self.raw_index = raw_index

    def before(self, system, generator: torch.Generator) -> None:
        mods = system.modules_by_name()
        self.states = {n: {k: v.detach().clone() for k, v in m.state_dict().items()}
                       for n, m in mods.items()}
        leaves = side_leaves(mods)
        self.opts = {}
        for side, st in system.optimizers().items():
            self.opts[side] = {"count": st.count}
            for key in ("mu", "nu", "nu_max"):
                tensors = getattr(st, key)
                self.opts[side][key] = (None if tensors is None else
                                        {n: t.detach().clone() for n, t in zip(leaves[side], tensors)})
        self.generator_state = generator.get_state()
        self.mels = []
        self.hook = mods["gen"].register_forward_hook(
            lambda module, args, out: self.mels.append([m.detach().float().clone() for m in out]))

    def after(self, system, losses: dict) -> None:
        self.hook.remove()
        self.losses = losses
        self.params = {n: p.detach().clone() for n, p in system.params().items()}
        self.moments = {n: m.detach().clone() for n, m in system.first_moments().items()}

    def read(self) -> dict:
        """What ``compare_step`` compares, with the gradient the optimizer
        got, (mu_after - B1 mu_before) / (1 - B1), by leaf."""
        before = {**self.opts["g"]["mu"], **self.opts["d"]["mu"]}
        flat = {f"{n}.{k}": v for n, sd in self.states.items() for k, v in sd.items()}
        grads = {n: (self.moments[n] - B1 * before[n]) / (1.0 - B1) for n in self.moments}
        change = {n: p - flat[n] for n, p in self.params.items()}
        return {"losses": [{k: float(v) for k, v in self.losses.items()}],
                "mels": [m.cpu() for m in self.mels[0]], "grad": grads,
                "grads": leaf_norms(grads), "change": leaf_norms(change)}

    def repeat(self, ref: "Reference", raws, device) -> dict:
        """The same step by ``ref`` from this copy: the reference's modules
        take the copied states, its optimizers the copied counts and moments,
        its generator the copied state."""
        for n, m in ref.modules_by_name().items():
            m.load_state_dict(self.states[n], strict=True)
        leaves = side_leaves(ref.modules_by_name())
        for side, opt in ref.optimizers().items():
            opt.count = self.opts[side]["count"]
            for key in ("mu", "nu", "nu_max"):
                copied = self.opts[side][key]
                if copied is not None:
                    for t, n in zip(getattr(opt, key), leaves[side]):
                        t.copy_(copied[n])
        gen = torch.Generator(device)
        gen.set_state(self.generator_state)
        again = StepSnapshot(self.raw_index)
        again.before(ref, gen)
        again.after(ref, ref.step(raws[self.raw_index], gen))
        again.opts = self.opts
        return again.read()


def compare_step(got: dict, want: dict) -> Dict[str, float]:
    """One window step: its two losses, its generated mels (worst scale),
    the worst leaf's gap of norms of its change, and the median leaf's
    relative L2 distance of its gradient (leaves as ``compare`` takes
    them)."""
    floor = LEAF_FLOOR * float(np.median(list(want["grads"].values())))
    leaves = [n for n, g in want["grads"].items() if g >= floor]
    diff = sorted(rel(got["grad"][n], want["grad"][n]) for n in leaves)
    return {"win_loss_rel": max(abs(got["losses"][0][k] - v) / abs(v)
                                for k, v in want["losses"][0].items()),
            "win_mel_rel": max((rel(g, w) if g.shape == w.shape else math.inf)
                               for g, w in zip(got["mels"], want["mels"])),
            "win_grad_rel": worst_gap(got["grads"], want["grads"], leaves),
            "win_change_rel": worst_gap(got["change"], want["change"], leaves),
            "win_grad_diff_rel": diff[len(diff) // 2]}


def window_step(seed: int) -> int:
    """The window step (counted from 0) that is compared."""
    return 1 + batch_seed(seed, 2 ** 35) % WINDOW_DRAW


class TrainRun:
    def __init__(self, cell, seed: int, device, system: str = "program"):
        self.cell, self.device, self.seed = cell, device, seed
        self.t = cell.traffic
        self.widths = model.Widths.of(cell.config["model"])
        states = weights.seeded_states(ALL, self.widths, batch_seed(seed, 2 ** 34), device)
        self.initial = {n: {k: v.to("cpu", copy=True) for k, v in sd.items()}
                        for n, sd in states.items()}
        self.raws = pool(self.t, seed, device)
        self.marks: Dict[str, object] = {}
        self.spans = trace.Spans(device, enabled=False)
        if system == "program":
            self.system = Program(cell.config, self.t, states, device, self.mark)
        else:
            self.system = Reference(cell.config, self.t, states, device,
                                    model.Quant("fp8") if system == "control" else None)

    def mark(self, name: str) -> None:
        if self.spans.enabled:
            self.marks[name] = self.spans.event()

    def check_steps(self) -> dict:
        out = checked_steps(self.system, self.raws, self.seed, self.device, self.initial)
        self.generator = out.pop("generator")
        return out

    def window(self, seconds: float, traced: bool) -> dict:
        """The measured loop; the window step ``window_step(seed)`` is taken
        between two copies of the state (``StepSnapshot``).  A traced run
        splits the window as the serving kind's does: the first half with
        nothing added (``train_mfu`` reads the steps completed there and
        their time), then ``trace_steps`` steps under the profiler with no
        spans, then to the end the spans (events around the pipeline, the
        step's phase marks, the attention wrapped)."""
        spans = self.spans
        counters: dict = {}
        cuda = self.device.type == "cuda"
        profile = trace.DeviceTrace() if traced and cuda else None
        stage = "clean" if traced else "plain"
        profiled_until = None
        clean_marks = []  # events after step 0 and after the clean stretch's last step
        checked = window_step(self.seed)
        snap = StepSnapshot((CHECKED_STEPS + checked) % len(self.raws))
        ahead = self.t.get("ahead", 1)
        pending, steps = collections.deque(), 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline or steps <= checked:
            if stage == "clean" and time.perf_counter() >= t0 + seconds / 2:
                clean_marks.append((steps - 1, spans.event()))
                stage = "profile"
                if profile is not None:
                    profile.start()
                    profiled_until = steps + self.t["trace_steps"]
            if stage == "profile" and (profile is None or not profile.running):
                self.system.instrument(spans, counters)
                spans.enabled, stage = True, "spans"
            if steps == checked:
                snap.before(self.system, self.generator)
            with torch.profiler.record_function("bench.step"):
                metrics = self.system.step(self.raws[(CHECKED_STEPS + steps) % len(self.raws)],
                                           self.generator, spans if stage == "spans" else None)
            if steps == checked:
                snap.after(self.system, metrics)
            if stage == "spans":
                m = self.marks
                spans.between("gen_forward", m["step_start"], m["gen_forward"])
                spans.between("d_phase", m["gen_forward"], m["d_update"])
                spans.between("g_phase", m["d_update"], m["g_update"])
            if steps == 0 and stage == "clean":
                clean_marks.append((0, spans.event()))
            pending.append(metrics)
            while len(pending) > ahead:
                with torch.profiler.record_function("bench.read_metrics"):
                    float(pending.popleft()["gen_loss"])
            steps += 1
            if profile is not None and steps == profiled_until:
                float(metrics["gen_loss"])
                profile.stop()
        float(metrics["gen_loss"])  # every step sent, the last one in stream order
        window_s = time.perf_counter() - t0
        if profile is not None:
            counters["trace"] = profile.summary()
        if len(clean_marks) == 2 and clean_marks[1][0] >= 1:
            # steps 1 .. the clean stretch's last, between the card's events
            (_, first), (last, end) = clean_marks
            counters["clean"] = (last, first.elapsed_time(end) / 1e3)
        return dict(window_s=window_s, steps=steps, spans=spans, counters=counters, snapshot=snap)

    def layer_data(self, w: dict) -> dict:
        counters = dict(w["counters"])
        counters["attention.least_s"] = work.attention_calls_least_s(
            counters.pop("attention.calls", []))
        clean = counters.pop("clean", None)
        if clean is not None:
            counters["clean_s"] = clean[1]
            counters["clean_flops"] = clean[0] * self.step_flops()
        return {"spans": w["spans"].ms(), "counters": counters, "trace": counters.pop("trace", None)}

    def step_flops(self) -> float:
        """One step's FLOPs: the reference step's products and convolutions,
        forward, backward and R1's double backward, counted on meta tensors."""
        mods = model.build(ALL, self.widths)
        for m in mods.values():
            m.train()
        step = ref_train.TrainStep(mods, train_spec(self.cell.config), self.widths)
        b, w = self.t["batch"], self.t["window"]
        meta = dict(device="meta")
        batch = (torch.empty((b, w, 112, 112, 1), **meta), torch.empty((b, 80, 4 * w), **meta),
                 torch.empty((b, 321, 4 * w), **meta),
                 torch.empty((b,), dtype=torch.long, **meta), torch.empty((b,), dtype=torch.long, **meta))
        return work.counted_flops(lambda: step(batch, None))

    def free(self) -> None:
        self.system.free()
        del self.system
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def check(cell, seed: int, device, got: dict, raws, initial,
          snapshot: StepSnapshot | None = None) -> Dict[str, float]:
    """The float32 reference's three steps from the same start, compared
    with ``got``; with ``snapshot``, also the window step it copied."""
    ref = Reference(cell.config, cell.traffic, initial, device)
    want = checked_steps(ref, raws, seed, device, initial)
    values = compare(got, want)
    if snapshot is not None:
        values.update(compare_step(snapshot.read(), snapshot.repeat(ref, raws, device)))
    ref.free()
    return values


def run(cell, seed: int, seconds: float, traced: bool, device, started: float) -> result.Outcome:
    """One run of a training cell: set-up and the checked steps, the
    window, then the reference's steps and the comparison."""
    if device.type == "cuda":
        model.plain_numerics()
    r = TrainRun(cell, seed, device)
    got = r.check_steps()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - started
    w = r.window(seconds, traced)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    data = r.layer_data(w) if traced else {}
    if traced:
        data["counters"]["memory_peak_bytes"] = peak
    r.free()
    values = check(cell, seed, device, got, r.raws, r.initial, w["snapshot"])
    e2e = {"setup_s": setup_s, "train_clips_per_s": w["steps"] * cell.traffic["batch"] / w["window_s"]}
    return result.Outcome(e2e=e2e, data=data, checks=result.checks_against(values, cell.limits),
                          attempted=w["steps"] * cell.traffic["batch"], failed=0,
                          memory_peak_bytes=peak, device={})
