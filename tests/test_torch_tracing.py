"""The port's in-program tracing (``vcagan_torch.tracing``): spans and
counters at the layer boundaries, on the CPU.

- Off (the default), ``span`` is the one shared no-op context and nothing
  is recorded; counters count either way.
- A serving call (``Synthesizer``, folded + fused, at a small image) emits
  the tree ``serve`` > ``serve.inputs``, ``serve.v_front`` (> the stem,
  the trunk with its fused blocks, the biGRU), ``serve.decoder`` (> two
  ``attention``), ``serve.postnet``, ``serve.vocoder`` (> Griffin-Lim,
  de-emphasis), one call id, each child inside its parent.
- A train step emits ``train.step`` and its seven parts in order, each
  ending where ``on_phase`` is called with its name.
- The kernels' launch counters: the launches of a call computed from the
  attention's and the fused block's plans (chunks, the split pass, key
  splits and the combine), with no card.
- ``Trainer.fit(profile_steps=...)``'s trace names its four loop ranges and
  the step's parts, and tracing is off again after it.
- A profiled stretch's idle gaps go to the innermost program range open
  where each began (``tools/program_spans.py``, on hand-made events).
"""

import time

import numpy as np
import pytest
import torch

from _torch_threads import _one_thread  # noqa: F401  (autouse)
from vcagan_torch import tracing
from vcagan_torch.configs import ModelConfig, TrainConfig, grid_config
from vcagan_torch.kernels import fused_block as fb
from vcagan_torch.kernels import masked_attention as attn
from vcagan_torch.serve import Synthesizer
from vcagan_torch.train import Batch, VCAGANModules, create_train_state, make_train_step
from vcagan_torch.train.loop import Trainer

NARROW = dict(stem_channels=16, gru_hidden=32, noise_dim=16, attention_dim=32,
              attention_inner=160, postnet_channels=32, disc_base_channels=8,
              disc_max_channels=32)
PHASES = ("gen_forward", "d_loss", "d_backward", "d_update", "g_loss", "g_backward",
          "g_update")
SERVE_TREE = {
    "serve": None, "serve.inputs": "serve", "serve.v_front": "serve",
    "v_front.stem": "serve.v_front", "v_front.trunk": "serve.v_front",
    "fused_block": "v_front.trunk", "v_front.gru": "serve.v_front",
    "serve.decoder": "serve", "attention": "serve.decoder", "serve.postnet": "serve",
    "serve.vocoder": "serve", "vocoder.griffin_lim": "serve.vocoder",
    "vocoder.deemphasis": "serve.vocoder",
}


@pytest.fixture(autouse=True)
def _fresh():
    tracing.disable()
    tracing.read()
    yield
    tracing.disable()
    tracing.read()


def test_off_span_is_the_shared_noop_and_records_nothing():
    noop = tracing.span("serve")
    assert tracing.span("train.step") is noop
    with noop as inside:
        assert inside is None
    tracing.count("attention.calls")
    tracing.count("attention.launches", 2)
    assert tracing.counters() == {"attention.calls": 1, "attention.launches": 2}
    out = tracing.read()
    assert out == {"spans": [], "counters": {"attention.calls": 1, "attention.launches": 2}}
    assert tracing.read() == {"spans": [], "counters": {}}  # read clears


def test_on_records_parents_calls_and_host_intervals():
    with tracing.enabled():
        for _ in range(2):
            with tracing.span("a"):
                with tracing.span("a.b"):
                    with tracing.span("a.b.c"):
                        pass
                with tracing.span("a.d"):
                    pass
    assert tracing.span("a") is tracing.span("b")  # as it was
    spans = tracing.read()["spans"]
    assert [s.name for s in spans] == ["a", "a.b", "a.b.c", "a.d"] * 2
    assert [s.parent for s in spans] == [None, 0, 1, 0, None, 4, 5, 4]
    assert [s.call for s in spans[:4]] == [spans[0].call] * 4
    assert [s.call for s in spans[4:]] == [spans[4].call] * 4 != [spans[0].call] * 4
    for s in spans:
        assert s.start_ns <= s.end_ns and s.device_ms is None  # no events on the CPU
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert tracing.read()["spans"] == []


def test_ranges_open_under_the_profiler_only_where_tracing_is_on():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as off:
        with tracing.span("probe"):
            pass
    with tracing.enabled(device_events=False), torch.profiler.profile(activities=acts) as on:
        with tracing.span("probe"):
            pass
    assert "vcagan.probe" not in {e.name for e in off.events()}
    assert "vcagan.probe" in {e.name for e in on.events()}


def test_a_serving_call_emits_the_serving_tree():
    synth = Synthesizer(ModelConfig(), device="cpu", fold_bn=True, fused_blocks=True)
    video = torch.randn(1, 4, 48, 48, 1)
    lengths = torch.tensor([4], dtype=torch.int32)
    with tracing.enabled():
        synth(video, lengths)
        synth(video, lengths)
    spans = tracing.read()["spans"]
    first = [s for s in spans if s.call == spans[0].call]
    assert len(first) == len(spans) // 2 and spans[len(first)].call != spans[0].call
    names = [s.name for s in first]
    assert names.count("fused_block") == 5 and names.count("attention") == 2
    assert set(names) == set(SERVE_TREE)
    for s in first:
        parent = None if s.parent is None else spans[s.parent]
        assert (parent and parent.name) == SERVE_TREE[s.name], s.name
        if parent is not None:
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    top = [s.name for s in first if s.parent == 0]
    assert top == ["serve.inputs", "serve.v_front", "serve.decoder", "serve.postnet",
                   "serve.vocoder"]


def test_a_train_step_emits_its_parts_in_order_where_on_phase_fires():
    modules = VCAGANModules.create(ModelConfig(**NARROW), seed=0)
    cfg = TrainConfig()
    state, g_tx, d_tx = create_train_state(modules, cfg, steps_per_epoch=1, device="cpu")
    fired = []
    step = make_train_step(modules, g_tx, d_tx, cfg,
                           on_phase=lambda name: fired.append((name, time.perf_counter_ns())))
    rng = np.random.default_rng(0)
    b, w, hw = 2, 20, 24
    batch = Batch(
        video=torch.from_numpy(rng.standard_normal((b, w, hw, hw, 1)).astype(np.float32)),
        mel=torch.from_numpy(np.clip(rng.standard_normal((b, 80, 4 * w)), -1, 1)
                             .astype(np.float32)),
        spec=torch.from_numpy(np.abs(rng.standard_normal((b, 321, 4 * w))).astype(np.float32)),
        vid_len=torch.tensor([w, w - 6], dtype=torch.int32),
        mel_len=torch.tensor([4 * w, 4 * (w - 6)], dtype=torch.int32),
    )
    with tracing.enabled():
        step(state, batch, torch.Generator().manual_seed(7))
    spans = tracing.read()["spans"]
    assert spans[0].name == "train.step" and spans[0].parent is None
    parts = [s for s in spans if s.parent == 0]
    assert [s.name for s in parts] == [f"train.{p}" for p in PHASES]
    assert [name for name, _ in fired] == list(PHASES)
    assert spans[0].start_ns <= parts[0].start_ns and parts[-1].end_ns <= spans[0].end_ns
    for i, (part, (_, at)) in enumerate(zip(parts, fired)):
        assert part.end_ns <= at  # the part ends where on_phase(name) is called
        if i + 1 < len(parts):
            assert at <= parts[i + 1].start_ns  # and the next one starts after it
    inside = {s.name: spans[s.parent].name for s in spans if s.parent not in (None, 0)}
    assert inside["v_front.stem"] == "train.gen_forward"
    assert inside["attention"] == "train.gen_forward"
    assert {s.call for s in spans} == {spans[0].call}


@pytest.mark.parametrize("case, launches", [
    ("strip, one chunk", 1),
    ("strip, two chunks of 65535 samples", 2),
    ("in-block, one split", 1),
    ("in-block, two splits: the combine", 2),
    ("in-block, two splits, three chunks", 6),
    ("split pass, one split", 2),
    ("split pass, two splits", 3),
    ("split pass, two splits, two chunks", 6),
])
def test_attention_launches_from_the_plan(case, launches):
    t, s, d = 75, 75, 256
    plans = {
        "strip, one chunk": (attn.strip_plan(t, s, d, 48), 48),
        "strip, two chunks of 65535 samples": (attn.strip_plan(2, 3, 8, 70000), 70000),
        "in-block, one split": (attn.LongAttentionPlan(t, s, d, 48, 1, in_block=True,
                                                       key_block=40), 48),
        "in-block, two splits: the combine": (
            attn.LongAttentionPlan(t, s, d, 48, 2, in_block=True, key_block=40), 48),
        "in-block, two splits, three chunks": (
            attn.LongAttentionPlan(t, s, d, 48, 2, batch=16, in_block=True, key_block=40), 48),
        "split pass, one split": (attn.LongAttentionPlan(750, 750, d, 4, 1), 4),
        "split pass, two splits": (attn.LongAttentionPlan(750, 750, d, 4, 2), 4),
        "split pass, two splits, two chunks": (attn.LongAttentionPlan(750, 750, d, 4, 2,
                                                                      batch=2), 4),
    }
    plan, b = plans[case]
    assert attn.kernel_launches(plan, b) == launches


@pytest.mark.parametrize("t, s, b", [(75, 75, 48), (150, 75, 48), (40, 40, 88), (80, 40, 88),
                                     (750, 750, 4)])
def test_the_routed_plans_launches(t, s, b):
    """The main paths' shapes: the in-block instance's one launch (and the
    combine with key splits); past 512 keys the split pass's two (and the
    combine)."""
    plan = attn.attention_plan(t, s, 256, b)
    combine = int(plan.splits > 1)
    want = (1 if plan.in_block else 2) + combine
    assert plan.launches == 1 and attn.kernel_launches(plan, b) == want


@pytest.mark.parametrize("n, launches", [(3600, 1), (42799, 1), (42800, 2), (85600, 3)])
def test_fused_block_launches_from_the_plan(n, launches):
    """Chunks of images whose elements stay below 2^31: 42,799 images of
    28 x 28 x 64 a launch."""
    plan = fb.plan_fused_block(n, 28, 28, 64, torch.bfloat16)
    assert fb.kernel_launches(plan) == launches


def test_fit_profile_names_its_loop_ranges_and_the_steps_parts(tmp_path):
    cfg = grid_config(**{f"model.{k}": v for k, v in NARROW.items()},
                      **{"data.window_size": 20, "data.max_v_timesteps": 20,
                         "data.crop_size": 32, "data.data_root": "/nonexistent",
                         "data.synthetic_clips": 4, "train.batch_size": 2,
                         "train.eval_step": 0, "train.workers": 2,
                         "train.checkpoint_dir": str(tmp_path / "ckpt")})
    trainer = Trainer(cfg, log_dir=str(tmp_path / "log"), device="cpu")
    assert trainer.fit(epochs=1, max_steps=2, profile_steps=(0, 2),
                       profile_dir=str(tmp_path / "profile")) == 2
    names = {e.name for e in trainer.last_profile.events()}
    for name in ("feed.wait", "input_pipeline", "train_step", "readback", "train.input",
                 "train.step", *(f"train.{p}" for p in PHASES)):
        assert tracing.PREFIX + name in names, name
    assert list((tmp_path / "profile").glob("trace_step2*.json"))
    assert tracing.span("a") is tracing.span("b")  # off again after the stretch


def test_idle_gaps_go_to_the_innermost_program_range():
    """``tools/program_spans.py``'s reading of a profiled stretch, on
    hand-made events (us): a ``vcagan.*`` range inside ``bench.dispatch``
    takes the gaps that begin in it, the idle time under any ``vcagan.*``
    range is counted, and the device's mirror of a range is not work."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from tools.program_spans import summarise

    def ev(name, start, end, cuda=False):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                               device_type=DeviceType.CUDA if cuda else DeviceType.CPU)

    events = [ev("bench.window", 0, 100), ev("bench.dispatch", 0, 50),
              ev("vcagan.serve", 5, 45), ev("vcagan.serve.vocoder", 30, 45),
              ev("kernel_a", 0, 10, True), ev("kernel_b", 20, 30, True),
              ev("kernel_c", 60, 100, True), ev("vcagan.serve", 10, 60, True)]
    got = summarise(SimpleNamespace(events=lambda: events))
    assert got["busy_s"] == pytest.approx(60e-6) and got["window_s"] == pytest.approx(100e-6)
    assert got["idle_pct"] == pytest.approx(40.0)
    assert dict(got["idle_gaps"]) == pytest.approx({"vcagan.serve": 10e-6,
                                                    "vcagan.serve.vocoder": 30e-6})
    assert got["program_idle_s"] == pytest.approx(25e-6)  # 10 .. 20 and 30 .. 45
    assert got["program_idle_pct"] == pytest.approx(25.0)
    assert got["annotations"] == 1 and got["busy_s_with_mirrors"] == pytest.approx(100e-6)
