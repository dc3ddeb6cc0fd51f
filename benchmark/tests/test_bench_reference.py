"""The plain reference against the program's plain route (CPU tensors take
the program's plain PyTorch versions of its kernels), on the same weights,
inputs and draws."""

import math
import os

import torch

from benchmark.harness import spec
from benchmark.kinds import serve, train
from benchmark.reference import model, pipeline as ref_pipeline, serve as ref_serve, weights
from benchmark.tests.helpers_bench import small_cell

CPU = torch.device("cpu")


def rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def test_serving_reference_matches_the_program_in_fp32():
    from vcagan_torch.configs import ModelConfig
    from vcagan_torch.serve import Synthesizer

    states = weights.serving_states(os.path.join(spec.ROOT, "data/soak_serving_q8.npz"))
    mods = model.load(model.GENERATOR_SIDE, model.Widths(), states, CPU)
    synth = Synthesizer(ModelConfig(), device="cpu").load_state_dicts(states)
    g = torch.Generator().manual_seed(1)
    b, t = 2, 6
    video = torch.randn(b, t, 112, 112, 1, generator=g)
    lengths = torch.tensor([6, 4], dtype=torch.int32)
    noise = torch.randn(b, 20, t, 128, generator=g)
    phase = (2 * torch.rand(b, 4 * t, 321, generator=g) - 1) * math.pi
    got = synth(video, lengths, noise=noise, init_phase=phase)
    want = ref_serve.forward(mods, video, lengths.long(), noise, phase)
    for name in ("phon", "sent", "mel1", "mel2", "mel3", "spec"):
        assert rel(got[name], want[name]) < 1e-5, name
    # 60 Griffin-Lim rounds carry float32 rounding of the spectrogram along
    assert rel(got["wav"], want["wav"]) < 2e-3


def test_pipelines_match_the_program():
    from vcagan_torch.configs import AudioConfig, DataConfig
    from vcagan_torch.data.device_pipeline import make_device_pipeline
    from vcagan_torch.data.lrs import make_lrs_device_pipeline

    for variable, make in ((False, lambda c: make_device_pipeline(
            AudioConfig(f_max=c["train"]["f_max"]), DataConfig(window_size=20), True, "cpu")),
                           (True, lambda c: make_lrs_device_pipeline(
            AudioConfig(f_max=c["train"]["f_max"]), True, "cpu"))):
        name = "lrs pipeline" if variable else "grid pipeline"
        cell = small_cell("grid-train-bf16", variable)
        raw = train.pool(cell.traffic, 3, CPU)[0]
        got = make(cell.config)(raw, torch.Generator().manual_seed(4))
        want = ref_pipeline.PIPELINES[cell.traffic["dataset"]](raw, torch.Generator().manual_seed(4))
        for a, b, what in zip(got, want, ("video", "mel", "spec", "vid_len", "mel_len")):
            assert a.shape == b.shape, (name, what)
            assert rel(a, b) < 1e-5, (name, what)


def test_train_reference_follows_the_program_in_fp32():
    """Three steps at narrow widths in float32 from the same weights, raw
    batches and generator: the losses within 1e-3, the first gradient and
    the change after three steps by the worst leaf within a few percent
    (float32 gradients of this network are about 3e-3 apart from float64
    on each side, and Adam's update divides by them)."""
    for name in (False, True):
        cell = small_cell("grid-train-bf16", name)
        cell.config["model"]["use_bfloat16"] = False
        r = train.TrainRun(cell, 5, CPU)
        got = r.check_steps()
        w = r.window(0.0, False)
        r.free()
        values = train.check(cell, 5, CPU, got, r.raws, r.initial, w["snapshot"])
        assert values["loss_rel"] < 1e-3, (name, values)
        assert values["grad_rel"] < 2e-2, (name, values)
        assert values["change_rel"] < 5e-2, (name, values)
        assert values["win_loss_rel"] < 1e-3, (name, values)
        assert values["win_grad_rel"] < 2e-2, (name, values)
        assert values["win_change_rel"] < 5e-2, (name, values)


def test_seeded_weights_fill_every_leaf_of_the_program():
    from vcagan_torch.configs import ModelConfig
    from vcagan_torch.train import VCAGANModules

    states = weights.seeded_states(train.ALL, model.Widths(), 1, CPU)
    mods = VCAGANModules.create(ModelConfig())
    for name, module in mods.named():
        assert set(module.state_dict()) == set(states[name]), name
        for key, value in module.state_dict().items():
            assert value.shape == states[name][key].shape, (name, key)


def test_serving_check_reads_small_in_bf16():
    """The comparison at a tiny size on the CPU, the program in bf16: every
    number finite and small (the cell's limits are set on the card)."""
    cell = small_cell("grid-serve-bf16")
    r = serve.ServeRun(cell, CPU)
    w = r.window(7, 0.5, False)
    values = r.check(7, w)
    assert set(values) == set(cell.limits)
    assert all(0 <= v < 0.2 for v in values.values()), values
