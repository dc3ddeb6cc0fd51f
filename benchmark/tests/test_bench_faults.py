"""The comparison fails what it must: whole runs on the CPU at a small
size (the look for a card skipped), with the timed path broken underneath,
and the control (the plain reference in fp8 put in the program's place),
each read against the cells' committed limits."""

import time

import pytest
import torch

from benchmark.calibrate import losses_over_half
from benchmark.harness import result
from benchmark.kinds import serve, train
from benchmark.tests.helpers_bench import small_cell

CPU = torch.device("cpu")


SERVING = [("grid-serve-bf16", False), ("grid-serve-bf16", True)]
TRAINING = [("grid-train-bf16", False), ("grid-train-bf16", True)]
IDS = ["cell", "varying-lengths"]


def correct(cell, seed=11, seconds=1.0):
    kind = serve if cell.traffic["kind"] == "serve" else train
    outcome = kind.run(cell, seed, seconds, False, CPU, time.perf_counter())
    outcome.device = {}
    return result.line(cell, outcome, False)


@pytest.mark.parametrize("name, variable", SERVING, ids=IDS)
def test_sound_serving_run_is_correct(name, variable):
    line = correct(small_cell(name, variable))
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name, variable", SERVING, ids=IDS)
def test_serving_answer_altered_where_produced(name, variable, monkeypatch):
    from vcagan_torch.nn.generator import Postnet

    forward = Postnet.forward

    def altered(self, mel):
        out = forward(self, mel)
        return torch.cat([out[:1] * 1.5, out[1:]])

    monkeypatch.setattr(Postnet, "forward", altered)
    assert not correct(small_cell(name, variable))["correct"]


@pytest.mark.parametrize("name, variable", SERVING, ids=IDS)
def test_serving_half_the_batch_left_out(name, variable, monkeypatch):
    from vcagan_torch.serve import Synthesizer

    call = Synthesizer.__call__

    def half(self, video, lengths, noise=None, init_phase=None, generator=None):
        h = video.shape[0] // 2
        out = call(self, video[:h], lengths[:h], noise[:h], init_phase[:h], generator)
        return {k: torch.cat([v, v])[:video.shape[0]] for k, v in out.items()}

    monkeypatch.setattr(Synthesizer, "__call__", half)
    assert not correct(small_cell(name, variable))["correct"]


@pytest.mark.parametrize("name, variable", SERVING, ids=IDS)
def test_serving_control_in_fp8_fails(name, variable):
    cell = small_cell(name, variable)
    r = serve.ServeRun(cell, CPU, control=True)
    w = r.window(13, 1.0, False)
    checks = result.checks_against(r.check(13, w), cell.limits)
    assert not all(c.ok for c in checks), checks


@pytest.mark.parametrize("name, variable", TRAINING, ids=IDS)
def test_train_step_that_leaves_the_state_unchanged(name, variable, monkeypatch):
    from vcagan_torch.train.state import Optimizer

    monkeypatch.setattr(Optimizer, "update", lambda self, grads, state, params: None)
    line = correct(small_cell(name, variable))
    assert not line["correct"]
    assert line["checks"]["change_rel"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name, variable", TRAINING, ids=IDS)
def test_train_step_on_half_the_batch(name, variable):
    """Every loss over half of each batch, the forward whole: the shapes
    are those of a sound run, so only the numbers can tell."""
    with losses_over_half():
        line = correct(small_cell(name, variable))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name, variable", TRAINING, ids=IDS)
def test_train_control_in_fp8_fails(name, variable):
    cell = small_cell(name, variable)
    r = train.TrainRun(cell, 17, CPU, "control")
    got = r.check_steps()
    w = r.window(0.0, False)
    r.free()
    checks = result.checks_against(train.check(cell, 17, CPU, got, r.raws, r.initial,
                                               w["snapshot"]), cell.limits)
    assert not all(c.ok for c in checks), checks
