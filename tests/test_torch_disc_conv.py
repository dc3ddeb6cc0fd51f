"""The discriminators' convolution, ``DiscConv2d`` on ``conv2d_twice``
(``vcagan_torch/nn/discriminator.py``): the same function as ``F.conv2d``
with a backward that differentiates again through ``conv_transpose2d``.

- The Function by ``gradcheck`` and ``gradgradcheck`` in float64 at each kind
  of discriminator convolution: the input convolution 1 -> 32 5x5 pad 2, a
  block's 32 -> 32 5x5 pad 2, a 1x1 shortcut without bias, a head's 5x5
  valid.  At those widths the checks take random directions (``fast_mode``);
  at narrow widths of the same four kinds, every direction.
- A whole ``Discriminator`` of each phase (narrow widths, B = 2, the 20-frame
  minimum window) against the same module on ``F.conv2d``: R1's parameter
  gradients and the D loss's (real, R1 and fake terms) within 1e-10 of the
  largest value of each leaf in float64.  Through the CPU bf16 path (bf16
  convolutions in fp32 on the rounded operands) within 2^-8 relative L2 a
  leaf, one bf16 step: both paths round fp32 sums of the same operands to
  bf16 at every convolution, and a sum taken in another order can round
  the other way, which the backward carries on (measured at most 1.1e-4).
- Where the backward runs: R1's gradient into the mel takes no weight
  gradient (``aten::convolution_backward``), one ``conv_transpose2d`` a
  convolution on the logit's path; the D backward then runs no
  ``aten::_convolution_double_backward``.
- Anything but stride 1, dilation 1, one group and zero padding raises.
- One step at GRID's discriminator widths (32 -> 512 channels; the
  generator side narrow) counts 33 ``disc_conv.graph_backwards``: one a
  convolution on the path from the unconditional logit to the mel, 8 / 11 /
  14 in phases 1 / 2 / 3 (the input convolution, three a block, the head),
  under ``d_phase`` "ref" and "batched" and ``remat="r1"``; 39
  ``disc_conv.calls`` a forward of the three discriminators (10 / 13 / 16),
  three such forwards a step, and two more recomputes of the R1 forward
  under ``remat="r1"``.  The step's profile holds no double backward.
"""

import contextlib
import os
import sys

import pytest
import torch
import torch.nn.functional as F
from torch import nn

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from _torch_threads import _one_thread  # noqa: E402, F401  (autouse)
from test_torch_step_knobs import MODEL, make_batch, nonzero_biases  # noqa: E402
from vcagan_torch import tracing  # noqa: E402
from vcagan_torch.configs import ModelConfig, TrainConfig  # noqa: E402
from vcagan_torch.nn.common import init_like_jax  # noqa: E402
from vcagan_torch.nn.discriminator import DiscConv2d, Discriminator, conv2d_twice  # noqa: E402
from vcagan_torch.nn.losses import gan_loss, r1_penalty  # noqa: E402
from vcagan_torch.train import VCAGANModules, create_train_state, make_train_step  # noqa: E402

# (c_in, c_out, kernel, padding, bias, (H, W))
KINDS = {
    "input_5x5": (1, 32, 5, 2, True, (10, 12)),
    "block_5x5": (32, 32, 5, 2, True, (8, 10)),
    "shortcut_1x1": (32, 64, 1, 0, False, (8, 10)),
    "head_5x5_valid": (64, 64, 5, 0, True, (5, 8)),
}
NARROW_KINDS = {
    "input_5x5": (1, 3, 5, 2, True, (6, 7)),
    "block_5x5": (3, 3, 5, 2, True, (6, 7)),
    "shortcut_1x1": (3, 4, 1, 0, False, (6, 7)),
    "head_5x5_valid": (3, 3, 5, 0, True, (5, 7)),
}
DISC = dict(disc_base_channels=8, disc_max_channels=32)
GRID_DISC = dict(MODEL, disc_base_channels=32, disc_max_channels=512)
B, S = 2, 20
FLOAT64_RTOL = 1e-10
BF16_REL_L2 = 2.0 ** -8  # one bf16 step
DOUBLE = "aten::_convolution_double_backward"


def _operands(kind, kinds, seed=0):
    c_in, c_out, k, p, bias, (h, w) = kinds[kind]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, c_in, h, w, generator=g, dtype=torch.float64, requires_grad=True)
    weight = torch.randn(c_out, c_in, k, k, generator=g, dtype=torch.float64,
                         requires_grad=True)
    b = torch.randn(c_out, generator=g, dtype=torch.float64, requires_grad=True) if bias else None
    return (x, weight, b), p


@pytest.mark.parametrize("fast, kinds", [(True, KINDS), (False, NARROW_KINDS)],
                         ids=["disc_widths_fast", "narrow_every_direction"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_gradcheck_and_gradgradcheck(kind, fast, kinds):
    (x, weight, b), p = _operands(kind, kinds)
    inputs = (x, weight) if b is None else (x, weight, b)

    def fn(*t):
        return conv2d_twice(t[0], t[1], t[2] if len(t) > 2 else None, padding=p)

    assert torch.autograd.gradcheck(fn, inputs, fast_mode=fast)
    assert torch.autograd.gradgradcheck(fn, inputs, fast_mode=fast)


@pytest.mark.parametrize("kind", list(KINDS))
def test_forward_and_first_gradients_are_conv2d(kind):
    (x, weight, b), p = _operands(kind, KINDS, seed=1)
    got = conv2d_twice(x, weight, b, padding=p)
    want = F.conv2d(x, weight, b, padding=p)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    g = torch.randn_like(want)
    leaves = [t for t in (x, weight, b) if t is not None]
    for a, w in zip(torch.autograd.grad(got, leaves, g), torch.autograd.grad(want, leaves, g)):
        torch.testing.assert_close(a, w, rtol=1e-12, atol=1e-12)


@contextlib.contextmanager
def plain_convs():
    """``DiscConv2d`` on ``nn.Conv2d``'s own ``F.conv2d`` inside the block."""
    own = DiscConv2d._conv_forward
    DiscConv2d._conv_forward = nn.Conv2d._conv_forward
    try:
        yield
    finally:
        DiscConv2d._conv_forward = own


def _discriminator(phase, dtype):
    d = Discriminator(phase, ModelConfig(**DISC, use_bfloat16=dtype == torch.bfloat16))
    init_like_jax(d, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in d.modules():
            if isinstance(m, (nn.Linear, DiscConv2d)) and m.bias is not None:
                m.bias.uniform_(-0.1, 0.1, generator=g)
    if dtype == torch.float64:
        d.double()
        for m in d.modules():
            if isinstance(m, DiscConv2d):
                m.compute_dtype = torch.float64
    return d


def _d_gradients(d, phase, dtype):
    """R1's parameter gradients and the D loss's, as ``d_phase="ref"`` takes
    them, on seeded real and fake mels of the phase's scale."""
    f = {"1": 20, "2": 40, "3": 80}[phase]
    real_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    g = torch.Generator().manual_seed(5)
    real = torch.rand(B, f, f, generator=g, dtype=real_dtype) * 2 - 1
    fake = (torch.rand(B, f, f, generator=g, dtype=real_dtype) * 2 - 1).to(
        torch.bfloat16 if dtype == torch.bfloat16 else real_dtype)
    sent = torch.randn(B, S, 512, generator=g, dtype=real_dtype)
    params = list(d.parameters())
    x = real.clone().requires_grad_()
    u, c = d(x, sent)
    r1 = r1_penalty(u, x)
    r1_grads = torch.autograd.grad(r1, params, retain_graph=True, allow_unused=True)
    uf, cf = d(fake, sent)
    loss = gan_loss(u, True) + gan_loss(c, True) + r1 + gan_loss(uf, False) + gan_loss(cf, False)
    return r1_grads, torch.autograd.grad(loss, params)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16], ids=["float64", "bf16"])
@pytest.mark.parametrize("phase", ["1", "2", "3"])
def test_discriminator_gradients_match_conv2d(phase, dtype):
    d = _discriminator(phase, dtype)
    got = _d_gradients(d, phase, dtype)
    with plain_convs():
        want = _d_gradients(d, phase, dtype)
    names = [n for n, _ in d.named_parameters()]
    for which, gs, ws in zip(("r1", "d_loss"), got, want):
        for name, a, w in zip(names, gs, ws):
            if w is None:  # the conditional head is not on R1's path
                assert a is None, (which, name)
                continue
            if not w.any():  # R1's gradient into a bias: it moves only the slopes' masks
                assert not a.any(), (which, name)
                continue
            if dtype == torch.float64:
                torch.testing.assert_close(a, w, rtol=0, atol=FLOAT64_RTOL * float(w.abs().max()),
                                           msg=f"{which} {name}")
            else:
                rel = float(torch.linalg.vector_norm(a - w) / torch.linalg.vector_norm(w))
                assert rel <= BF16_REL_L2, (which, name, rel)


def _ops(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    names = [e.name for e in prof.events()]
    return {n: names.count(n) for n in set(names)}


def test_r1_takes_no_weight_gradient_and_never_double_backward():
    d = _discriminator("2", torch.float32)
    x = torch.rand(B, 40, 40) * 2 - 1
    x.requires_grad_()
    u, c = d(x, torch.randn(B, S, 512))
    on_path = sum(isinstance(m, DiscConv2d) for m in [*d.main.modules(), *d.uncond.modules()])
    grads = []
    first = _ops(lambda: grads.append(torch.autograd.grad(u.sum(), x, create_graph=True)[0]))
    assert first.get("aten::convolution_backward", 0) == 0
    assert first.get("aten::conv_transpose2d", 0) == on_path
    penalty = grads[0].flatten(1).square().sum(1).mean()
    second = _ops(lambda: torch.autograd.grad(penalty + u.mean() + c.mean(), list(d.parameters())))
    assert second.get(DOUBLE, 0) == 0
    with plain_convs():
        u, _ = d(x, torch.randn(B, S, 512))
        (g,) = torch.autograd.grad(u.sum(), x, create_graph=True)
        plain = _ops(lambda: torch.autograd.grad(g.square().sum(), list(d.parameters()),
                                                 allow_unused=True))
    assert plain.get(DOUBLE, 0) == on_path  # what the module replaces


@pytest.mark.parametrize("kwargs", [dict(stride=2), dict(dilation=2), dict(groups=2),
                                    dict(padding="same"), dict(stride=(1, 2))],
                         ids=["stride", "dilation", "groups", "padding_str", "stride_pair"])
def test_conv2d_twice_refuses_what_it_does_not_compute(kwargs):
    x, w = torch.randn(1, 2, 6, 6), torch.randn(2, 2 // kwargs.get("groups", 1), 3, 3)
    with pytest.raises(ValueError):
        conv2d_twice(x, w, None, **kwargs)


@pytest.mark.parametrize("kwargs", [dict(stride=2), dict(dilation=2), dict(groups=2),
                                    dict(padding=1, padding_mode="reflect")],
                         ids=["stride", "dilation", "groups", "reflect"])
def test_disc_conv2d_refuses_what_it_does_not_compute(kwargs):
    conv = DiscConv2d(2, 2, 3, **kwargs)
    with pytest.raises(ValueError):
        conv(torch.randn(1, 2, 8, 8))


# per step: (graph backwards, calls); a forward of the three discriminators
# at GRID widths is 39 calls, and remat="r1" recomputes R1's forward twice
STEP_COUNTS = {("ref", "none"): (33, 3 * 39), ("batched", "none"): (33, 3 * 39),
               ("ref", "r1"): (33, 5 * 39)}


@pytest.mark.parametrize("knobs", list(STEP_COUNTS), ids="/".join)
def test_grid_step_counts_graph_backwards(knobs):
    d_phase, remat = knobs
    modules = nonzero_biases(VCAGANModules.create(ModelConfig(**GRID_DISC), seed=0))
    cfg = TrainConfig()
    state, g_tx, d_tx = create_train_state(modules, cfg, steps_per_epoch=1, device="cpu")
    step = make_train_step(modules, g_tx, d_tx, cfg, d_phase=d_phase, remat=remat)
    batch, generator = make_batch(torch.float32), torch.Generator().manual_seed(7)
    tracing.read()
    ops = _ops(lambda: step(state, batch, generator))
    counts = tracing.read()["counters"]
    assert (counts["disc_conv.graph_backwards"], counts["disc_conv.calls"]) == STEP_COUNTS[knobs]
    assert ops.get(DOUBLE, 0) == 0
