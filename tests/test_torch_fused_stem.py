"""The visual front's stem as one kernel: its plain version, its packing, its
plan and where the front calls it.

``fused_stem`` runs the stem chain of the folded bf16 front (convolution,
folded bias, PReLU, max-pool) and writes the trunk's channels-last layout.
On the CPU it runs its plain version, ``fused_stem_reference`` (the CUDA
kernel is held to that plain version on the card by ``chip_smoke.py``):

- the plain version equals the JAX package's bf16 stem (``StemConv`` with
  its folded bias, PReLU and the max-pool, taken where the JAX front hands
  it to its trunk) within a bf16 ulp in a small share of outputs, at the
  GRID shape cut to B=2 and at odd H and W, with slopes of either sign;
- the plain version equals the module chain bit for bit at the GRID shape
  cut to B=2, T in {1, 3, 5, 9}, with slopes of either sign.  The chain is
  taken at the card's rounding points: cuDNN rounds the convolution's fp32
  sum to bf16 and the bias is added after, as the JAX package's flax
  convolution adds it; on the CPU ``Conv3d`` puts the bias inside the fp32
  sum and rounds once, so the chain here rounds the sum first too;
- the folded front (``fused=True``) keeps JAX parity: fp32 at the fold
  tests' 2e-4 (the chain of layers runs), bf16 at the fused-block tests'
  0.05 with a bf16 output (the plain version runs);
- the packed weights round-trip, with zero where no tap is;
- the plan fits 232,448 bytes of shared memory and stores every output
  once, its bands and rings holding every input row and frame the window
  needs, at ragged H, W and T too.  The blocks' cover is taken from
  ``_block_outputs``, a copy in Python of how ``csrc/fused_stem.cu`` maps a
  block to its outputs; the kernel's own indexing is held on the card by
  ``chip_smoke.py``'s ragged, T = 3 and C = 128 shapes;
- the front calls the wrapper once a forward where it is folded, fused and
  bf16, and never unfolded, in fp32, at C = 16 or in the train step, under
  ``remat="none"`` and ``remat="stem"``;
- the wrapper refuses C not a multiple of 64 and devices other than the
  CPU and CUDA.
"""

import flax.linen as flax_nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_weights import jax_variables
from vcagan.nn import VisualFront as JaxVisualFront
from vcagan.nn import fold_generator_side as jax_fold_generator_side
from vcagan.nn.resnet import ResNetTrunk as JaxResNetTrunk
from vcagan_torch import tracing
from vcagan_torch.configs import ModelConfig, TrainConfig
from vcagan_torch.io.weights import from_jax
from vcagan_torch.kernels import fused_stem as fs
from vcagan_torch.nn import VisualFront
from vcagan_torch.nn import visual_front
from vcagan_torch.nn.fold import fold_conv_bn
from vcagan_torch.train import Batch, VCAGANModules, create_train_state, make_train_step
from _torch_threads import _one_thread  # noqa: F401  (autouse)

BF16 = ModelConfig(use_bfloat16=True)
FOLD_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_torch_fold.py
BF16_TOL = dict(rtol=0.05, atol=0.05)  # tests/test_torch_fused_block.py


def _folded_front(config=BF16, seed=0):
    """A folded + fused front whose bias and slopes (of either sign) are
    drawn from ``seed``."""
    front = VisualFront(config, fold_bn=True, fused=True)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        front.frontend[0].bias.normal_(0.0, 0.2, generator=g)
        front.frontend[2].weight.normal_(0.0, 0.5, generator=g)
    return front


def _video(b, t, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((b, t, h, w, 1)).astype(np.float32))


def _chain(front, video):
    """The module chain at the card's rounding points, in the layout the
    trunk reads: (B*T, H', W', C)."""
    conv, act, pool = front.frontend[0], front.frontend[2], front.frontend[3]
    bf16 = torch.bfloat16
    x = video.permute(0, 4, 1, 2, 3).to(bf16).float()
    y = F.conv3d(x, conv.weight.to(bf16).float(), None, conv.stride, conv.padding).to(bf16)
    y = pool(act(y + conv.bias.to(bf16)[:, None, None, None]))
    return y.permute(0, 2, 3, 4, 1).reshape(-1, *y.shape[3:], y.shape[1])


class _TrunkReached(Exception):
    pass


def _jax_stem(params, video):
    """The JAX package's folded bf16 stem output on ``video``, as its front
    hands it to its trunk: (B*T, H', W', C) bf16 as float32.  The front runs
    up to the trunk's call, which is cut off."""
    seen = {}

    def grab(next_fun, args, kwargs, context):
        if isinstance(context.module, JaxResNetTrunk) and context.method_name == "__call__":
            seen["x"] = args[0]
            raise _TrunkReached
        return next_fun(*args, **kwargs)

    front = JaxVisualFront(fold_bn=True, fused=True, dtype=jnp.bfloat16)
    with flax_nn.intercept_methods(grab), pytest.raises(_TrunkReached):
        front.apply({"params": params}, jnp.asarray(video.numpy()), train=False)
    assert seen["x"].dtype == jnp.bfloat16
    return torch.from_numpy(np.array(seen["x"].astype(jnp.float32)))


# ---- the plain version


@pytest.mark.parametrize("shape", [(2, 1, 112, 112), (2, 5, 112, 112), (2, 9, 112, 112),
                                   (2, 3, 37, 29)],
                         ids=lambda shape: "x".join(map(str, shape)))
def test_plain_version_is_the_jax_stem(shape):
    """The JAX package sums the products in another order (its space-to-
    depth convolution at even H and W, the plain one at odd), so a sum that
    falls next to a bf16 rounding boundary may round the other way.  That is
    one ulp of the sum, which the bias add can make two of the output: at
    most two ulps of the output, in at most 1e-4 of the outputs."""
    params, stats = jax_variables(seed=22)
    folded, _ = jax_fold_generator_side(params, stats)
    v_front = folded["v_front"]
    c = v_front["stem_conv"]["kernel"].shape[-1]
    rng = np.random.default_rng(shape[1])
    v_front["stem_conv"]["bias"] = rng.normal(0.0, 0.2, c).astype(np.float32)
    v_front["stem_act"]["alpha"] = rng.normal(0.0, 0.5, c).astype(np.float32)
    assert (v_front["stem_act"]["alpha"] < 0).any() and (v_front["stem_act"]["alpha"] > 0).any()
    video = _video(*shape, seed=shape[1])
    want = _jax_stem(v_front, video)
    weight = torch.from_numpy(np.array(v_front["stem_conv"]["kernel"])).permute(4, 3, 0, 1, 2)
    got = fs.fused_stem_reference(video, weight.contiguous(),
                                  torch.from_numpy(v_front["stem_conv"]["bias"]),
                                  torch.from_numpy(v_front["stem_act"]["alpha"])).float()
    assert got.shape == want.shape == (shape[0] * shape[1], fs.pooled_size(shape[2]),
                                       fs.pooled_size(shape[3]), c)
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(got.abs(), want.abs()))) - 7)
    off = got != want
    assert ((got - want).abs() <= 2 * ulp)[off].all()
    assert off.float().mean() <= 1e-4


@pytest.mark.parametrize("t", [1, 3, 5, 9])
def test_plain_version_is_the_chain_bit_for_bit(t):
    front = _folded_front(seed=t)
    assert (front.frontend[2].weight < 0).any() and (front.frontend[2].weight > 0).any()
    video = _video(2, t, 112, 112, seed=t)
    conv = front.frontend[0]
    with torch.no_grad():
        want = _chain(front, video)
        got = fs.fused_stem_reference(video, conv.weight, conv.bias, front.frontend[2].weight)
        through = front.stem(video)  # the front's own call: the wrapper, on the CPU
    assert got.shape == (2 * t, 28, 28, 64) and got.dtype == torch.bfloat16
    assert got.is_contiguous()
    assert torch.equal(got, want)
    # the trunk gets it as it stands: (B, C, T, H', W') over channels-last memory
    assert through.shape == (2, 64, t, 28, 28)
    assert torch.equal(through.permute(0, 2, 3, 4, 1).reshape(2 * t, 28, 28, 64), want)
    assert through.permute(0, 2, 3, 4, 1).is_contiguous()


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_folded_front_keeps_jax_parity(bf16):
    params, stats = jax_variables(seed=21)
    folded_params, _ = jax_fold_generator_side(params, stats)
    video = np.random.default_rng(1).standard_normal((2, 8, 48, 48, 1)).astype(np.float32)
    want = JaxVisualFront(fold_bn=True, fused=True, dtype=jnp.bfloat16 if bf16 else jnp.float32
                          ).apply({"params": folded_params["v_front"]}, jnp.asarray(video),
                                  train=False)
    front = VisualFront(ModelConfig(use_bfloat16=bf16), fold_bn=True, fused=True)
    front.load_state_dict(fold_conv_bn(from_jax(params, stats)["v_front"]))
    assert front.kernel_stem == bf16
    with torch.no_grad():
        got = front(torch.from_numpy(video))
    for name, g, w in zip(("phon", "sent"), got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), err_msg=name,
                                   **(BF16_TOL if bf16 else FOLD_TOL))


# ---- what the kernel reads: packed weights


def _unpack_stem_weights(packed, c):
    """Inverse of ``pack_stem_weights``: the (288, C) bf16 matrix."""
    v = packed.reshape(c // 64, fs.K_STEPS, 8, 2, 8, 8)
    return v.permute(1, 3, 5, 0, 2, 4).reshape(fs.K_ROWS, c).contiguous()


@pytest.mark.parametrize("c", [64, 128])
def test_pack_stem_weights_round_trip(c):
    weight = torch.randn(c, 1, 5, 7, 7, generator=torch.Generator().manual_seed(c))
    packed = fs.pack_stem_weights(weight)
    assert packed.dtype == torch.bfloat16 and packed.shape == (fs.K_ROWS * c,)
    matrix = _unpack_stem_weights(packed, c)
    assert torch.equal(matrix, fs.stem_matrix(weight).to(torch.bfloat16))
    # row k = 2 * (dt * 28 + dy * 4 + j) + e holds tap (dt, dy, 2 j - 1 + e)
    k = torch.arange(fs.K_ROWS)
    dt, dy, dx = k // 56, (k % 56) // 8, k % 8 - 1
    tap = (k < 2 * fs.PAIRS) & (dx >= 0)
    assert tap.sum() == 245
    assert not matrix[~tap].any()  # the padded K entries are zero
    want = weight[:, 0, dt[tap], dy[tap], dx[tap]].T.to(torch.bfloat16)
    assert torch.equal(matrix[tap], want)


def test_pack_stem_weights_lays_out_core_matrices():
    """A core matrix is 8 output channels x 16 bytes of k, 128 bytes; a
    k-step's two halves follow each other, then the next 8 channels; each
    64 channels are one block's."""
    c = 128
    weight = torch.randn(c, 1, 5, 7, 7, generator=torch.Generator().manual_seed(3))
    matrix = fs.stem_matrix(weight).to(torch.bfloat16)
    packed = fs.pack_stem_weights(weight).reshape(c // 64, fs.K_STEPS, 8, 2, 8, 8)
    chunk, s, j = 1, 7, 5
    for half in (0, 1):
        rows = slice(16 * s + 8 * half, 16 * s + 8 * half + 8)
        want = matrix[rows, 64 * chunk + 8 * j:64 * chunk + 8 * j + 8].T
        assert torch.equal(packed[chunk, s, j, half], want)


# ---- the plan

PLAN_CASES = [(48, 75, 112, 112, 64), (8, 160, 112, 112, 64), (48, 3, 112, 112, 64),
              (2, 9, 48, 48, 64), (3, 7, 37, 29, 64), (2, 6, 40, 52, 128), (1, 11, 23, 111, 64),
              (1, 1, 1, 1, 64), (5, 2, 9, 200, 192), (1, 750, 112, 112, 64)]


def _block_outputs(plan, block):
    """What one block writes and reads, indexed as ``csrc/fused_stem.cu``
    indexes it (channel chunk fastest, then band, frame chunk, clip):
    ``stores`` (frame n = clip * T + t, pooled row, pooled column, first
    channel) of every 8 channels it writes, ``conv_rows`` (the convolution
    rows it computes) and ``input_rows`` / ``frames`` (the band of input
    rows and the frames its ring holds, padding included)."""
    p = plan
    cchunks = p.c // fs.CHANNEL_MULTIPLE
    cc, rest = block % cchunks, block // cchunks
    band, rest = rest % p.bands, rest // p.bands
    chunk, clip = rest % p.chunks, rest // p.chunks
    p0, p1 = band * p.p, min(band * p.p + p.p, p.hp)
    h0, h1 = max(2 * p0 - 1, 0), min(2 * p1, p.ho)
    t0, t1 = chunk * p.tc, min(chunk * p.tc + p.tc, p.t)
    t_, pr, pc, cg = np.meshgrid(np.arange(t0, t1), np.arange(p0, p1), np.arange(p.wp),
                                 np.arange(8), indexing="ij")
    stores = np.stack([clip * p.t + t_, pr, pc, cc * 64 + 8 * cg], axis=-1).reshape(-1, 4)
    return dict(stores=stores, conv_rows=range(h0, h1),
                input_rows=range(2 * h0 - 3, 2 * h0 - 3 + p.band_rows),
                frames=range(t0 - 2, t1 + 2))


def _check_plan(plan):
    """Shared memory, the kernel's limits, and the cover: every output (frame,
    pooled row, pooled column, 8 channels) stored once; each block's
    convolution rows, input rows and frames hold its windows."""
    assert plan.smem <= fs.MAX_SMEM == 232448
    assert plan.smem == fs._smem_bytes(plan.p, plan.h, plan.w)
    assert len(plan.ints()) == 8 and plan.ints()[-1] == plan.smem
    assert 1 <= plan.p <= plan.hp and 1 <= plan.tc <= plan.t
    groups = plan.c // 8
    written = np.zeros(plan.b * plan.t * plan.hp * plan.wp * groups, np.uint8)
    for block in range(plan.blocks):
        out = _block_outputs(plan, block)
        n, pr, pc, ch = out["stores"].T
        np.add.at(written, ((n * plan.hp + pr) * plan.wp + pc) * groups + ch // 8, 1)
        if not len(pr):
            continue
        conv, rows, frames = out["conv_rows"], out["input_rows"], out["frames"]
        # the pool's window in the image, the convolution's in the band
        assert conv.start <= max(2 * pr.min() - 1, 0)
        assert conv.stop >= min(2 * pr.max() + 2, plan.ho)
        assert len(conv) <= plan.conv_rows
        assert rows.start <= 2 * conv.start - 3 and rows.stop >= 2 * (conv.stop - 1) + 4
        t = n % plan.t
        assert frames.start <= t.min() - 2 and frames.stop >= t.max() + 3
    assert (written == 1).all()


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda case: "x".join(map(str, case)))
def test_plan_fits_shared_memory_and_covers_every_output_once(case):
    plan = fs.plan_fused_stem(*case)
    assert (plan.b, plan.t, plan.h, plan.w, plan.c) == case
    _check_plan(plan)


def test_every_candidate_the_planner_weighs_is_a_plan_the_kernel_takes():
    plans = fs.candidate_plans(3, 7, 37, 29, 64)
    assert fs.plan_fused_stem(3, 7, 37, 29, 64) in plans
    assert len({(p.p, p.tc) for p in plans}) == len(plans) > 20
    for plan in plans[::5]:
        _check_plan(plan)


def test_plan_refuses_what_the_kernel_does_not_take():
    for c in (16, 48, 96):
        with pytest.raises(ValueError, match="multiple of 64"):
            fs.plan_fused_stem(2, 3, 16, 16, c)
    with pytest.raises(ValueError, match=">= 1"):
        fs.plan_fused_stem(0, 3, 16, 16, 64)
    with pytest.raises(ValueError, match="fits"):  # one band of input rows alone is too wide
        fs.plan_fused_stem(1, 1, 16, 12000, 64)


# ---- where the front calls the wrapper


@pytest.fixture
def calls(monkeypatch):
    """Counts the front's calls of the wrapper, which still runs."""
    seen = []

    def spy(*args, **kwargs):
        seen.append(args[0].shape)
        return fs.fused_stem(*args, **kwargs)

    monkeypatch.setattr(visual_front, "fused_stem", spy)
    return seen


@pytest.mark.parametrize("config,fold,fused,want", [
    (BF16, True, True, 2),
    (BF16, True, False, 0),
    (BF16, False, False, 0),
    (ModelConfig(), True, True, 0),
    (ModelConfig(use_bfloat16=True, stem_channels=16), True, True, 0),
], ids=["folded+fused bf16", "folded bf16", "unfolded bf16", "folded+fused fp32",
        "folded+fused bf16 C=16"])
def test_the_front_calls_the_wrapper_once_a_forward_where_folded_fused_and_bf16(
        calls, config, fold, fused, want):
    front = VisualFront(config, fold_bn=fold, fused=fused).eval()
    video = _video(1, 3, 32, 32)
    with torch.no_grad():
        for _ in range(2):
            front(video)
    assert len(calls) == want and front.kernel_stem == (want > 0)
    assert all(shape == video.shape for shape in calls)


@pytest.mark.parametrize("remat", ["none", "stem"])
def test_the_train_step_never_calls_the_wrapper(calls, remat):
    config = ModelConfig(use_bfloat16=True, gru_hidden=32, noise_dim=16, attention_dim=32,
                         attention_inner=160, postnet_channels=32, disc_base_channels=8,
                         disc_max_channels=32)  # stem_channels 64, the kernel's width
    modules = VCAGANModules.create(config, seed=0)
    cfg = TrainConfig()
    state, g_tx, d_tx = create_train_state(modules, cfg, steps_per_epoch=1, device="cpu")
    step = make_train_step(modules, g_tx, d_tx, cfg, remat=remat)
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
    state, metrics = step(state, batch, torch.Generator().manual_seed(1))
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert calls == [] and not modules.v_front.kernel_stem


# ---- refusals


def test_the_wrapper_refuses_c_not_a_multiple_of_64_and_other_devices():
    video = _video(1, 2, 16, 16)
    for c in (16, 48, 96):
        weight, vec = torch.randn(c, 1, 5, 7, 7), torch.randn(c)
        with pytest.raises(ValueError, match="multiple of 64"):
            fs.fused_stem(video, weight, vec, vec)
        with pytest.raises(ValueError, match="multiple of 64"):
            fs.pack_stem_weights(weight)
    weight, vec = torch.randn(64, 1, 5, 7, 7), torch.randn(64)
    before = tracing.counters()
    out = fs.fused_stem(video, weight, vec, vec)  # the plain version, not counted
    assert tracing.counters() == before
    assert torch.equal(out, fs.fused_stem_reference(video, weight, vec, vec))
    with pytest.raises(ValueError, match="no fused stem for device meta"):
        fs.fused_stem(video.to("meta"), weight.to("meta"), vec.to("meta"), vec.to("meta"))
    with pytest.raises(ValueError, match="must lie on a CUDA device"):
        fs.fused_stem_cuda(video, fs.pack_stem_weights(weight), vec, vec)
