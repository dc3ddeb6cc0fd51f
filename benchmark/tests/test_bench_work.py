"""The work counts reproduce the bounds that PERF.md gives from shapes."""

import torch

from benchmark.harness import work
from benchmark.reference import model

TRUNK_BLOCKS = ((28, 28, 64), (28, 28, 64), (14, 14, 128), (7, 7, 256), (4, 4, 512))


def test_fused_blocks_bf16_bound_at_n_3600():
    ms = 1e3 * sum(work.fused_block_least_s(3600, h, w, c, torch.bfloat16)
                   for h, w, c in TRUNK_BLOCKS)
    assert round(ms, 2) == 2.23


def test_attention_bound_of_one_forward_at_b_48():
    ms = 1e3 * (work.attention_least_s(48, 75, 75, 256) + work.attention_least_s(48, 150, 75, 256))
    assert round(ms, 4) == 0.0110


def test_griffin_lim_fft_bound():
    assert round(1e3 * work.griffin_lim_fft_least_s(48, 300), 3) == 0.388


def test_model_flops_count_every_convolution():
    """One GRID batch's model FLOPs on meta tensors: the trunk's 20 3x3
    convolutions alone are 2 * 9 * sum(Cin Cout H W) * N."""
    w = model.Widths()
    mods = model.build(model.GENERATOR_SIDE, w)
    n_img = 48 * 75
    trunk = 2 * 9 * n_img * (4 * 64 * 64 * 28 * 28 + (64 * 128 + 3 * 128 * 128) * 14 * 14
                             + (128 * 256 + 3 * 256 * 256) * 7 * 7
                             + (256 * 512 + 3 * 512 * 512) * 4 * 4)
    video = torch.empty((48, 75, 112, 112, 1), device="meta")
    counted = work.counted_flops(lambda: mods["v_front"].resnet(
        torch.empty((n_img, 64, 28, 28), device="meta"), False))
    assert counted >= trunk
    assert counted < 1.05 * trunk
    assert work.counted_flops(lambda: mods["v_front"](video)) > counted
