"""The seeded traffic: the same seed gives the same inputs, every seed the
same mix, clips go to the first bucket that holds them, and short training
windows are masked in the share the lengths give."""

import numpy as np
import torch

from benchmark.harness import spec
from benchmark.harness.traffic import block_lengths
from benchmark.kinds import serve, train
from benchmark.tests.helpers_bench import VARIABLE, small_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345  # above 32 signed bits
LENGTHS = {"lognormal": dict(median=70, sigma=0.45, min=25, max=160)}


def variable_serving():
    """Serving traffic of varying lengths, as a later cell's data file may
    give it: four buckets, blocks of 400 clips."""
    t = dict(spec.load_cell(spec.load_benchmark(), "grid-serve-bf16").traffic)
    t.update(batch=16, lengths=LENGTHS, block=400, buckets=[40, 80, 120, 160])
    return t


def test_serving_traffic_is_seeded():
    for t in (variable_serving(), spec.load_cell(spec.load_benchmark(), "grid-serve-bf16").traffic):
        a, b, c = serve.Traffic(t, SEED), serve.Traffic(t, SEED), serve.Traffic(t, SEED + 1)
        assert [a.batch(i) for i in range(50)] == [b.batch(i) for i in range(50)]
        x = a.inputs(SEED, 3, CPU, 16, 8, 4)
        y = b.inputs(SEED, 3, CPU, 16, 8, 4)
        z = c.inputs(SEED + 1, 3, CPU, 16, 8, 4)
        for u, v, w in zip(x, y, z):
            assert torch.equal(u, v)
        assert not torch.equal(x[0], z[0])
    t = variable_serving()
    a, c = serve.Traffic(t, SEED), serve.Traffic(t, SEED + 1)
    assert [a.batch(i) for i in range(50)] != [c.batch(i) for i in range(50)]


def test_every_seed_serves_the_same_lengths():
    t = variable_serving()
    for seed in (1, SEED):
        tr = serve.Traffic(t, seed)
        tr.batch(0)
        assert sorted(tr.lengths) == sorted(block_lengths(t["lengths"], t["block"]))


def test_clips_go_to_the_first_bucket_that_holds_them():
    """Every clip in the bucket its length needs, padded to it; over whole
    blocks the bucket shares are those of the block's lengths."""
    t = variable_serving()
    tr = serve.Traffic(t, SEED)
    batches = [tr.batch(i) for i in range(250)]  # 4000 clips: 10 blocks
    clips = [n for _, lengths in batches for n in lengths]
    for frames, lengths in batches:
        assert len(lengths) == t["batch"]
        assert all(tr.bucket(n) == frames for n in lengths)
    block = block_lengths(t["lengths"], t["block"])
    for bucket in t["buckets"]:
        want = np.mean([tr.bucket(int(n)) == bucket for n in block])
        got = np.mean([tr.bucket(n) == bucket for n in clips])
        assert abs(got - want) < 0.01, (bucket, got, want)


def test_fixed_lengths_serve_one_shape():
    tr = serve.Traffic(spec.load_cell(spec.load_benchmark(), "grid-serve-bf16").traffic, SEED)
    assert {tr.batch(i) for i in range(20)} == {(75, (75,) * 48)}


def test_train_pool_is_seeded_and_short_windows_are_masked():
    cell = small_cell("grid-train-bf16", True)
    a, b = train.pool(cell.traffic, SEED, CPU), train.pool(cell.traffic, SEED, CPU)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        assert all(torch.equal(x[k], y[k]) for k in x)
    t = cell.traffic
    lengths = block_lengths(t["lengths"], t["pool"] * t["batch"])
    got = torch.cat([raw["vid_len"] for raw in a]).numpy()
    assert sorted(got) == sorted(np.minimum(lengths, t["window"]))
    assert VARIABLE["grid-train"]["traffic"]["dataset"] == "lrs" and "centers" in a[0]
