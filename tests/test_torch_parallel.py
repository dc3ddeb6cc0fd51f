"""The port's data-parallel layout and per-rank feed, in one process.

- ``local_batch_slice`` against the JAX package's at 3 ranks (slices and
  the indivisible batch's message), ``DataLayout.batch_slice`` the same;
  ``initialize_distributed`` a no-op without a multi-process environment;
  ``make_layout`` refuses a model group of 2 in one process and a world
  that does not divide the batch (giving the gcd the JAX Trainer would
  have used); the config carries ``model_parallel=2``.
- The GRID and LRS epochs with ``process_slice``: ranks 0 and 1 of a
  global batch of 4, concatenated, equal the unsliced epoch bit for bit
  (shuffle, window draws, the padded tail's ``n_valid``), and each rank's
  slice equals the JAX package's for the same slice.  The LRS evaluation
  bucket is the global batch's decision, with the lengths of
  ``tests/test_multihost_feed.py:103``.
- ``ParallelEpoch`` and ``ProcessEpoch`` pass the slice through.
- ``draw_rows`` under an active layout: the ranks' rows of a draw
  concatenate to one process's draw, and the generator advances as that
  process's does; without a layout (or at one rank) it is the plain draw.
"""

import numpy as np
import pytest
import torch

import vcagan.parallel.multihost as jax_multihost
from vcagan.configs import AudioConfig as JaxAudioConfig
from vcagan.configs import DataConfig as JaxDataConfig
from vcagan.data.grid import GridDataset as JaxGridDataset
from vcagan.data.lrs import LRSDataset as JaxLRSDataset
from vcagan.data.lrs import SyntheticLRSSource as JaxSyntheticLRS
from vcagan.data.synthetic import SyntheticLipSpeech as JaxSynthetic
from vcagan_torch.configs import AudioConfig, DataConfig, grid_config
from vcagan_torch.data.grid import GridDataset
from vcagan_torch.data.lrs import LRSDataset, SyntheticLRSSource
from vcagan_torch.data.prefetch import ParallelEpoch, ProcessEpoch
from vcagan_torch.data.synthetic import SyntheticLipSpeech
from vcagan_torch.data.transforms import augment_draws
from vcagan_torch.parallel import (
    DataLayout, draw_rows, initialize_distributed, local_batch_slice, make_layout)
from vcagan_torch.parallel import mesh, multihost

BATCH, WORLD = 4, 2
CLIPS = 10  # two full global batches and a tail of 2
LRS_LENGTHS = [50, 90, 30, 35, 82, 41, 44, 39]  # tests/test_multihost_feed.py:103
DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
            "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")


@pytest.fixture
def three_ranks(monkeypatch):
    """``torch.distributed`` and ``jax`` as rank ``r`` of 3 would see them."""
    rank = {"r": 0}
    for dist in (multihost.dist, mesh.dist):
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda group=None: 3)
        monkeypatch.setattr(dist, "get_rank", lambda group=None: rank["r"])
    monkeypatch.setattr(jax_multihost.jax, "process_count", lambda: 3)
    monkeypatch.setattr(jax_multihost.jax, "process_index", lambda: rank["r"])
    return rank


def test_local_batch_slice_is_the_jax_package_s(three_ranks):
    for r in range(3):
        three_ranks["r"] = r
        got = local_batch_slice(12)
        assert got == jax_multihost.local_batch_slice(12) == slice(4 * r, 4 * r + 4)
        assert DataLayout(3, r, torch.device("cpu")).batch_slice(12) == got
    with pytest.raises(ValueError) as want:
        jax_multihost.local_batch_slice(10)
    with pytest.raises(ValueError) as e:
        local_batch_slice(10)
    assert str(e.value) == str(want.value) == "global batch 10 not divisible by 3 processes"
    with pytest.raises(ValueError, match="not divisible by 3 processes"):
        DataLayout(3, 0, torch.device("cpu")).batch_slice(10)


def test_make_layout_refuses_a_world_that_does_not_divide_the_batch(three_ranks):
    three_ranks["r"] = 2
    layout = make_layout(batch_size=12, device="cpu")
    assert (layout.world, layout.rank, layout.device.type) == (3, 2, "cpu")
    with pytest.raises(ValueError, match=r"batch_size 88 .* world size 3; .* gcd = 1"):
        make_layout(batch_size=88, device="cpu")


def test_single_process_layout_and_refusals(monkeypatch):
    for name in DIST_ENV:
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed(backend="gloo") is False
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29999")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert initialize_distributed(backend="gloo") is False  # one process: nothing to join
    assert not torch.distributed.is_initialized()
    layout = make_layout(batch_size=7, device="cpu")
    assert (layout.world, layout.rank, layout.group) == (1, 0, None)
    assert layout.batch_slice(7) == slice(0, 7)
    # ported since: the model axis; one process cannot hold a model group of 2
    # (make_mesh: "1 devices not divisible by model_parallel=2")
    with pytest.raises(ValueError, match="^1 processes not divisible by model_parallel=2$"):
        make_layout(model_parallel=2, device="cpu")
    assert grid_config(**{"mesh.model_parallel": 2}).mesh.model_parallel == 2
    assert grid_config().mesh.model_parallel == 1


def jax_data(data):
    return JaxDataConfig(**{f: getattr(data, f) for f in data.__dataclass_fields__})


def assert_same_batch(got, want):
    assert set(got) == set(want)
    for k in got:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), k


def concat(parts):
    """Rank batches -> one batch (``n_valid`` summed)."""
    return {k: (np.int32(sum(int(p[k]) for p in parts)) if k == "n_valid"
                else np.concatenate([p[k] for p in parts])) for k in parts[0]}


@pytest.mark.parametrize("mode", ["train", "val"])
def test_grid_slices_concatenate_to_the_unsliced_epoch(mode):
    data = DataConfig(window_size=20)
    kw = dict(shuffle=True, drop_last=mode == "train")

    def dataset(seed=3):
        return GridDataset(SyntheticLipSpeech(num_clips=CLIPS, video_frames=30), AudioConfig(),
                           data, mode, seed)

    whole = list(dataset().epoch(BATCH, **kw))
    ranks = [list(dataset().epoch(BATCH, process_slice=slice(2 * r, 2 * r + 2), **kw))
             for r in range(WORLD)]
    assert len(whole) == (2 if mode == "train" else 3)
    for i, batch in enumerate(whole):
        assert_same_batch(concat([ranks[r][i] for r in range(WORLD)]), batch)
    if mode == "val":  # the tail: 2 real clips, both in rank 0's slice
        assert [int(ranks[r][-1]["n_valid"]) for r in range(WORLD)] == [2, 0]
    for r in range(WORLD):
        ref = JaxGridDataset(JaxSynthetic(num_clips=CLIPS, video_frames=30), JaxAudioConfig(),
                             jax_data(data), mode, 3)
        for got, want in zip(ranks[r], ref.epoch(BATCH, process_slice=slice(2 * r, 2 * r + 2),
                                                  **kw)):
            assert_same_batch(got, want)


def test_lrs_eval_bucket_is_the_global_batch_s():
    data = DataConfig(dataset="LRS2", window_size=50, max_v_timesteps=160)
    audio = AudioConfig(f_max=7600.0)
    kw = dict(shuffle=False, drop_last=False)

    def dataset():
        return LRSDataset(SyntheticLRSSource(lengths=LRS_LENGTHS), audio, data, "val", 5)

    whole = list(dataset().epoch(BATCH, **kw))
    ranks = [list(dataset().epoch(BATCH, process_slice=slice(2 * r, 2 * r + 2), **kw))
             for r in range(WORLD)]
    buckets = [b["video_raw"].shape[1] for b in whole]
    assert buckets == [120, 120]  # the global longest clips: 90 and 82 frames
    for i, batch in enumerate(whole):
        # rank 1's own clips (30, 35 and 41, 44, 39) would fit the 40 / 80 buckets
        assert [ranks[r][i]["video_raw"].shape[1] for r in range(WORLD)] == [buckets[i]] * 2
        assert_same_batch(concat([ranks[r][i] for r in range(WORLD)]), batch)
    ref = JaxLRSDataset(JaxSyntheticLRS(lengths=LRS_LENGTHS), JaxAudioConfig(f_max=7600.0),
                        jax_data(data), "val", 5)
    for got, want in zip(ranks[1], ref.epoch(BATCH, process_slice=slice(2, 4), **kw)):
        assert_same_batch(got, want)


@pytest.mark.parametrize("producer", [ParallelEpoch, ProcessEpoch])
def test_producers_pass_the_slice_through(producer):
    def dataset():
        return GridDataset(SyntheticLipSpeech(num_clips=6, video_frames=24), AudioConfig(),
                           DataConfig(window_size=20), "train", 1)

    sl = slice(2, 4)
    want = list(dataset().epoch(BATCH, process_slice=sl))
    got = list(producer(dataset(), BATCH, process_slice=sl))
    assert len(got) == len(want) == 1
    assert_same_batch(got[0], want[0])


def test_draw_rows_makes_the_global_batch_s_draws():
    def noise(n, gen):
        return torch.randn((n, 3, 5), generator=gen)

    whole_gen = torch.Generator().manual_seed(7)
    whole = noise(6, whole_gen), augment_draws(6, whole_gen, "cpu")
    parts = []
    for r in range(3):
        gen = torch.Generator().manual_seed(7)
        with DataLayout(3, r, torch.device("cpu")).active():
            parts.append((draw_rows(lambda n: noise(n, gen), 2), augment_draws(2, gen, "cpu")))
        assert torch.equal(gen.get_state(), whole_gen.get_state())
    assert torch.equal(torch.cat([p[0] for p in parts]), whole[0])
    for i, field in enumerate(whole[1]):
        assert torch.equal(torch.cat([p[1][i] for p in parts]), field)
    gen = torch.Generator().manual_seed(7)
    with DataLayout(1, 0, torch.device("cpu")).active():
        assert torch.equal(draw_rows(lambda n: noise(n, gen), 6), whole[0])
    assert mesh.active_layout() is None
