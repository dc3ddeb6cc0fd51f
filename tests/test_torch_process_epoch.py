"""The collate worker process (``ProcessEpoch``) of the PyTorch port.

Port of ``vcagan/data/prefetch.py:126-304``: the epoch runs in a forked
worker that hands each batch over in shared memory.  On the CPU, small
synthetic GRID and LRS sources (the clips rendered once, in this process,
before the worker forks):
- its batches equal the thread producer's (``ParallelEpoch``) byte for
  byte over two epochs, as numpy arrays and as tensors on a device, so the
  dataset's rng follows the worker's from epoch to epoch;
- the JAX package's ``ProcessEpoch`` repeats its first epoch's shuffle and
  windows in the second (the parent's rng never advances): the difference
  the port does not copy;
- the worker's collate runs no torch operation (it is forked from a process
  with a CUDA context on the card);
- an error in the worker reaches the consumer; an abandoned epoch leaves no
  shared-memory block behind;
- ``Trainer.fit`` with ``data.collate_process`` equals the train step
  called on the thread producer's batches, bit for bit, for two steps.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

sys.path.insert(0, os.path.dirname(__file__))

from _torch_threads import _one_thread  # noqa: E402, F401  (autouse)
from test_torch_loop import assert_same_state, small_trainer  # noqa: E402
from vcagan.configs import AudioConfig as JaxAudioConfig  # noqa: E402
from vcagan.configs import DataConfig as JaxDataConfig  # noqa: E402
from vcagan.data.grid import GridDataset as JaxGridDataset  # noqa: E402
from vcagan.data.prefetch import ProcessEpoch as JaxProcessEpoch  # noqa: E402
from vcagan.data.synthetic import SyntheticLipSpeech as JaxSynthetic  # noqa: E402
from vcagan_torch.configs import AudioConfig, DataConfig, lrs_config  # noqa: E402
from vcagan_torch.data.grid import GridDataset  # noqa: E402
from vcagan_torch.data.lrs import LRSDataset, SyntheticLRSSource  # noqa: E402
from vcagan_torch.data.prefetch import ParallelEpoch, ProcessEpoch  # noqa: E402
from vcagan_torch.data.synthetic import SyntheticLipSpeech  # noqa: E402

B = 2
GRID_DATA = dict(window_size=20, max_v_timesteps=30)


@pytest.fixture(scope="module")
def sources():
    """A GRID and an LRS synthetic source, every clip rendered here, so that
    each worker inherits them."""
    grid = SyntheticLipSpeech(num_clips=6, video_frames=30)
    lrs = SyntheticLRSSource(lengths=[24, 30, 36, 42, 48, 54])
    for source in (grid, lrs):
        for i in range(len(source)):
            source.clip(i)
    return {"GRID": grid, "LRS": lrs}


def make_dataset(sources, kind, seed=3, workers=2):
    if kind == "GRID":
        return GridDataset(sources["GRID"], AudioConfig(), DataConfig(**GRID_DATA), "train",
                           seed, workers)
    cfg = lrs_config("LRS2", **{"data.window_size": 20})
    return LRSDataset(sources["LRS"], cfg.audio, cfg.data, "train", seed, workers)


def epochs(feed, n=2):
    return [[{k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in raw.items()}
             for raw in feed] for _ in range(n)]


def assert_same_batches(got, want):
    assert len(got) == len(want)
    for epoch_got, epoch_want in zip(got, want):
        assert len(epoch_got) == len(epoch_want) > 0
        for g, w in zip(epoch_got, epoch_want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
                assert g[k].tobytes() == w[k].tobytes(), k


def shm_names():
    try:
        return set(os.listdir("/dev/shm"))
    except FileNotFoundError:  # pragma: no cover
        return set()


@pytest.mark.parametrize("kind", ["GRID", "LRS"])
@pytest.mark.parametrize("device", [None, "cpu"])
def test_batches_equal_the_thread_producer_epoch_for_epoch(sources, kind, device):
    before = shm_names()
    want = epochs(ParallelEpoch(make_dataset(sources, kind), B, device=device))
    feed = ProcessEpoch(make_dataset(sources, kind), B, device=device)
    got = epochs(feed)
    assert_same_batches(got, want)
    # the second epoch draws afresh: another shuffle than the first
    assert not all(a["wav"].tobytes() == b["wav"].tobytes() for a, b in zip(*got))
    assert len(feed.collate_s) == sum(len(e) for e in got) and min(feed.collate_s) > 0
    assert shm_names() <= before, "shared-memory blocks leaked"


def test_the_jax_process_epoch_repeats_its_first_epoch():
    """The JAX package's worker advances its own copy of the dataset's rng;
    the parent's never moves, so its second epoch repeats the first one's
    shuffle and windows, where the dataset's own epochs differ."""
    def dataset():
        return JaxGridDataset(JaxSynthetic(num_clips=4, video_frames=30), JaxAudioConfig(),
                              JaxDataConfig(**GRID_DATA), "train", 3)

    feed = JaxProcessEpoch(dataset(), B, to_device=False)
    first, second = list(feed), list(feed)
    assert len(first) == len(second) == 2
    for a, b in zip(first, second):
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    inline = dataset()
    one, two = list(inline.epoch(B)), list(inline.epoch(B))
    assert not all(np.array_equal(a["wav"], b["wav"]) for a, b in zip(one, two))
    for a, b in zip(first, one):
        np.testing.assert_array_equal(np.asarray(a["wav"]), b["wav"])


class _Recorder(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["GRID", "LRS"])
def test_the_collate_runs_no_torch_operation(sources, kind):
    """What the worker runs, here in this process: no torch function."""
    dataset = make_dataset(sources, kind, workers=0)
    with _Recorder() as rec:
        batches = list(dataset.epoch(B))
    assert len(batches) == 3 and rec.calls == []


class _Boom:
    """A dataset whose epoch fails after its first batch."""

    def __init__(self, dataset):
        self.inner = dataset
        self.rng = dataset.rng

    def epoch(self, batch_size):
        it = self.inner.epoch(batch_size)
        yield next(it)
        raise ValueError("boom in the worker")


def test_a_worker_error_reaches_the_consumer(sources):
    before = shm_names()
    feed = ProcessEpoch(_Boom(make_dataset(sources, "GRID")), B)
    got = []
    with pytest.raises(RuntimeError, match="boom in the worker"):
        for raw in feed:
            got.append(raw)
    assert len(got) == 1
    assert shm_names() <= before, "shared-memory blocks leaked"


def test_an_abandoned_epoch_leaves_no_shared_memory(sources):
    before = shm_names()
    it = iter(ProcessEpoch(make_dataset(sources, "LRS"), B, depth=2))
    next(it)
    time.sleep(0.5)  # let the worker publish the batches it runs ahead
    it.close()  # what a break or garbage collection does
    deadline = time.time() + 5.0
    while shm_names() - before and time.time() < deadline:
        time.sleep(0.05)
    assert shm_names() <= before, "shared-memory blocks leaked"


def test_fit_with_the_collate_process_equals_the_step_on_the_thread_batches(tmp_path):
    fitted = small_trainer(tmp_path, "fit", **{"data.collate_process": True})
    assert fitted.fit(epochs=1, max_steps=2) == 2
    assert len(fitted.queue_wait_s) == 2 and len(fitted.collate_s) >= 2
    direct = small_trainer(tmp_path, "direct")
    for raw in ParallelEpoch(direct.train_ds, 2, device="cpu"):
        batch = direct.process_train(raw, direct.generator)
        direct.state, _ = direct.train_step(direct.state, batch, direct.generator)
    assert_same_state(fitted, direct)
