"""The GRID data feed of the PyTorch port against the JAX package's.

- Raw batches: the port's ``GridDataset`` over its copy of the synthetic
  source equals the JAX package's byte for byte, in train mode (window
  draws) and in val mode (``drop_last=False``, ``n_valid``), for two seeds.
  Without the corpus, ``make_grid_dataset`` warns, naming the root, and
  gives the synthetic clips.
- The host-side resize weights, luma and resize; the clip transform
  (``prepare_clips`` against the JAX package's vmapped ``prepare_clip``,
  with the JAX package's own flip and erase draws replayed from its keys);
  the whole input pipeline's ``Batch`` on the same raw batch.
- ``ParallelEpoch`` yields the dataset's own batches, as tensors.

Tolerances: the resize weights within 1e-6 of ``jax.image.resize`` of the
identity (the same fp32 arithmetic, rounded in other places); the host
luma identical, the host resize up to rounding ties (below); normalised video within 2e-5 (pixels / 255 through two
fp32 resize products and (x - 0.4136) / 0.17, values up to 3.5); the
spectrogram rtol 1e-5 and atol 1e-4 (fp32 FFTs, magnitudes up to a few
hundred); the normalised mel atol 1e-4 (its log of the mel energies,
scaled by 2 / 11.5); lengths exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcagan.configs import AudioConfig as JaxAudioConfig
from vcagan.configs import DataConfig as JaxDataConfig
from vcagan.data import transforms as jax_transforms
from vcagan.data.device_pipeline import make_device_pipeline as jax_make_device_pipeline
from vcagan.data.grid import GridDataset as JaxGridDataset
from vcagan.data.synthetic import SyntheticLipSpeech as JaxSynthetic
from vcagan_torch.configs import AudioConfig, DataConfig
from vcagan_torch.data import transforms
from vcagan_torch.data.device_pipeline import make_device_pipeline
from vcagan_torch.data.grid import GridDataset, make_grid_dataset
from vcagan_torch.data.prefetch import ParallelEpoch
from vcagan_torch.data.synthetic import SyntheticLipSpeech

CLIPS, BATCH = 6, 4
VIDEO_TOL = dict(atol=2e-5, rtol=0)
SPEC_TOL = dict(atol=1e-4, rtol=1e-5)
MEL_TOL = dict(atol=1e-4, rtol=0)
KEYS = ("video_raw", "aud_cond", "wav", "vid_len", "mel_len", "n_valid")


def raw_epochs(mode, seed, data=None):
    """Both packages' batches of one epoch over their own synthetic sources."""
    data = data or DataConfig()
    jdata = JaxDataConfig(**{f: getattr(data, f) for f in data.__dataclass_fields__})
    port = GridDataset(SyntheticLipSpeech(num_clips=CLIPS), AudioConfig(), data, mode, seed)
    ref = JaxGridDataset(JaxSynthetic(num_clips=CLIPS), JaxAudioConfig(), jdata, mode, seed)
    kw = dict(shuffle=True, drop_last=mode == "train")
    return list(port.epoch(BATCH, **kw)), list(ref.epoch(BATCH, **kw))


@pytest.mark.parametrize("mode", ["train", "val"])
def test_missing_corpus_falls_back_to_synthetic_clips_with_a_warning(tmp_path, mode):
    data = DataConfig(data_root=str(tmp_path / "no_corpus"), synthetic_clips=CLIPS)
    with pytest.warns(UserWarning, match=f"not found under {tmp_path / 'no_corpus'}"):
        ds = make_grid_dataset(data, AudioConfig(), mode)
    assert isinstance(ds.source, SyntheticLipSpeech) and len(ds) == CLIPS


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("mode", ["train", "val"])
def test_raw_batches_are_byte_identical(mode, seed):
    got, want = raw_epochs(mode, seed)
    assert len(got) == len(want) == (1 if mode == "train" else 2)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == sorted(KEYS)
        for k in KEYS:
            a, b = np.asarray(g[k]), np.asarray(w[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k
    if mode == "val":  # the tail batch wraps around and says how many are real
        assert [int(b["n_valid"]) for b in got] == [BATCH, CLIPS - BATCH]
        assert got[0]["video_raw"].shape[1] == DataConfig().max_v_timesteps
    else:
        assert got[0]["video_raw"].shape[1:] == (DataConfig().window_size, 136, 136, 1)


@pytest.mark.parametrize("in_size,out_size", [(136, 112), (112, 112), (136, 32)])
def test_resize_weights_match_jax_image_resize(in_size, out_size):
    want = np.asarray(jax.image.resize(jnp.eye(in_size, dtype=jnp.float32),
                                       (out_size, in_size), method="bilinear"))
    got = transforms._resize_weights(in_size, out_size)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_host_luma_is_identical_and_resize_differs_only_at_rounding_ties():
    """``host_luma_u8`` is numpy on both sides: identical.  ``host_resize_u8``
    rounds two products with the resize weights to uint8; the JAX package
    takes its weights from XLA's fused evaluation of ``jax.image.resize``,
    whose rounding no single-rounding numpy evaluation reproduces (JAX's
    own eager ``compute_weight_mat`` differs from its jitted one in 115 of
    the 15232 weights at 136 -> 112).  The weights lie within 1e-6 (above),
    so the uint8 results may differ by one only where the JAX package's
    float value lies within 1e-3 of a rounding tie."""
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (3, 136, 136, 3), dtype=np.uint8)
    luma = transforms.host_luma_u8(rgb)
    np.testing.assert_array_equal(luma, jax_transforms.host_luma_u8(rgb))
    for video in (luma, rgb):
        got = transforms.host_resize_u8(video, 112)
        want = jax_transforms.host_resize_u8(video, 112)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert got.shape == video.shape[:1] + (112, 112, video.shape[-1])
        wh = jax_transforms._resize_weights(136, 112)
        exact = np.einsum("oh,thwc->towc", wh, video.astype(np.float32))
        exact = np.einsum("pw,towc->topc", wh, exact)
        off = got != want
        assert (np.abs(got.astype(int) - want.astype(int))[off] == 1).all()
        assert (np.abs(exact[off] - np.floor(exact[off]) - 0.5) < 1e-3).all()
        assert off.mean() < 1e-3


def jax_draws(key, b):
    """The flip bits and erase corners that the JAX pipeline draws from
    ``key`` (``vcagan/data/device_pipeline.py:47``, ``transforms.py:116-128``)."""
    flips, xs, ys = [], [], []
    for k in jax.random.split(key, b):
        k_flip, k_erase = jax.random.split(k)
        kx, ky = jax.random.split(k_erase)
        flips.append(bool(jax.random.bernoulli(k_flip, 0.5)))
        xs.append(int(jax.random.randint(kx, (), -10, 67)))
        ys.append(int(jax.random.randint(ky, (), -10, 67)))
    return transforms.AugmentDraws(torch.tensor(flips), torch.tensor(xs), torch.tensor(ys))


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("crop", [False, True])
def test_prepare_clips_matches_the_jax_transform(augment, crop):
    rng = np.random.default_rng(1)
    # raw RGB frames that the transform crops, or host-cut grey 136^2 boxes
    shape = (4, 3, 256, 256, 3) if crop else (4, 3, 136, 136, 1)
    frames = rng.integers(0, 256, shape, dtype=np.uint8)
    key = jax.random.PRNGKey(7)
    box = transforms.GRID_CROP if crop else None
    want = jax.vmap(lambda fr, k: jax_transforms.prepare_clip(fr, k, crop_box=box,
                                                              augment=augment))(
        jnp.asarray(frames), jax.random.split(key, 4))
    draws = jax_draws(key, 4) if augment else None
    got = transforms.prepare_clips(torch.from_numpy(frames), draws, crop_box=box)
    assert got.shape == want.shape == (4, 3, 112, 112, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VIDEO_TOL)
    if augment:  # both flips and an erased patch occur
        assert 0 < int(draws.flip.sum()) < 4
        assert (got.numpy() == 0).any()


def test_augment_draws_range_and_generator():
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a, b = transforms.augment_draws(500, gen(), "cpu"), transforms.augment_draws(500, gen(), "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a.flip.dtype == torch.bool and 150 < int(a.flip.sum()) < 350
    for corner in (a.x0, a.y0):
        assert int(corner.min()) == -10 and int(corner.max()) == 66


@pytest.mark.parametrize("augment", [False, True])
def test_device_pipeline_matches_the_jax_pipeline(augment):
    raw = raw_epochs("train", 0)[0][0]
    key = jax.random.PRNGKey(11)
    want = jax_make_device_pipeline(JaxAudioConfig(), JaxDataConfig(), augment=augment)(
        {k: jnp.asarray(v) for k, v in raw.items()}, key)
    process = make_device_pipeline(AudioConfig(), DataConfig(), augment=augment, device="cpu")
    got = process(raw, draws=jax_draws(key, BATCH) if augment else None)
    assert got.video.shape == (BATCH, 40, 112, 112, 1)
    assert got.mel.shape == (BATCH, 80, 160) and got.spec.shape == (BATCH, 321, 160)
    np.testing.assert_allclose(got.video.numpy(), np.asarray(want.video), **VIDEO_TOL)
    np.testing.assert_allclose(got.spec.numpy(), np.asarray(want.spec), **SPEC_TOL)
    np.testing.assert_allclose(got.mel.numpy(), np.asarray(want.mel), **MEL_TOL)
    for k in ("vid_len", "mel_len"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))


def test_device_pipeline_zeroes_frames_past_mel_len():
    raw = dict(raw_epochs("train", 0)[0][0])
    raw["mel_len"] = np.asarray([160, 100, 7, 0], np.int32)
    got = make_device_pipeline(augment=False, device="cpu")(raw)
    for i, n in enumerate(raw["mel_len"]):
        assert (got.mel[i, :, n:] == 0).all() and (got.spec[i, :, n:] == 0).all()
        assert (got.mel[i, :, :n] != 0).any() or n == 0


def test_parallel_epoch_yields_the_datasets_batches():
    def dataset():
        return GridDataset(SyntheticLipSpeech(num_clips=CLIPS), mode="val", seed=5)

    want = list(dataset().epoch(2, shuffle=True))
    feed = ParallelEpoch(dataset(), 2, depth=2, device="cpu")
    got = list(feed)
    assert len(got) == len(want) == 3 and len(feed.collate_s) == 3
    for g, w in zip(got, want):
        for k in KEYS:
            if k == "n_valid":
                assert int(g[k]) == int(w[k])
            else:
                assert torch.is_tensor(g[k]) and np.array_equal(g[k].numpy(), w[k]), k
    # an abandoned epoch stops its producer
    it = iter(ParallelEpoch(dataset(), 2, depth=1))
    next(it)
    it.close()
